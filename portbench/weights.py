"""The weights of a cell, made from the seed on the device.

One draw of standard normals for every normal leaf together, cut into the
leaves and scaled; zeros and ones for biases and LayerNorm scales. The
names and shapes are the reference's (`reference.model.param_spec`), which
are the program's; both sides are handed this one state dict.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.model import param_spec


def make_weights(cfg: dict, init: dict, seed: int, dev) -> dict:
    spec = param_spec(cfg["model"], init["rel_table_std"])
    sizes = [math.prod(shape) for _, shape, kind, _ in spec if kind == "normal"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=dev)
    out, off = {}, 0
    for name, shape, kind, scale in spec:
        if kind == "normal":
            n = math.prod(shape)
            out[name] = flat[off:off + n].view(shape).mul_(scale)
            off += n
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=dev)
        else:
            out[name] = torch.ones(shape, device=dev)
    return out
