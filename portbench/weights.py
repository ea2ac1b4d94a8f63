"""The weights of a cell, made from the seed on the device.

One draw of standard normals for every normal leaf together, cut into the
leaves and scaled; zeros and ones for biases and LayerNorm scales. The
names and shapes are the family reference's (`ref.param_spec`, given the
configuration and its `init`), which are the program's; both sides are
handed this one state dict.
"""

from __future__ import annotations

import math

import torch


def make_weights(ref, cfg: dict, init: dict, seed: int, dev) -> dict:
    """The weights of configuration `cfg` by the reference module `ref`'s
    parameter list, from `seed` on `dev`."""
    spec = ref.param_spec(cfg, init)
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
