"""Weights from the JAX package's nnx state to this package's state_dict.

The caller flattens the nnx state to dotted path strings and numpy arrays
(e.g. `encoder.blocks.0.ff1.fc1.kernel`); this module never imports JAX.
Names map one to one; only the layouts differ:

- `Linear.kernel` (in, out)            -> `weight` (out, in)
- `Conv.kernel` HWIO (kh, kw, in, out) -> `weight` OIHW
- depthwise `Conv.kernel` (k, 1, D)    -> `weight` (D, 1, k), and the
  speller's location conv (k, 1, F)    -> `weight` (F, 1, k) by the same rule
- `LayerNorm.scale`                    -> `weight`
- `Embed.embedding` (V, D)             -> `weight` (V, D)
- `RelPosBias.table` (L, H, buckets), the LSTM weights `w_ih` (d_in, 4H)
  and `w_hh` (H, 4H) (the port keeps the JAX layout, gate order i, f, g,
  o) and every `bias` keep their layout.
"""

from __future__ import annotations

import numpy as np
import torch


def _convert(name: str, arr: np.ndarray) -> tuple[str, np.ndarray]:
    parent, _, leaf = name.rpartition(".")
    if leaf == "kernel":
        if arr.ndim == 2:
            return f"{parent}.weight", arr.T
        if arr.ndim == 3:
            return f"{parent}.weight", arr.transpose(2, 1, 0)
        if arr.ndim == 4:
            return f"{parent}.weight", arr.transpose(3, 2, 0, 1)
        raise ValueError(f"{name}: unexpected kernel rank {arr.ndim}")
    if leaf in ("scale", "embedding"):
        return f"{parent}.weight", arr
    if leaf in ("bias", "table", "w_ih", "w_hh"):
        return name, arr
    raise ValueError(f"{name}: no mapping for this parameter")


def state_dict_from_jax(flat: dict[str, np.ndarray]
                        ) -> dict[str, torch.Tensor]:
    """Map a flattened nnx state onto `AsrModel`'s parameter names: a
    state_dict of float32 CPU tensors. Load it with
    `model.load_state_dict(sd, strict=False)`: the frontend's buffers are
    computed, not learned."""
    sd = {}
    for name, arr in sorted(flat.items()):
        key, val = _convert(name, np.asarray(arr, np.float32))
        sd[key] = torch.from_numpy(np.ascontiguousarray(val))
    return sd
