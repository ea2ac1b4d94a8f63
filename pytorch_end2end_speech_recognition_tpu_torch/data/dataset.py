"""The host-side batch (the port of the JAX package's `data/dataset.py`
`Batch`). The length-bucketed loader and the tokenizers are not ported yet:
any iterable of `Batch` feeds `Solver.fit`."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Batch:
    """Numpy arrays, ready to be put on the device."""

    audio: np.ndarray        # (B, Ts) float32
    audio_lens: np.ndarray   # (B,) int32 samples; 0 for pad rows
    tokens: np.ndarray       # (B, U) int32, blank(0)-padded
    token_lens: np.ndarray   # (B,) int32
    ids: list[str] = field(default_factory=list)
    texts: list[str] = field(default_factory=list)
