"""LSTM primitives (the port of the JAX package's `ops/rnn.py`).

The input projection `x @ W_ih` of all time steps is one large product;
the sequential part carries only the (B, 4H) recurrent product per step.
Variable lengths: outputs past a row's length are zero and the carry
freezes at the last valid step, so the final states are exact; the reverse
direction flips each row's valid prefix. `bilstm_layer(impl='cuda')` takes
the hand-written recurrence kernels of `ops/rnn_kernel.py`, both directions
in one launch.
"""

from __future__ import annotations

import torch


def flip_sequences(x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Reverse each row's valid prefix [0, len); padding stays in place."""
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    idx = lens.long()[:, None] - 1 - t
    idx = torch.where(idx >= 0, idx, t)
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand_as(x)
    return torch.gather(x, 1, idx)


def lstm_cell(gates: torch.Tensor, c: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """LSTM nonlinearity on pre-activations (.., 4H), gate order i, f, g, o,
    with cell state c."""
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def lstm_scan(x, lens, w_ih, w_hh, bias, reverse: bool = False, h0=None,
              c0=None, dtype=torch.float32):
    """One LSTM direction: x (B, T, D), lens (B,), w_ih (D, 4H), w_hh (H,
    4H), bias (4H,) -> (outputs (B, T, H) float32, (h_T, c_T)). Outputs at
    padded steps are zero; (h_T, c_T) are the states at step len-1 of each
    row (the initial state for len == 0). Both products run in `dtype` with
    float32 results, as the reference casts them."""
    B, T, _ = x.shape
    H = w_hh.shape[0]
    if reverse:
        x = flip_sequences(x, lens)
    xg = (x.to(dtype) @ w_ih.to(dtype)).float() + bias
    h = torch.zeros(B, H, device=x.device) if h0 is None else h0
    c = torch.zeros(B, H, device=x.device) if c0 is None else c0
    whh = w_hh.to(dtype)
    ys = []
    for t in range(T):
        h_new, c_new = lstm_cell(xg[:, t] + (h.to(dtype) @ whh).float(), c)
        valid = (t < lens)[:, None]
        ys.append(torch.where(valid, h_new, torch.zeros_like(h_new)))
        h = torch.where(valid, h_new, h)
        c = torch.where(valid, c_new, c)
    ys = torch.stack(ys, dim=1)
    if reverse:
        ys = flip_sequences(ys, lens)
    return ys, (h, c)


def bilstm_layer(x, lens, params_fwd, params_bwd, dtype=torch.float32,
                 impl: str = "torch") -> torch.Tensor:
    """Bidirectional layer: forward and backward outputs concatenated,
    (B, T, 2H). `impl` 'torch' runs `lstm_scan`, 'cuda' the recurrence
    kernels (`ops/rnn_kernel.py`), one launch for both directions."""
    if impl == "cuda":
        from pytorch_end2end_speech_recognition_tpu_torch.ops.rnn_kernel import (  # noqa: E501
            bilstm_kernel,
        )

        yf, yb = bilstm_kernel(x, lens, params_fwd, params_bwd, dtype=dtype)
    elif impl == "torch":
        yf, _ = lstm_scan(x, lens, *params_fwd, reverse=False, dtype=dtype)
        yb, _ = lstm_scan(x, lens, *params_bwd, reverse=True, dtype=dtype)
    else:
        raise ValueError(f"unknown lstm impl {impl!r}")
    return torch.cat([yf, yb], dim=-1)
