"""CTC loss and greedy decode (the port of the JAX package's `ops/ctc.py`).

`ctc_loss` builds the lattice in torch (`lattice_inputs`: log_softmax, the
gather of the extended labels, the transition flags) and runs the alpha
recursion by `impl`:
- 'torch': `ctc_alpha_plain`, a loop over frames differentiated by autograd
  (the port of `ctc_loss_xla`);
- 'cuda': the lattice kernels with their hand-written backward
  (`ops/ctc_kernel.py`, the port of `ctc_loss_pallas`; on CPU tensors their
  plain versions), on the lattice padded to STATE_ALIGN states.
Both give a row no path can explain (too few frames) loss 1e30 and a zero
gradient, as `ctc_loss_pallas` does. `torch.nn.functional.ctc_loss` is an
oracle in the tests only.

Conventions: blank id 0; `labels` 0-padded with no blanks among the valid
ones; log domain throughout; outputs right-padded with 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pytorch_end2end_speech_recognition_tpu_torch.ops.ctc_kernel import (
    NEG_INF,
    STATE_ALIGN,
    CtcLogLikelihood,
    ctc_alpha_plain,
)
from pytorch_end2end_speech_recognition_tpu_torch.utils.profiling import span


def ctc_lattice(labels: torch.Tensor) -> torch.Tensor:
    """Extended label sequence with interleaved blanks: (B, U) -> (B, 2U+1)."""
    B, U = labels.shape
    ext = torch.zeros((B, 2 * U + 1), dtype=labels.dtype, device=labels.device)
    ext[:, 1::2] = labels
    return ext


def lattice_flags(ext: torch.Tensor, label_lens: torch.Tensor):
    """(can_skip, state_ok), each (B, S) bool: the s-2 -> s transition is
    allowed into odd states whose label differs from the one at s-2; states
    past 2 * label_len are outside the row's lattice."""
    S = ext.shape[1]
    s_idx = torch.arange(S, device=ext.device)[None, :]
    prev2 = ext.gather(1, torch.clamp(s_idx - 2, min=0).expand_as(ext))
    can_skip = (s_idx % 2 == 1) & (s_idx >= 2) & (ext != prev2)
    state_ok = s_idx < 2 * label_lens[:, None] + 1
    return can_skip, state_ok


def lattice_inputs(logits: torch.Tensor, labels: torch.Tensor,
                   label_lens: torch.Tensor, pad_to: int = 1):
    """The recursions' inputs: (lp (B, T, S) float32, the lattice log-probs
    with NEG_INF on states past the labels; can_skip; state_ok), S = 2U+1
    rounded up to a multiple of `pad_to`. The padding is part of the gather
    (no extra pass): padded states are NEG_INF with both flags False, so
    every recursion gives the unpadded states exactly what it gives them
    without it."""
    B, T, _ = logits.shape
    ext = ctc_lattice(labels.long())
    S = ext.shape[1]
    ext = F.pad(ext, (0, -S % pad_to))
    lp = F.log_softmax(logits.float(), dim=-1).gather(
        2, ext[:, None, :].expand(B, T, ext.shape[1]))
    can_skip, state_ok = lattice_flags(ext, label_lens)
    can_skip &= torch.arange(ext.shape[1], device=ext.device)[None, :] < S
    lp = torch.where(state_ok[:, None, :], lp,
                     torch.full((), NEG_INF, device=logits.device))
    return lp, can_skip, state_ok


def ctc_loss(logits: torch.Tensor, logit_lens: torch.Tensor,
             labels: torch.Tensor, label_lens: torch.Tensor,
             impl: str = "torch") -> torch.Tensor:
    """Per-sequence CTC negative log-likelihood: logits (B, T, V), labels
    (B, U) -> (B,) float32, by `impl` ('torch' or 'cuda'). Rows with
    label_len == 0 or logit_len == 0 contribute 0 (pad rows)."""
    if impl not in ("torch", "cuda"):
        raise ValueError(f"unknown ctc impl {impl!r}: use 'torch' or 'cuda'")
    lp, can_skip, state_ok = lattice_inputs(
        logits, labels, label_lens,
        pad_to=STATE_ALIGN if impl == "cuda" else 1)
    last = 2 * label_lens
    if impl == "cuda":
        ll = CtcLogLikelihood.apply(lp, can_skip, state_ok, logit_lens, last)
    else:
        ll = ctc_alpha_plain(lp, can_skip, state_ok, logit_lens, last)[1]
    pad_row = (label_lens == 0) | (logit_lens == 0)
    return torch.where(pad_row, torch.zeros((), device=logits.device), -ll)


def ctc_greedy_decode(logits: torch.Tensor, logit_lens: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Best-path decode: argmax -> collapse repeats -> drop blanks.

    logits (B, T, V), logit_lens (B,) -> (tokens (B, T) int32 right-padded
    with 0, out_lens (B,) int32). The previous token of frame 0 counts as
    blank; everything stays on the logits' device."""
    with span("asr.greedy"):
        B, T, _ = logits.shape
        path = logits.argmax(dim=-1)                            # (B, T)
        t_idx = torch.arange(T, device=logits.device)[None, :]
        valid = t_idx < logit_lens[:, None]
        prev = F.pad(path, (1, 0))[:, :T]
        keep = valid & (path != 0) & ((path != prev) | (t_idx == 0))
        pos = torch.cumsum(keep, dim=1) - 1                     # stable slots
        # dropped frames all write 0 into a spare last column (no host sync)
        out = torch.zeros((B, T + 1), dtype=torch.int32, device=logits.device)
        out.scatter_(1, torch.where(keep, pos, T),
                     torch.where(keep, path, 0).to(torch.int32))
        return out[:, :T], keep.sum(dim=1).to(torch.int32)
