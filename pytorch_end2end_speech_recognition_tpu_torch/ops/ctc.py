"""CTC greedy decode (the port of `ops/ctc.py:ctc_greedy_decode`).

Conventions: blank id 0; outputs right-padded with 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def ctc_greedy_decode(logits: torch.Tensor, logit_lens: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Best-path decode: argmax -> collapse repeats -> drop blanks.

    logits (B, T, V), logit_lens (B,) -> (tokens (B, T) int32 right-padded
    with 0, out_lens (B,) int32). The previous token of frame 0 counts as
    blank; everything stays on the logits' device."""
    B, T, _ = logits.shape
    path = logits.argmax(dim=-1)                                # (B, T)
    t_idx = torch.arange(T, device=logits.device)[None, :]
    valid = t_idx < logit_lens[:, None]
    prev = F.pad(path, (1, 0))[:, :T]
    keep = valid & (path != 0) & ((path != prev) | (t_idx == 0))
    pos = torch.cumsum(keep, dim=1) - 1                         # stable slots
    # dropped frames all write 0 into a spare last column (no host sync)
    out = torch.zeros((B, T + 1), dtype=torch.int32, device=logits.device)
    out.scatter_(1, torch.where(keep, pos, T),
                 torch.where(keep, path, 0).to(torch.int32))
    return out[:, :T], keep.sum(dim=1).to(torch.int32)
