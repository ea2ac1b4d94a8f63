"""Context parallelism: self-attention with the time axis split over the
'model' group (the port of the JAX package's `parallel/cp.py`).

Two modes, the same math as the JAX functions:

- `ring_attention`: each rank holds a time slice of the queries and passes
  its key/value slice around the ring (`ring_shift`, the JAX `ppermute`
  i -> i + 1), accumulating the softmax online (a running max and
  denominator rescaled at each step). Any head count.
- `ulysses_attention`: an all-to-all from time slices to head slices
  (`all_to_all`), whole-sequence attention on H/n heads, and the inverse
  exchange back. Heads must divide by the group's size.

`sharded_self_attention` takes inputs replicated over the group (the whole
(B, T, H, D) on each rank, as `MhsaBlock` computes them), gives each rank
its time slice (`split_time`), runs the ring or Ulysses and gathers the
slices back (`gather_time_replicated`); the backwards of those two make
the gradients of replicated inputs whole on every rank, and the
diagonals enter through `copy_to`, so their gradient is summed over the
ranks whose queries used them. A group of None is an axis of size 1: one
ring step, or Ulysses over every head, with no collective. Float32
throughout; the relative bias, given as Toeplitz diagonals, is expanded
only at each block's global (query, key) offsets (`toeplitz_expand`).

The JAX functions rotate the key mask with the keys; here every rank
holds the whole mask (it is made from the lengths) and slices the block it
needs, the same numbers with one message fewer a step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pytorch_end2end_speech_recognition_tpu_torch.ops.attention_kernel import (
    _edge_pad,
    toeplitz_expand,
)
from pytorch_end2end_speech_recognition_tpu_torch.parallel.collectives import (
    all_to_all,
    copy_to,
    gather_time_replicated,
    group_rank,
    ring_shift,
    size,
    split_time,
)

NEG_INF = -1e30
MODES = ("ring", "ulysses")


def _block_attend(q, k, v, mask_kv, bias=None):
    """One (query block, key block) pair: (unnormalized out (B, Tq, H, D),
    running max (B, H, Tq), denominator (B, H, Tq)).

    q: (B, Tq, H, D); k, v: (B, Tk, H, D); mask_kv: (B, Tk) valid keys;
    bias: (1, H, Tq, Tk) or None."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if bias is not None:
        s = s + bias
    keep = mask_kv[:, None, None, :]
    s = torch.where(keep, s, NEG_INF)
    m = s.amax(-1)
    p = torch.where(keep, torch.exp(s - m[..., None]), 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return out, m, p.sum(-1)


def _normalize(out: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    return out / torch.clamp(denom.transpose(1, 2)[..., None], min=1e-30)


def ring_attention(q, k, v, mask, group, bias_diag=None):
    """Ring attention on this rank's time slice: q, k, v (B, T/n, H, D);
    `mask` (B, T) the whole key mask; `bias_diag` (H, 2T-1) or None.
    Returns this rank's (B, T/n, H, D)."""
    n, me = size(group), group_rank(group)
    B, Tl, H, D = q.shape
    out = q.new_zeros(B, Tl, H, D)
    m_run = q.new_full((B, H, Tl), NEG_INF)
    d_run = q.new_zeros(B, H, Tl)
    kv = torch.stack([k, v])  # one message a step for both
    for s in range(n):
        src = (me - s) % n  # the ring moves i -> i + 1: this block's origin
        bias = None
        if bias_diag is not None:
            bias = toeplitz_expand(bias_diag, Tl, Tl, qoff=me * Tl,
                                   koff=src * Tl)[None].float()
        blk_out, blk_m, blk_d = _block_attend(
            q, kv[0], kv[1], mask[:, src * Tl:(src + 1) * Tl], bias)
        m_new = torch.maximum(m_run, blk_m)
        alpha = torch.exp(m_run - m_new)  # rescale the old accumulators
        beta = torch.exp(blk_m - m_new)
        out = (out * alpha.transpose(1, 2)[..., None]
               + blk_out * beta.transpose(1, 2)[..., None])
        d_run = d_run * alpha + blk_d * beta
        m_run = m_new
        if s < n - 1:
            kv = ring_shift(kv, group)
    return _normalize(out, d_run)


def ulysses_attention(q, k, v, mask, group, bias_diag=None):
    """Ulysses attention: q, k, v (B, T/n, H, D) -> (B, T, H/n, D) by one
    all-to-all, attention over the whole sequence on this rank's H/n
    heads (expanding the bias of those heads only), and back. `mask`
    (B, T); `bias_diag` (H, 2T-1) or None."""
    n, me = size(group), group_rank(group)
    if q.shape[2] % n:
        raise ValueError(f"Ulysses needs heads ({q.shape[2]}) divisible by "
                         f"the group's size {n}")
    qh, kh, vh = all_to_all(torch.stack([q, k, v]), group, 3, 2)
    bias = None
    if bias_diag is not None:
        h, T = qh.shape[2], qh.shape[1]
        bias = toeplitz_expand(bias_diag[me * h:(me + 1) * h], T,
                               T)[None].float()
    out, _, d = _block_attend(qh, kh, vh, mask, bias)
    return all_to_all(_normalize(out, d), group, 1, 2)


def sharded_self_attention(group, q, k, v, lens, mode: str = "ring",
                           bias_diag=None):
    """Time-sharded self-attention over `group` (the JAX package's
    `sharded_self_attention` over the 'model' axis).

    q, k, v: (B, T, H, D) float32, alike on every rank; lens (B,);
    bias_diag: (H, 2T-1) float32 Toeplitz diagonals or None. T is padded
    to a multiple of the group's size (the diagonals edge-padded to match;
    pad keys are masked). Returns (B, T, H, D) with pad rows zeroed, alike
    on every rank."""
    if mode not in MODES:
        raise ValueError(f"cp_mode {mode!r}: use one of {MODES}")
    n = size(group)
    T0 = q.shape[1]
    T = -(-T0 // n) * n
    if T != T0:
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, T - T0)) for x in (q, k, v))
        if bias_diag is not None:
            # recentred for the padded length; the edge values meet only
            # masked pad keys and pad query rows
            bias_diag = _edge_pad(bias_diag, T - T0)
    mask = torch.arange(T, device=q.device)[None, :] < lens[:, None]
    if bias_diag is not None:
        bias_diag = copy_to(bias_diag, group)
    attend = ring_attention if mode == "ring" else ulysses_attention
    out = attend(split_time(q, group), split_time(k, group),
                 split_time(v, group), mask, group, bias_diag)
    out = gather_time_replicated(out, group)
    return torch.where(mask[:, :, None, None], out, 0.0)[:, :T0]
