"""The CTC lattice recursions (`csrc/ctc.cu`): the kernels of the JAX
package's `ops/ctc_pallas.py`.

The log_softmax, the lattice gather and the transition flags stay in torch
(`ops/ctc.py`, as they stay in XLA there); the two recursions are kernels.
`ctc_alpha` (forward: alpha and the per-row log-likelihood) and `ctc_beta`
(backward: the beta recursion and the gradient wrt the lattice log-probs)
launch their kernel on CUDA tensors, count the launch, and take the plain
version only for CPU tensors. `CtcLogLikelihood` makes the pair one
differentiable function.

The kernels take the lattice with S a multiple of STATE_ALIGN (one warp
carries a row, each lane an even number of consecutive states).
`ctc_loss(impl='cuda')` builds it so (`lattice_inputs(...,
pad_to=STATE_ALIGN)`); the wrappers pad any other S themselves
(`pad_states`, a copy) and return the caller's S.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30
MAX_STATES = 1024  # 32 lanes of at most 32 states
STATE_ALIGN = 64   # the kernels' S is a multiple of it


def _lse3(a, b, c):
    """log(e^a + e^b + e^c), NEG_INF where all three are (the kernel's)."""
    m = torch.maximum(torch.maximum(a, b), c)
    ms = torch.clamp(m, min=NEG_INF)
    out = ms + torch.log(torch.exp(a - ms) + torch.exp(b - ms)
                         + torch.exp(c - ms))
    return torch.where(m > NEG_INF / 2, out, torch.full_like(out, NEG_INF))


def _shift(x, by: int):
    """x[:, s - by] (by > 0: from lower states) or x[:, s + |by|], NEG_INF
    past the edge."""
    if by > 0:
        return F.pad(x, (by, 0), value=NEG_INF)[:, :x.shape[1]]
    return F.pad(x, (0, -by), value=NEG_INF)[:, -by:]


def ctc_alpha_plain(lp, skip, sok, tlen, last):
    """The forward kernel's recursion in torch. lp (B, T, S) float32 (NEG_INF
    on states past the labels), skip/sok (B, S) bool, tlen/last (B,) ->
    (alpha (B, T, S), ll (B,)). Frames t >= tlen keep the carry (t == 0 is
    always computed); ll is NEG_INF for a row no path can explain."""
    B, T, S = lp.shape
    s_idx = torch.arange(S, device=lp.device)[None, :]
    neg = torch.full((), NEG_INF, device=lp.device)
    alpha = torch.where((s_idx < 2) & sok, lp[:, 0], neg)
    out = [alpha]
    for t in range(1, T):
        diag = _shift(alpha, 1)
        skp = torch.where(skip, _shift(alpha, 2), neg)
        rec = torch.where(sok, _lse3(alpha, diag, skp) + lp[:, t], neg)
        alpha = torch.where((t < tlen)[:, None], rec, alpha)
        out.append(alpha)
    last = last.long()[:, None]
    a1 = torch.where(last < S, alpha.gather(1, torch.clamp(last, max=S - 1)),
                     neg)[:, 0]
    a2 = torch.where((last >= 1) & (last <= S),
                     alpha.gather(1, torch.clamp(last - 1, 0, S - 1)), neg)[:, 0]
    m = torch.maximum(a1, a2)
    ll = torch.where(m > NEG_INF / 2,
                     m + torch.log(torch.exp(a1 - m) + torch.exp(a2 - m)), neg)
    return torch.stack(out, dim=1), ll


def ctc_beta_plain(lp, skip, sok, tlen, last, alpha, ll, g):
    """The backward kernel's recursion in torch: beta from the final states
    at t == tlen-1 backwards, and grad (B, T, S) = g * exp(min(alpha + beta
    - lp - ll, 0)), zero on states past the labels, frames t >= tlen and
    rows with ll <= NEG_INF/2."""
    B, T, S = lp.shape
    s_idx = torch.arange(S, device=lp.device)[None, :]
    neg = torch.full((), NEG_INF, device=lp.device)
    skip_from = F.pad(skip[:, 2:], (0, 2), value=False)
    lastc = last.long()[:, None]
    final = ((s_idx == lastc) | (s_idx == lastc - 1)) & sok
    live = (ll > NEG_INF / 2)[:, None]
    beta = torch.full((B, S), NEG_INF, device=lp.device)
    grads = [None] * T
    for t in reversed(range(T)):
        lpt = lp[:, t]
        diag = _shift(beta, -1)
        skp = torch.where(skip_from, _shift(beta, -2), neg)
        rec = torch.where(sok, _lse3(beta, diag, skp) + lpt, neg)
        beta = torch.where((t == tlen - 1)[:, None],
                           torch.where(final, lpt, neg),
                           torch.where((t < tlen - 1)[:, None], rec, beta))
        gamma = alpha[:, t] + beta - lpt - ll[:, None]
        gr = g[:, None] * torch.exp(torch.clamp(gamma, max=0.0))
        ok = sok & (t < tlen)[:, None] & live
        grads[t] = torch.where(ok, gr, torch.zeros((), device=lp.device))
    return torch.stack(grads, dim=1)


def pad_states(x: torch.Tensor, value) -> torch.Tensor:
    """x (..., S) right-padded with `value` to S a multiple of STATE_ALIGN
    (x itself when it is one)."""
    pad = -x.shape[-1] % STATE_ALIGN
    return F.pad(x, (0, pad), value=value) if pad else x


def _aligned(name, nm, t, to):
    """t, which the kernel reads by bulk copies: it must start on a `to`-byte
    boundary."""
    if t.data_ptr() % to:
        raise ValueError(f"{name}: {nm} must start on a {to}-byte boundary")
    return t


def _kernel_args(name, lp, skip, sok, tlen, last):
    """The kernel's arguments, S padded to STATE_ALIGN: (lp, skip, sok as
    uint8, tlen, last as int32)."""
    if lp.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {lp.device}")
    if lp.dim() != 3 or lp.dtype != torch.float32:
        raise TypeError(f"{name}: lp must be (B, T, S) float32, got "
                        f"{tuple(lp.shape)} {lp.dtype}")
    B, T, S = lp.shape
    if T < 1 or not 1 <= S <= MAX_STATES:
        raise ValueError(f"{name}: T={T} must be >= 1 and S={S} in "
                         f"[1, {MAX_STATES}]")
    for nm, t, shape in (("skip", skip, (B, S)), ("sok", sok, (B, S)),
                         ("tlen", tlen, (B,)), ("last", last, (B,))):
        if tuple(t.shape) != shape or t.device != lp.device:
            raise ValueError(f"{name}: {nm} must be {shape} on {lp.device}")
    # the flags as bytes: a bool tensor is read in place
    return (_aligned(name, "lp", pad_states(lp, NEG_INF).contiguous(), 16),
            *(pad_states(f.to(torch.bool).contiguous().view(torch.uint8), 0)
              for f in (skip, sok)),
            tlen.to(torch.int32).contiguous(),
            last.to(torch.int32).contiguous())


def ctc_alpha(lp, skip, sok, tlen, last):
    """(alpha (B, T, S), ll (B,)) of the lattice: the forward kernel on CUDA
    tensors (S padded to STATE_ALIGN for it where it is not), `ctc_alpha_plain`
    on CPU tensors."""
    if lp.device.type == "cpu":
        return ctc_alpha_plain(lp, skip, sok, tlen, last)
    from pytorch_end2end_speech_recognition_tpu_torch.ops import _build

    S_in = lp.shape[2]
    lp, skip8, sok8, tlen32, last32 = _kernel_args("ctc_alpha", lp, skip, sok,
                                                   tlen, last)
    B, T, S = lp.shape
    alpha = torch.empty_like(lp)
    ll = torch.empty((B,), dtype=torch.float32, device=lp.device)
    if B:
        err = _build.load().ctc_alpha_launch(
            lp.data_ptr(), skip8.data_ptr(), sok8.data_ptr(),
            tlen32.data_ptr(), last32.data_ptr(), alpha.data_ptr(),
            ll.data_ptr(), B, T, S,
            torch.cuda.current_stream(lp.device).cuda_stream)
        _build.check(err, "ctc_alpha")
        ctc_alpha.launches += 1
    return alpha[..., :S_in], ll


ctc_alpha.launches = 0


def ctc_beta(lp, skip, sok, tlen, last, alpha, ll, g):
    """grad (B, T, S) of sum(g * ll) wrt lp: the backward kernel on CUDA
    tensors (S padded to STATE_ALIGN for it where it is not), `ctc_beta_plain`
    on CPU tensors."""
    if lp.device.type == "cpu":
        return ctc_beta_plain(lp, skip, sok, tlen, last, alpha, ll, g)
    from pytorch_end2end_speech_recognition_tpu_torch.ops import _build

    if alpha.shape != lp.shape or ll.shape != lp.shape[:1] \
            or g.shape != lp.shape[:1]:
        raise ValueError("ctc_beta: alpha must match lp, ll and g be (B,)")
    S_in = lp.shape[2]
    lp, skip8, sok8, tlen32, last32 = _kernel_args("ctc_beta", lp, skip, sok,
                                                   tlen, last)
    B, T, S = lp.shape
    alpha = _aligned("ctc_beta", "alpha",
                     pad_states(alpha.float(), NEG_INF).contiguous(), 16)
    ll = ll.float().contiguous()
    g = g.float().contiguous()
    grad = torch.empty_like(lp)
    if B:
        err = _build.load().ctc_beta_launch(
            lp.data_ptr(), skip8.data_ptr(), sok8.data_ptr(),
            tlen32.data_ptr(), last32.data_ptr(), alpha.data_ptr(),
            ll.data_ptr(), g.data_ptr(), grad.data_ptr(), B, T, S,
            torch.cuda.current_stream(lp.device).cuda_stream)
        _build.check(err, "ctc_beta")
        ctc_beta.launches += 1
    return grad[..., :S_in]


ctc_beta.launches = 0


class CtcLogLikelihood(torch.autograd.Function):
    """ll (B,) of the lattice log-probs lp (B, T, S), differentiable in lp."""

    @staticmethod
    def forward(ctx, lp, skip, sok, tlen, last):
        alpha, ll = ctc_alpha(lp, skip, sok, tlen, last)
        ctx.save_for_backward(lp, skip, sok, tlen, last, alpha, ll)
        return ll

    @staticmethod
    def backward(ctx, g):
        lp, skip, sok, tlen, last, alpha, ll = ctx.saved_tensors
        return ctc_beta(lp, skip, sok, tlen, last, alpha, ll, g), \
            None, None, None, None

