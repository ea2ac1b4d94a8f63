"""The CTC prefix scorer of joint CTC/attention beam search
(`csrc/ctc_prefix.cu`).

Counterpart of the `lax.scan` in the JAX package's `decode/beam.py:189-206`
(`ctc_prefix_scores`), which has no `pl.pallas_call`: for every (row b,
hypothesis k, candidate c) chain it runs Watanabe's prefix recursion over
the T' encoder frames,

    phi_t   = r_b[t-1]                         if c == last token
              log_add(r_b[t-1], r_n[t-1])      otherwise
    r_n'[t] = log_add(r_n'[t-1], phi_t) + lp[t, c]
    r_b'[t] = log_add(r_b'[t-1], r_n'[t-1]) + lp[t, blank]
    psi     = log_add over t of (phi_t + lp[t, c])

with r[-1] = (NEG_INF, 0 for the empty prefix else NEG_INF) and
log_add(a, b) = m + log1p(exp(-|a - b|)) for m = max(a, b) > NEG_INF / 2,
else m, as the reference computes it. `lp` has the pad frames made
blank-certain (blank 0, every label NEG_INF). The streaming beam
(`decode/chunk_beam.py`; the JAX package's `decode/chunk_beam.py:277-319`)
runs the same recursion over a sliding window of T' frames, with r[-1] each
hypothesis's carried pre-window column: every function here takes it as the
optional `r_init` (B, K, 2) (r_n, r_b).

In PyTorch the scan would be a Python loop of ~12 launches per frame, so on
the card it is a kernel, in two launches per token step:
- `ctc_prefix_score`: psi (B, K, C) of every candidate; the columns stay in
  registers and are not stored (the reference writes the (B, K, C, T', 2)
  columns of every candidate on every token);
- `ctc_prefix_select`: the new columns (B, K, T', 2) of the K hypotheses
  the beam kept, each recomputed for its (parent, token) pair with the same
  arithmetic (an extension), or its parent's copied (eos or a finished
  hypothesis kept).
Each wrapper launches its kernel on CUDA tensors and counts the launch; on
CPU tensors it takes the plain version, `prefix_recursion_plain`.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30
BLANK_ID = 0


def log_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(a, b)
    return torch.where(m > NEG_INF / 2,
                       m + torch.log1p(torch.exp(-(a - b).abs())), m)


def prefix_recursion_plain(lp, r_prev, cand, last, lengths,
                           want_r: bool = False, r_init=None):
    """The recursion in torch, a loop over frames. lp (B, T, V) float32
    (pad frames blank-certain), r_prev (B, K, T, 2) the prefixes' columns
    (r_n, r_b), cand (B, K, C) candidate ids, last and lengths (B, K) the
    prefixes' last token (<sos> when empty) and length, r_init (B, K, 2) the
    columns before frame 0 (None: from `lengths`) -> (psi (B, K, C), and with
    `want_r` the extended prefixes' columns (B, K, C, T, 2), else None)."""
    B, T, V = lp.shape
    K, C = cand.shape[1], cand.shape[2]
    idx = cand.long().reshape(B, 1, K * C).expand(B, T, K * C)
    lp_c = lp.gather(2, idx).reshape(B, T, K, C)
    lp_blank = lp[:, :, BLANK_ID]
    same = cand.long() == last.long()[..., None]
    neg = torch.full((B, K), NEG_INF, device=lp.device)
    if r_init is None:
        pn, pb = neg, torch.where(lengths == 0, torch.zeros_like(neg), neg)
    else:
        pn, pb = r_init[..., 0], r_init[..., 1]
    prev_n = prev_b = psi = torch.full((B, K, C), NEG_INF, device=lp.device)
    cols = []
    for t in range(T):
        if t > 0:
            pn, pb = r_prev[:, :, t - 1, 0], r_prev[:, :, t - 1, 1]
        phi = torch.where(same, pb[..., None], log_add(pb, pn)[..., None])
        new_n = log_add(prev_n, phi) + lp_c[:, t]
        new_b = log_add(prev_b, prev_n) + lp_blank[:, t, None, None]
        psi = log_add(psi, phi + lp_c[:, t])
        prev_n, prev_b = new_n, new_b
        if want_r:
            cols.append(torch.stack([new_n, new_b], dim=-1))
    return psi, (torch.stack(cols, dim=3) if want_r else None)


def _by_parent(x: torch.Tensor, parent: torch.Tensor) -> torch.Tensor:
    """x (B, K, ...) gathered along K by parent (B, K)."""
    idx = parent.long().reshape(parent.shape + (1,) * (x.dim() - 2))
    return x.gather(1, idx.expand(parent.shape + x.shape[2:]))


def prefix_select_plain(lp, r_state, last, lengths, parent, tok, is_ext,
                        r_init=None):
    """The kept hypotheses' columns (B, K, T, 2): for k with is_ext, the
    recursion for (parent[k]'s prefix, tok[k]), from parent[k]'s r_init
    where given; otherwise parent[k]'s columns."""
    r_par = _by_parent(r_state, parent)
    _, r = prefix_recursion_plain(
        lp, r_par, tok[..., None], _by_parent(last, parent),
        _by_parent(lengths, parent), want_r=True,
        r_init=None if r_init is None else _by_parent(r_init, parent))
    return torch.where(is_ext[..., None, None], r[:, :, 0], r_par)


def _check(name, lp, r_state, last, lengths, chains, r_init):
    if lp.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {lp.device}")
    if lp.dim() != 3 or lp.dtype != torch.float32:
        raise TypeError(f"{name}: lp must be (B, T, V) float32, got "
                        f"{tuple(lp.shape)} {lp.dtype}")
    B, T, _ = lp.shape
    K = last.shape[1] if last.dim() == 2 else -1
    if tuple(r_state.shape) != (B, K, T, 2) or r_state.dtype != torch.float32:
        raise ValueError(f"{name}: r_state must be (B, K, T, 2) float32 with "
                         f"(B, T) = {(B, T)}, got {tuple(r_state.shape)}")
    for nm, t in (("last", last), ("lengths", lengths), *chains):
        if t.shape[:2] != (B, K) or t.device != lp.device:
            raise ValueError(f"{name}: {nm} must lead with (B, K) = {(B, K)} "
                             f"on {lp.device}")
    init_ptr = None
    if r_init is not None:
        if (tuple(r_init.shape) != (B, K, 2) or r_init.dtype != torch.float32
                or r_init.device != lp.device):
            raise ValueError(f"{name}: r_init must be (B, K, 2) float32 on "
                             f"{lp.device}, got {tuple(r_init.shape)}")
        r_init = r_init.contiguous()
        init_ptr = r_init.data_ptr()
    i32 = lambda t: t.to(torch.int32).contiguous()  # noqa: E731
    # r_init is returned so that its contiguous copy outlives the launch
    return (lp.contiguous(), r_state.contiguous(), i32(last), i32(lengths),
            i32, r_init, init_ptr)


def ctc_prefix_score(lp, r_state, last, lengths, cand, r_init=None
                     ) -> torch.Tensor:
    """psi (B, K, C) of each prefix extended by each candidate, from the
    pre-window columns r_init (B, K, 2) where given: the score kernel on
    CUDA tensors, the plain recursion on CPU tensors."""
    if lp.device.type == "cpu":
        return prefix_recursion_plain(lp, r_state, cand, last, lengths,
                                      r_init=r_init)[0]
    from pytorch_end2end_speech_recognition_tpu_torch.ops import _build

    lp, r_state, last32, len32, i32, r_init, init_ptr = _check(
        "ctc_prefix_score", lp, r_state, last, lengths, (("cand", cand),),
        r_init)
    B, T, V = lp.shape
    K, C = cand.shape[1], cand.shape[2]
    if not 1 <= C <= 1024:
        raise ValueError(f"ctc_prefix_score: {C} candidates, at most 1024")
    cand32 = i32(cand)
    psi = torch.empty((B, K, C), dtype=torch.float32, device=lp.device)
    if B * K:
        err = _build.load().ctc_prefix_score_launch(
            lp.data_ptr(), r_state.data_ptr(), last32.data_ptr(),
            len32.data_ptr(), cand32.data_ptr(), init_ptr, psi.data_ptr(), B,
            K, C, T, V, torch.cuda.current_stream(lp.device).cuda_stream)
        _build.check(err, "ctc_prefix_score")
        ctc_prefix_score.launches += 1
    return psi


ctc_prefix_score.launches = 0


def ctc_prefix_select(lp, r_state, last, lengths, parent, tok, is_ext,
                      r_init=None) -> torch.Tensor:
    """The kept hypotheses' columns (B, K, T, 2) (see
    `prefix_select_plain`): the select kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if lp.device.type == "cpu":
        return prefix_select_plain(lp, r_state, last, lengths, parent, tok,
                                   is_ext, r_init=r_init)
    from pytorch_end2end_speech_recognition_tpu_torch.ops import _build

    lp, r_state, last32, len32, i32, r_init, init_ptr = _check(
        "ctc_prefix_select", lp, r_state, last, lengths,
        (("parent", parent), ("tok", tok), ("is_ext", is_ext)), r_init)
    B, T, V = lp.shape
    K = last.shape[1]
    ext8 = is_ext.to(torch.bool).contiguous().view(torch.uint8)
    out = torch.empty_like(r_state)
    if B * K:
        par32, tok32 = i32(parent), i32(tok)
        err = _build.load().ctc_prefix_select_launch(
            lp.data_ptr(), r_state.data_ptr(), last32.data_ptr(),
            len32.data_ptr(), par32.data_ptr(), tok32.data_ptr(),
            ext8.data_ptr(), init_ptr, out.data_ptr(), B, K, T, V,
            torch.cuda.current_stream(lp.device).cuda_stream)
        _build.check(err, "ctc_prefix_select")
        ctc_prefix_select.launches += 1
    return out


ctc_prefix_select.launches = 0
