"""Encoder self-attention and its Toeplitz relative-position bias: the CUDA
kernels (`csrc/toeplitz.cu`, `csrc/attention.cu`) and their plain versions.

Counterpart of the forward half of the JAX package's
`ops/attention_pallas.py`. Each wrapper launches its kernel on CUDA tensors
and takes the plain version only for CPU tensors.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


# ------------------------------------------------------------ Toeplitz bias
def toeplitz_expand(diag: torch.Tensor, Tq: int, Tk: int,
                    T: int | None = None) -> torch.Tensor:
    """Expand relative-position diagonals (N, 2T-1) into (N, Tq, Tk) with
    block[n, i, j] = diag[n, (T-1) + j - i]. Indices outside the diagonals
    take the edge values (the pad band of a padded block)."""
    N, two_t1 = diag.shape
    T = (two_t1 + 1) // 2 if T is None else T
    i = torch.arange(Tq, device=diag.device)[:, None]
    j = torch.arange(Tk, device=diag.device)[None, :]
    idx = torch.clamp((T - 1) + j - i, 0, two_t1 - 1)
    return diag[:, idx]


def toeplitz_dense(diag: torch.Tensor, T: int, pad_to: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """(N, 2T-1) float32 diagonals -> (N, pad_to, pad_to) dense bias of
    `dtype` with out[n, i, j] = diag[n, (T-1) + j - i] for i, j < T and edge
    values in the pad band. The Toeplitz kernel on CUDA tensors, the plain
    expansion on CPU tensors."""
    if diag.device.type == "cpu":
        return toeplitz_expand(diag, pad_to, pad_to, T=T).to(dtype)
    from pytorch_end2end_speech_recognition_tpu_torch.ops import _build

    if diag.device.type != "cuda":
        raise ValueError(f"toeplitz_dense: unsupported device {diag.device}")
    N, W = diag.shape
    if W != 2 * T - 1 or pad_to < T or T < 1:
        raise ValueError(f"toeplitz_dense: diag {tuple(diag.shape)} does not "
                         f"match T={T}, pad_to={pad_to}")
    if diag.dtype != torch.float32:
        raise TypeError(f"toeplitz_dense: diag must be float32, got {diag.dtype}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"toeplitz_dense: output dtype {dtype} not supported")
    out = torch.empty((N, pad_to, pad_to), dtype=dtype, device=diag.device)
    if N == 0:
        return out
    diag = diag.contiguous()
    lib = _build.load()
    err = lib.toeplitz_launch(
        diag.data_ptr(), out.data_ptr(), int(dtype == torch.bfloat16), N, T,
        pad_to, torch.cuda.current_stream(diag.device).cuda_stream)
    _build.check(err, "toeplitz_dense")
    toeplitz_dense.launches += 1
    return out


toeplitz_dense.launches = 0


# --------------------------------------------------------------- attention
def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor | None, lens: torch.Tensor,
                    heads: int) -> torch.Tensor:
    """Reference attention (the JAX package's `_attention_xla`): float32
    scores, keys at positions >= lens[b] set to -1e30, softmax, p cast to
    v's dtype, float32 accumulation, output in q's dtype.

    q/k/v: (B, T, H*Dh); bias: (H, P, P) with P >= T, or None."""
    B, T, D = q.shape
    Dh = D // heads
    qh = q.reshape(B, T, heads, Dh).transpose(1, 2).float()
    kh = k.reshape(B, T, heads, Dh).transpose(1, 2).float()
    vh = v.reshape(B, T, heads, Dh).transpose(1, 2)
    s = (qh @ kh.transpose(-1, -2)) / (Dh ** 0.5)            # (B, H, T, T)
    if bias is not None:
        s = s + bias[None, :, :T, :T].float()
    key_ok = torch.arange(T, device=q.device)[None, :] < lens[:, None]
    s = torch.where(key_ok[:, None, None, :], s,
                    torch.full((), NEG_INF, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    den = torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    p = (e / den).to(v.dtype)
    o = p.float() @ vh.float()
    return o.transpose(1, 2).reshape(B, T, D).to(q.dtype)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor | None, lens: torch.Tensor,
                    heads: int) -> torch.Tensor:
    """Length-masked self-attention with an additive per-head bias.

    q/k/v: (B, T, H*Dh) bfloat16 on CUDA (any float dtype on CPU); bias:
    (H, P, P) in q's dtype with P >= T, or None; lens: (B,) integer. Keys at
    positions >= lens[b] are never attended; query rows past lens[b] still
    produce outputs that callers mask. The attention kernel on CUDA tensors,
    `attention_plain` on CPU tensors."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, bias, lens, heads)
    from pytorch_end2end_speech_recognition_tpu_torch.ops import _build

    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    B, T, D = q.shape
    Dh = D // heads
    if D % heads or Dh != 64:
        raise ValueError(f"fused_attention kernel takes head dim 64, that of "
                         f"every attention preset (D={D}, heads={heads})")
    tensors = {"q": q, "k": k, "v": v}
    if bias is not None:
        tensors["bias"] = bias
        if bias.dim() != 3 or bias.shape[0] != heads or bias.shape[1] != \
                bias.shape[2] or bias.shape[1] < T or bias.shape[1] % 8:
            raise ValueError(f"fused_attention: bias {tuple(bias.shape)} is "
                             f"not ({heads}, P, P) with P >= {T} and P a "
                             f"multiple of 8")
    for name, t in tensors.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"fused_attention kernel takes bfloat16; {name} "
                            f"is {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"fused_attention: {name} on {t.device}")
        if name != "bias" and tuple(t.shape) != (B, T, D):
            raise ValueError(f"fused_attention: {name} shape "
                             f"{tuple(t.shape)} != {(B, T, D)}")
    if lens.shape != (B,) or lens.device != q.device:
        raise ValueError(f"fused_attention: lens must be ({B},) on {q.device}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    bias_c = bias.contiguous() if bias is not None else None
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias_c)):
        if t is None:
            continue
        if t.data_ptr() % 16:
            raise ValueError(f"fused_attention: {name} is not 16-byte aligned")
    out = torch.empty_like(q)
    if B == 0 or T == 0:
        return out
    lens32 = lens.to(torch.int32).contiguous()
    lib = _build.load()
    err = lib.attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias_c.data_ptr() if bias_c is not None else None,
        bias_c.shape[1] if bias_c is not None else 0, lens32.data_ptr(),
        out.data_ptr(), B, T, heads, Dh, 1.0 / (Dh ** 0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "fused_attention")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0
