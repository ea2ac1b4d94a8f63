"""Encoder self-attention and its Toeplitz relative-position bias: the CUDA
kernels (`csrc/toeplitz.cu`, `csrc/attention.cu`), their plain versions,
and the `torch.autograd.Function`s that put the backward kernels on the
training path.

Counterpart of `ops/attention_pallas.py` of the JAX package (the whole-row
kernels; the long-T flash kernels are not ported yet). Each kernel wrapper
(`toeplitz_fwd`, `toeplitz_reduce`, `attention_fwd`, `attention_bwd`)
launches its kernel on CUDA tensors, counts the launch, and takes the plain
version only for CPU tensors. `toeplitz_dense` and `fused_attention` are the
differentiable entry points the model calls.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require_cuda(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")


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


def toeplitz_fwd(diag: torch.Tensor, T: int, pad_to: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """(N, 2T-1) float32 diagonals -> (N, pad_to, pad_to) dense bias of
    `dtype` with out[n, i, j] = diag[n, (T-1) + j - i] for i, j < T and edge
    values in the pad band. The Toeplitz kernel on CUDA tensors, the plain
    expansion on CPU tensors. Not differentiable: see `toeplitz_dense`."""
    if diag.device.type == "cpu":
        return toeplitz_expand(diag, pad_to, pad_to, T=T).to(dtype)
    from pytorch_end2end_speech_recognition_tpu_torch.ops import _build

    _require_cuda("toeplitz_fwd", diag)
    N, W = diag.shape
    if W != 2 * T - 1 or pad_to < T or T < 1:
        raise ValueError(f"toeplitz_fwd: diag {tuple(diag.shape)} does not "
                         f"match T={T}, pad_to={pad_to}")
    if diag.dtype != torch.float32:
        raise TypeError(f"toeplitz_fwd: diag must be float32, got {diag.dtype}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"toeplitz_fwd: output dtype {dtype} not supported")
    out = torch.empty((N, pad_to, pad_to), dtype=dtype, device=diag.device)
    if N == 0:
        return out
    diag = diag.contiguous()
    err = _build.load().toeplitz_launch(
        diag.data_ptr(), out.data_ptr(), int(dtype == torch.bfloat16), N, T,
        pad_to, _stream(diag))
    _build.check(err, "toeplitz_fwd")
    toeplitz_fwd.launches += 1
    return out


toeplitz_fwd.launches = 0


def toeplitz_reduce_plain(g: torch.Tensor, T: int) -> torch.Tensor:
    """Per-diagonal sums of the T x T core of g (N, P, P): out (N, 2T-1)
    float32 with out[n, (T-1) + j - i] = sum g[n, i, j]. Rows are reversed
    and right-padded to 2T, so that reading the flattened rows T at a time
    at width 2T-1 shifts row i' right by i' and aligns every diagonal into a
    column."""
    N = g.shape[0]
    x = g[:, :T, :T].float().flip(1)                    # row i' = T-1-i
    flat = F.pad(x, (0, T)).reshape(N, 2 * T * T)
    return flat[:, :T * (2 * T - 1)].reshape(N, T, 2 * T - 1).sum(dim=1)


def toeplitz_reduce(g: torch.Tensor, T: int) -> torch.Tensor:
    """The transpose of the expansion: (N, P, P) cotangent -> (N, 2T-1)
    float32 per-diagonal sums of its T x T core (the pad band, zero on the
    training path, is not read). The reduce kernel on CUDA tensors,
    `toeplitz_reduce_plain` on CPU tensors."""
    if g.device.type == "cpu":
        return toeplitz_reduce_plain(g, T)
    from pytorch_end2end_speech_recognition_tpu_torch.ops import _build

    _require_cuda("toeplitz_reduce", g)
    if g.dim() != 3 or g.shape[1] != g.shape[2] or g.shape[1] < T or T < 1:
        raise ValueError(f"toeplitz_reduce: g {tuple(g.shape)} is not "
                         f"(N, P, P) with P >= T={T}")
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"toeplitz_reduce: g dtype {g.dtype} not supported")
    N, P = g.shape[0], g.shape[1]
    out = torch.zeros((N, 2 * T - 1), dtype=torch.float32, device=g.device)
    if N == 0:
        return out
    g = g.contiguous()
    err = _build.load().toeplitz_reduce_launch(
        g.data_ptr(), out.data_ptr(), int(g.dtype == torch.bfloat16), N, T, P,
        _stream(g))
    _build.check(err, "toeplitz_reduce")
    toeplitz_reduce.launches += 1
    return out


toeplitz_reduce.launches = 0


class _ToeplitzDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, diag, T, pad_to, dtype):
        ctx.T, ctx.diag_dtype = T, diag.dtype
        return toeplitz_fwd(diag, T, pad_to, dtype)

    @staticmethod
    def backward(ctx, g):
        return toeplitz_reduce(g, ctx.T).to(ctx.diag_dtype), None, None, None


def toeplitz_dense(diag: torch.Tensor, T: int, pad_to: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """`toeplitz_fwd` with its gradient: the backward is `toeplitz_reduce`
    (the reduce kernel on CUDA), as the JAX package's custom VJP is."""
    return _ToeplitzDense.apply(diag, T, pad_to, dtype)


# --------------------------------------------------------------- attention
def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, T, H*Dh) -> (B, H, T, Dh)."""
    B, T, D = x.shape
    return x.reshape(B, T, heads, D // heads).transpose(1, 2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, Dh) -> (B, T, H*Dh)."""
    B, H, T, Dh = x.shape
    return x.transpose(1, 2).reshape(B, T, H * Dh)


def _probs(s, bias, lens):
    """Float32 softmax of the scores s (B, H, T, T) + bias over keys < lens
    (the JAX reference's -1e30 mask: a row with lens 0 gets uniform
    weights)."""
    T = s.shape[2]
    if bias is not None:
        s = s + bias[None, :, :T, :T].float()
    key_ok = torch.arange(T, device=s.device)[None, :] < lens[:, None]
    s = torch.where(key_ok[:, None, None, :], s,
                    torch.full((), NEG_INF, device=s.device))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor | None, lens: torch.Tensor,
                    heads: int) -> torch.Tensor:
    """Reference attention (the JAX package's `_attention_xla`): float32
    scores, keys at positions >= lens[b] set to -1e30, softmax, p cast to
    v's dtype, float32 accumulation, output in q's dtype.

    q/k/v: (B, T, H*Dh); bias: (H, P, P) with P >= T, or None."""
    Dh = q.shape[2] // heads
    s = (_heads(q, heads).float() @ _heads(k, heads).float().transpose(-1, -2)
         ) / (Dh ** 0.5)
    p = _probs(s, bias, lens).to(v.dtype)
    o = p.float() @ _heads(v, heads).float()
    return _merge(o).to(q.dtype)


def attention_bwd_plain(q, k, v, bias, lens, g, heads: int):
    """The attention backward in plain torch: the JAX package's `_bwd`
    (`ops/attention_pallas.py:953`) with the TPU kernel's rounding points
    (q * scale, p and ds cast to the inputs' dtype before their products;
    all no-ops in float32). Returns (dq, dk, dv, dbias): dbias has the bias'
    shape (H, P, P) and dtype, its pad band zero; None without a bias."""
    B, T, D = q.shape
    Dh = D // heads
    scale = 1.0 / (Dh ** 0.5)
    dt = q.dtype
    qs = (_heads(q, heads).float() * scale).to(dt).float()
    kh, vh, gh = (_heads(x, heads).float() for x in (k, v, g))
    p = _probs(qs @ kh.transpose(-1, -2), bias, lens)
    dv = p.to(dt).float().transpose(-1, -2) @ gh
    dp = gh @ vh.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dsc = ds.to(dt).float()
    dq = (dsc @ kh) * scale
    dk = dsc.transpose(-1, -2) @ qs
    dbias = None
    if bias is not None:
        P = bias.shape[-1]
        dbias = F.pad(ds.sum(dim=0), (0, P - T, 0, P - T)).to(bias.dtype)
    return _merge(dq).to(dt), _merge(dk).to(dt), _merge(dv).to(dt), dbias


def _kernel_args(name, q, k, v, bias, lens, heads, extra=()):
    """Check what the attention kernels take and return the contiguous
    operands (q, k, v, bias, *extra) and int32 lens."""
    _require_cuda(name, q)
    B, T, D = q.shape
    Dh = D // heads
    if D % heads or Dh != 64:
        raise ValueError(f"{name} kernel takes head dim 64, that of every "
                         f"attention preset (D={D}, heads={heads})")
    if bias is not None and (
            bias.dim() != 3 or bias.shape[0] != heads
            or bias.shape[1] != bias.shape[2] or bias.shape[1] < T
            or bias.shape[1] % 8):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} is not "
                         f"({heads}, P, P) with P >= {T} and P a multiple "
                         "of 8")
    tensors = {"q": q, "k": k, "v": v, "bias": bias}
    tensors.update({f"arg{i}": t for i, t in enumerate(extra)})
    out = []
    for key, t in tensors.items():
        if t is None:
            out.append(None)
            continue
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} kernel takes bfloat16; {key} is {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name}: {key} on {t.device}")
        if key != "bias" and tuple(t.shape) != (B, T, D):
            raise ValueError(f"{name}: {key} shape {tuple(t.shape)} != "
                             f"{(B, T, D)}")
        t = t.contiguous()
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} is not 16-byte aligned")
        out.append(t)
    if lens.shape != (B,) or lens.device != q.device:
        raise ValueError(f"{name}: lens must be ({B},) on {q.device}")
    return out, lens.to(torch.int32).contiguous()


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: torch.Tensor | None, lens: torch.Tensor, heads: int,
                  with_lse: bool = False):
    """The attention kernel: returns (out, lse). lse is the rows' float32
    log2-sum-exp (B, H, T) that the backward kernel needs, when `with_lse`
    (else None); +inf on rows of a batch row with lens 0, whose output the
    kernel leaves 0 (the JAX reference returns the mean of v there). On CPU
    tensors: (`attention_plain`, None)."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, bias, lens, heads), None
    from pytorch_end2end_speech_recognition_tpu_torch.ops import _build

    (q, k, v, bias), lens32 = _kernel_args("attention_fwd", q, k, v, bias,
                                           lens, heads)
    B, T, D = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((B, heads, T), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if B == 0 or T == 0:
        return out, lse
    err = _build.load().attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        bias.shape[1] if bias is not None else 0, lens32.data_ptr(),
        out.data_ptr(), lse.data_ptr() if lse is not None else None,
        B, T, heads, D // heads, 1.0 / ((D // heads) ** 0.5), _stream(q))
    _build.check(err, "attention_fwd")
    attention_fwd.launches += 1
    return out, lse


attention_fwd.launches = 0


def attention_bwd(q, k, v, bias, lens, g, lse, heads: int):
    """The backward kernels (dq with delta and dbias, then dk/dv): returns
    (dq, dk, dv, dbias) as `attention_bwd_plain` does, from the forward's
    `lse`. dbias is summed over the batch in float32 with atomics and cast
    to the bias' dtype. On CPU tensors: `attention_bwd_plain` (lse unused).
    """
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, bias, lens, g, heads)
    from pytorch_end2end_speech_recognition_tpu_torch.ops import _build

    (q, k, v, bias, g), lens32 = _kernel_args("attention_bwd", q, k, v, bias,
                                              lens, heads, extra=(g,))
    B, T, D = q.shape
    if lse is None or lse.shape != (B, heads, T) or lse.dtype != torch.float32:
        raise ValueError(f"attention_bwd: lse must be ({B}, {heads}, {T}) "
                         "float32 from attention_fwd(..., with_lse=True)")
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dbias32 = (torch.zeros(bias.shape, dtype=torch.float32, device=q.device)
               if bias is not None else None)
    delta = torch.empty((B, heads, T), dtype=torch.float32, device=q.device)
    if B and T:
        err = _build.load().attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            bias.shape[1] if bias is not None else 0, lens32.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dbias32.data_ptr() if bias is not None else None,
            B, T, heads, D // heads, 1.0 / ((D // heads) ** 0.5), _stream(q))
        _build.check(err, "attention_bwd")
        attention_bwd.launches += 1
    dbias = dbias32.to(bias.dtype) if bias is not None else None
    return dq, dk, dv, dbias


attention_bwd.launches = 0


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, lens, heads):
        grad = any(ctx.needs_input_grad[:4])
        out, lse = attention_fwd(q, k, v, bias, lens, heads, with_lse=grad)
        if grad:
            ctx.save_for_backward(q, k, v, bias, lens, lse)
            ctx.heads = heads
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, lens, lse = ctx.saved_tensors
        dq, dk, dv, dbias = attention_bwd(q, k, v, bias, lens, g, lse,
                                          ctx.heads)
        return dq, dk, dv, dbias, None, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor | None, lens: torch.Tensor,
                    heads: int) -> torch.Tensor:
    """Length-masked self-attention with an additive per-head bias, with
    its gradient: the forward kernel and the backward kernels on CUDA, the
    plain versions on CPU.

    q/k/v: (B, T, H*Dh) bfloat16 on CUDA (any float dtype on CPU); bias:
    (H, P, P) in q's dtype with P >= T, or None; lens: (B,) integer. Keys at
    positions >= lens[b] are never attended; query rows past lens[b] still
    produce outputs that callers mask."""
    return _FusedAttention.apply(q, k, v, bias, lens, heads)
