"""Encoder self-attention and its Toeplitz relative-position bias: the CUDA
kernels (`csrc/toeplitz.cu`, `csrc/attention.cu`), their plain versions,
and the `torch.autograd.Function`s that put the backward kernels on the
training path.

Counterpart of `ops/attention_pallas.py` of the JAX package: the whole-row
path (a dense (H, P, P) bias, T <= 768) and the long-audio flash path (the
bias as float32 diagonals (H, 2T-1), past 768 frames or for wide models).
Each kernel wrapper (`toeplitz_fwd`, `toeplitz_reduce`, `attention_fwd`,
`attention_bwd`, `flash_fwd`, `flash_bwd`) launches its kernel on CUDA
tensors, counts the launch, and takes the plain version only for CPU
tensors. `toeplitz_dense`, `fused_attention` and `flash_attention` are the
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
                    T: int | None = None, qoff: int = 0,
                    koff: int = 0) -> torch.Tensor:
    """Expand relative-position diagonals (N, 2T-1) into (N, Tq, Tk) with
    block[n, i, j] = diag[n, (T-1) + (koff + j) - (qoff + i)]: the block at
    query offset `qoff` and key offset `koff` of the dense bias. Indices
    outside the diagonals take the edge values (the pad band of a padded
    block)."""
    N, two_t1 = diag.shape
    T = (two_t1 + 1) // 2 if T is None else T
    i = torch.arange(Tq, device=diag.device)[:, None] + qoff
    j = torch.arange(Tk, device=diag.device)[None, :] + koff
    idx = torch.clamp((T - 1) + j - i, 0, two_t1 - 1)
    return diag[:, idx]


def toeplitz_fwd(diag: torch.Tensor, T: int, pad_to: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """(N, 2T-1) float32 diagonals -> (N, pad_to, pad_to) dense bias of
    `dtype` with out[n, i, j] = diag[n, (T-1) + j - i] for i, j < T and edge
    values in the pad band. The Toeplitz kernel on CUDA tensors, the plain
    expansion on CPU tensors, as the operator `asr_port::toeplitz_expand`.
    Not differentiable: see `toeplitz_dense`."""
    return toeplitz_op(diag, T, pad_to, dtype)


toeplitz_fwd.launches = 0


@torch.library.custom_op(
    "asr_port::toeplitz_expand", mutates_args=(), device_types="cpu",
    schema="(Tensor diag, int T, int pad_to, ScalarType dtype) -> Tensor")
def toeplitz_op(diag, T, pad_to, dtype):
    """The operator's CPU version: the plain expansion."""
    return toeplitz_expand(diag, pad_to, pad_to, T=T).to(dtype)


@toeplitz_op.register_fake
def _toeplitz_fake(diag, T, pad_to, dtype):
    return diag.new_empty((diag.shape[0], pad_to, pad_to), dtype=dtype)


@toeplitz_op.register_kernel("cuda")
def _toeplitz_cuda(diag, T, pad_to, dtype):
    from pytorch_end2end_speech_recognition_tpu_torch.ops import _build

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
    training path, is not read). The reduce kernel on CUDA tensors (each
    diagonal summed in one fixed order in one launch: the same bits on
    every run), `toeplitz_reduce_plain` on CPU
    tensors."""
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
    out = torch.empty((N, 2 * T - 1), dtype=torch.float32, device=g.device)
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


def _softmax_keys(s, lens):
    """Float32 softmax of the scores s (B, H, Tq, Tk) over keys < lens (the
    JAX reference's -1e30 mask: a row with lens 0 gets uniform weights)."""
    key_ok = torch.arange(s.shape[-1], device=s.device)[None, :] < lens[:, None]
    s = torch.where(key_ok[:, None, None, :], s,
                    torch.full((), NEG_INF, device=s.device))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)


def _probs(s, bias, lens):
    """`_softmax_keys` of the scores s (B, H, T, T) + the bias' core."""
    T = s.shape[2]
    if bias is not None:
        s = s + bias[None, :, :T, :T].float()
    return _softmax_keys(s, lens)


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


def _fwd_launch(launch, name, q, k, v, bias_args, lens32, heads,
                with_lse):
    """Allocate (out, lse) and run a forward launcher (`attention_launch`,
    bias_args (bias, ld); `flash_launch`, bias_args (diag,)) on checked
    operands: returns (out, lse, whether it launched)."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops import _build

    B, T, D = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((B, heads, T), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if B == 0 or T == 0:
        return out, lse, False
    err = getattr(_build.load(), launch)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *bias_args,
        lens32.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        B, T, heads, D // heads, 1.0 / ((D // heads) ** 0.5), _stream(q))
    _build.check(err, name)
    return out, lse, True


TILE = 64  # the backward's query tile
KEY_BLOCK = 128  # the backward main kernel's keys a block
DIAG_COLS = 192  # diagonals a (64-query, 128-key) tile spans (191), + 1


def ddiag_scratch(B: int, T: int, H: int) -> tuple[int, int]:
    """Shape of the flash backward's float32 partial ddiag: a row per main
    kernel tile (batch row b, 128-key block kt, head h, 64-query tile qt),
    row ((b n_kt + kt) H + h) n_qt + qt, whose column c holds the tile's ds
    summed along diagonal j - i = 128 kt - 64 qt + c - 63; the last launch
    adds, per diagonal, the rows of the key blocks that reach lens[b], in a
    fixed order."""
    n_kt, n_qt = -(-T // KEY_BLOCK), -(-T // TILE)
    return (B * n_kt * H * n_qt, DIAG_COLS)


def bwd_work_words(B: int, T: int, H: int) -> int:
    """float32 words of the backward's `work` scratch: each 128-key block's
    dQ partial, a (64, 64) tile per (b, h, key block, query tile), which
    the last launch adds in key-block order (2 B H T^2 bytes)."""
    return B * H * -(-T // KEY_BLOCK) * -(-T // TILE) * TILE * TILE


def _bwd_launch(launch, name, q, k, v, g, bias_args, grad_args, lens32, lse,
                heads):
    """Allocate dq, dk, dv and run a backward launcher
    (`attention_bwd_launch` or `flash_bwd_launch`, bias_args as in
    `_fwd_launch`) on checked operands; grad_args are the bias gradient's
    pointers: (dbias,) or (None,) for `attention_bwd_launch`, (partial
    scratch, ddiag) for `flash_bwd_launch` (`ddiag_scratch`).
    Returns (dq, dk, dv, whether it launched)."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops import _build

    B, T, D = q.shape
    if lse is None or lse.shape != (B, heads, T) or lse.dtype != torch.float32:
        raise ValueError(f"{name}: lse must be ({B}, {heads}, {T}) float32 "
                         "from the forward with with_lse=True")
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if B == 0 or T == 0:
        return dq, dk, dv, False
    delta = torch.empty((B, heads, T), dtype=torch.float32, device=q.device)
    work = torch.empty(bwd_work_words(B, T, heads), dtype=torch.float32,
                       device=q.device)
    err = getattr(_build.load(), launch)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), *bias_args,
        lens32.data_ptr(), lse.data_ptr(), delta.data_ptr(), work.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *grad_args,
        B, T, heads, D // heads, 1.0 / ((D // heads) ** 0.5), _stream(q))
    _build.check(err, name)
    return dq, dk, dv, True


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: torch.Tensor | None, lens: torch.Tensor, heads: int,
                  with_lse: bool = False):
    """The attention kernel: returns (out, lse). lse is the rows' float32
    log2-sum-exp (B, H, T) that the backward kernel needs, when `with_lse`
    (else None); +inf on rows of a batch row with lens 0, whose output the
    kernel leaves 0 (the JAX reference returns the mean of v there). On CPU
    tensors: (`attention_plain`, None). Runs as the operator
    `asr_port::attention_fwd`."""
    out, lse = attention_op(q, k, v, bias, lens, heads, with_lse)
    return out, (lse if with_lse and q.device.type != "cpu" else None)


attention_fwd.launches = 0


def _lse_fake(q, heads, with_lse):
    """The attention operators' lse: (B, H, T) float32 from the kernel with
    `with_lse`, else empty (and always empty from the CPU version)."""
    B, T, _ = q.shape
    shape = (B, heads, T) if with_lse and q.device.type == "cuda" else (0,)
    return q.new_empty(shape, dtype=torch.float32)


@torch.library.custom_op(
    "asr_port::attention_fwd", mutates_args=(), device_types="cpu",
    schema="(Tensor q, Tensor k, Tensor v, Tensor? bias, Tensor lens, "
           "int heads, bool with_lse) -> (Tensor, Tensor)")
def attention_op(q, k, v, bias, lens, heads, with_lse):
    """The operator's CPU version: `attention_plain`, and no lse (an empty
    tensor: the plain backward does not read it)."""
    return (attention_plain(q, k, v, bias, lens, heads),
            q.new_empty(0, dtype=torch.float32))


@attention_op.register_fake
def _attention_fake(q, k, v, bias, lens, heads, with_lse):
    return torch.empty_like(q), _lse_fake(q, heads, with_lse)


@attention_op.register_kernel("cuda")
def _attention_cuda(q, k, v, bias, lens, heads, with_lse):
    (q, k, v, bias), lens32 = _kernel_args("attention_fwd", q, k, v, bias,
                                           lens, heads)
    bias_args = (bias.data_ptr(), bias.shape[1]) if bias is not None else (
        None, 0)
    out, lse, launched = _fwd_launch("attention_launch", "attention_fwd", q,
                                     k, v, bias_args, lens32, heads, with_lse)
    attention_fwd.launches += launched
    return out, lse if lse is not None else q.new_empty(0, dtype=torch.float32)


def attention_bwd(q, k, v, bias, lens, g, lse, heads: int):
    """The backward kernels (the delta pre-pass; dq, dk and dv; then
    dbias): returns (dq, dk, dv, dbias) as `attention_bwd_plain` does, from
    the forward's `lse`. dq is summed over the key blocks in key order,
    dbias over the batch in float32 in batch order and rounded to the bias'
    dtype. On CPU tensors: `attention_bwd_plain` (lse unused)."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, bias, lens, g, heads)
    (q, k, v, bias, g), lens32 = _kernel_args("attention_bwd", q, k, v, bias,
                                              lens, heads, extra=(g,))
    bias_args, grad_args, dbias = (None, 0), (None,), None
    if bias is not None:
        bias_args = (bias.data_ptr(), bias.shape[1])
        dbias = torch.empty_like(bias)
        grad_args = (dbias.data_ptr(),)
    dq, dk, dv, launched = _bwd_launch(
        "attention_bwd_launch", "attention_bwd", q, k, v, g, bias_args,
        grad_args, lens32, lse, heads)
    attention_bwd.launches += launched
    if dbias is not None and not launched:
        dbias.zero_()
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


# --------------------------------------------------------- flash attention
FLASH_BQ = 256  # query rows per chunk of the plain versions (the JAX bq)


def _edge_pad(diag: torch.Tensor, n: int) -> torch.Tensor:
    """(H, W) -> (H, W + 2n): the edge diagonals repeated n times on each
    side (jnp.pad's mode='edge')."""
    W = diag.shape[1]
    idx = torch.clamp(torch.arange(-n, W + n, device=diag.device), 0, W - 1)
    return diag[:, idx]


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    diag: torch.Tensor | None, lens: torch.Tensor, heads: int,
                    bq: int = FLASH_BQ) -> torch.Tensor:
    """Long-audio attention in plain torch: the forward of the JAX package's
    `_attention_xla_chunked` (`ops/attention_pallas.py:739`). It walks query
    chunks of `bq` rows, so memory is (B, H, bq, T), never (B, H, T, T); q
    is zero-padded to a multiple of bq and the diagonals edge-padded to
    match, as there. Scores in float32 plus the float32 bias
    diag[h, (T-1) + j - i], keys >= lens[b] at -1e30, softmax, p cast to
    v's dtype, float32 accumulation, output in q's dtype.

    q/k/v: (B, T, H*Dh); diag: (H, 2T-1) or None; lens: (B,) integer."""
    B, T, D = q.shape
    Dh = D // heads
    Tp = -(-T // bq) * bq
    qp = F.pad(q, (0, 0, 0, Tp - T))
    dpad = _edge_pad(diag.float(), Tp - T) if diag is not None else None
    kh, vh = _heads(k, heads).float(), _heads(v, heads).float()
    out = torch.empty_like(q)
    for i0 in range(0, T, bq):
        s = (_heads(qp[:, i0:i0 + bq], heads).float() @ kh.transpose(-1, -2)
             ) / (Dh ** 0.5)
        if dpad is not None:
            s = s + toeplitz_expand(dpad, bq, T, T=Tp, qoff=i0)[None]
        p = _softmax_keys(s, lens).to(v.dtype)
        out[:, i0:i0 + bq] = _merge(p.float() @ vh)[:, :T - i0].to(q.dtype)
    return out


def flash_bwd_plain(q, k, v, diag, lens, g, heads: int, bq: int = FLASH_BQ):
    """The flash backward in plain torch: `_attention_xla_chunked(..., g=)`
    (`ops/attention_pallas.py:739-820`), chunked over queries as the
    forward, with the TPU kernels' rounding points as in
    `attention_bwd_plain` (q * scale, p for dv and ds for dq and dk cast to
    q's dtype; no-ops in float32). Returns (dq, dk, dv) in q's dtype and
    ddiag (H, 2T-1) float32 (None without diag): ds summed over the batch
    onto the diagonals of the padded grid, then the pad bands folded onto
    the edge diagonals, the adjoint of the edge padding."""
    B, T, D = q.shape
    Dh = D // heads
    scale = 1.0 / (Dh ** 0.5)
    dt = q.dtype
    Tp = -(-T // bq) * bq
    qp, gp = (F.pad(x, (0, 0, 0, Tp - T)) for x in (q, g))
    dpad = _edge_pad(diag.float(), Tp - T) if diag is not None else None
    kh, vh = _heads(k, heads).float(), _heads(v, heads).float()
    dq = torch.empty_like(q)
    dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
    full = (torch.zeros((heads, 2 * Tp - 1), dtype=torch.float32,
                        device=q.device) if diag is not None else None)
    for i0 in range(0, T, bq):
        qs = (_heads(qp[:, i0:i0 + bq], heads).float() * scale).to(dt).float()
        gh = _heads(gp[:, i0:i0 + bq], heads).float()
        s = qs @ kh.transpose(-1, -2)
        if dpad is not None:
            s = s + toeplitz_expand(dpad, bq, T, T=Tp, qoff=i0)[None]
        p = _softmax_keys(s, lens)
        dv += p.to(dt).float().transpose(-1, -2) @ gh
        dp = gh @ vh.transpose(-1, -2)
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
        dsc = ds.to(dt).float()
        dq[:, i0:i0 + bq] = _merge((dsc @ kh) * scale)[:, :T - i0].to(dt)
        dk += dsc.transpose(-1, -2) @ qs
        if full is not None:  # ds onto diagonals (Tp-1) + j - (i0 + i)
            i = torch.arange(i0, i0 + bq, device=q.device)[:, None]
            j = torch.arange(T, device=q.device)[None, :]
            full.index_add_(1, ((Tp - 1) + j - i).reshape(-1),
                            ds.sum(dim=0).reshape(heads, -1))
    ddiag = None
    if full is not None:
        off = Tp - T
        ddiag = full[:, off:off + 2 * T - 1].clone()
        if off:
            ddiag[:, 0] += full[:, :off].sum(dim=1)
            ddiag[:, -1] += full[:, off + 2 * T - 1:].sum(dim=1)
    return dq, _merge(dk).to(dt), _merge(dv).to(dt), ddiag


def _flash_args(name, q, k, v, diag, lens, heads, extra=()):
    """`_kernel_args` for the flash kernels: diag must be (H, 2T-1) float32
    on q's device (attention without a bias is `attention_fwd`'s)."""
    (q, k, v, _, *extra), lens32 = _kernel_args(name, q, k, v, None, lens,
                                                heads, extra)
    T = q.shape[1]
    if (diag is None or tuple(diag.shape) != (heads, 2 * T - 1)
            or diag.dtype != torch.float32 or diag.device != q.device):
        got = ("None" if diag is None else
               f"{tuple(diag.shape)} {diag.dtype} on {diag.device}")
        raise ValueError(f"{name}: diag {got} is not ({heads}, {2 * T - 1}) "
                         f"float32 on {q.device}")
    return (q, k, v, diag.contiguous(), *extra), lens32


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              diag: torch.Tensor | None, lens: torch.Tensor, heads: int,
              with_lse: bool = False):
    """The long-audio attention kernel (`csrc/attention.cu`, bias mode
    kDiag): returns (out, lse) as `attention_fwd` does, with the bias read
    from the float32 diagonals diag (H, 2T-1), at any T. On CPU tensors:
    (`flash_fwd_plain`, None), where diag may also be None. Runs as the
    operator `asr_port::flash_fwd`."""
    out, lse = flash_op(q, k, v, diag, lens, heads, with_lse)
    return out, (lse if with_lse and q.device.type != "cpu" else None)


flash_fwd.launches = 0


@torch.library.custom_op(
    "asr_port::flash_fwd", mutates_args=(), device_types="cpu",
    schema="(Tensor q, Tensor k, Tensor v, Tensor? diag, Tensor lens, "
           "int heads, bool with_lse) -> (Tensor, Tensor)")
def flash_op(q, k, v, diag, lens, heads, with_lse):
    """The operator's CPU version: `flash_fwd_plain`, and an empty lse."""
    return (flash_fwd_plain(q, k, v, diag, lens, heads),
            q.new_empty(0, dtype=torch.float32))


@flash_op.register_fake
def _flash_fake(q, k, v, diag, lens, heads, with_lse):
    return torch.empty_like(q), _lse_fake(q, heads, with_lse)


@flash_op.register_kernel("cuda")
def _flash_cuda(q, k, v, diag, lens, heads, with_lse):
    (q, k, v, diag), lens32 = _flash_args("flash_fwd", q, k, v, diag, lens,
                                          heads)
    out, lse, launched = _fwd_launch("flash_launch", "flash_fwd", q, k, v,
                                     (diag.data_ptr(),), lens32, heads,
                                     with_lse)
    flash_fwd.launches += launched
    return out, lse if lse is not None else q.new_empty(0, dtype=torch.float32)


def flash_bwd(q, k, v, diag, lens, g, lse, heads: int):
    """The long-audio backward kernels (the delta pre-pass; dq, dk, dv and
    per-tile diagonal sums; then ddiag): returns (dq, dk, dv, ddiag) as `flash_bwd_plain` does, from the
    forward's `lse`. ddiag (H, 2T-1) float32 is summed over the batch in a
    fixed order (`ddiag_scratch`). On CPU tensors: `flash_bwd_plain`."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, diag, lens, g, heads)
    (q, k, v, diag, g), lens32 = _flash_args("flash_bwd", q, k, v, diag,
                                             lens, heads, extra=(g,))
    B, T = q.shape[:2]
    ddiag = torch.empty((heads, 2 * T - 1), dtype=torch.float32,
                        device=q.device)
    part = torch.empty(ddiag_scratch(B, T, heads), dtype=torch.float32,
                       device=q.device)
    dq, dk, dv, launched = _bwd_launch(
        "flash_bwd_launch", "flash_bwd", q, k, v, g, (diag.data_ptr(),),
        (part.data_ptr(), ddiag.data_ptr()), lens32, lse, heads)
    flash_bwd.launches += launched
    if not launched:
        ddiag.zero_()
    return dq, dk, dv, ddiag


flash_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, diag, lens, heads, plain):
        grad = any(ctx.needs_input_grad[:4])
        if plain:
            out, lse = flash_fwd_plain(q, k, v, diag, lens, heads), None
        else:
            out, lse = flash_fwd(q, k, v, diag, lens, heads, with_lse=grad)
        if grad:
            ctx.save_for_backward(q, k, v, diag, lens, lse)
            ctx.heads, ctx.plain = heads, plain
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, diag, lens, lse = ctx.saved_tensors
        if ctx.plain:
            grads = flash_bwd_plain(q, k, v, diag, lens, g, ctx.heads)
        else:
            grads = flash_bwd(q, k, v, diag, lens, g, lse, ctx.heads)
        return *grads, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    diag: torch.Tensor | None, lens: torch.Tensor, heads: int,
                    plain: bool = False) -> torch.Tensor:
    """Length-masked self-attention for long audio, with the relative bias
    as diagonals, and its gradient (the JAX package's `flash_attention`,
    `ops/attention_pallas.py:823`): the flash kernels on CUDA tensors (the
    plain versions on CPU tensors), or with `plain` the plain versions on
    any device. The backward returns (dq, dk, dv, ddiag), ddiag float32.

    q/k/v: (B, T, H*Dh), bfloat16 for the kernels; diag: (H, 2T-1) float32
    or None; lens: (B,) integer. As `fused_attention`, query rows past
    lens[b] still produce outputs that callers mask."""
    return _FlashAttention.apply(q, k, v, diag, lens, heads, plain)


# ------------------------------------------------------- tensor parallelism
def sharded_fused_attention(tp: int, q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, bias: torch.Tensor | None,
                            lens: torch.Tensor, heads: int,
                            diag: torch.Tensor | None = None,
                            plain: bool = False) -> torch.Tensor:
    """Attention on one rank's heads of a 'model' axis of size `tp`: the
    JAX package's `sharded_fused_attention` (`ops/attention_pallas.py:898`),
    whose shard_map hands each device its (B/dp, T, H/tp Dh) slice, and
    `MhsaBlock`'s one attention path (tp 1 off a mesh).

    q, k, v, lens: this rank's rows and heads (the column-parallel
    projections' H/tp contiguous Dh-column groups); `heads` is the global
    H. `bias` (H/tp, P, P), or on the flash path `diag` (H/tp, 2T-1)
    float32, holds this rank's heads (`RelPosBias` takes them from its
    table). Runs `fused_attention` (kernels #3/#4), with `diag`
    `flash_attention` (#7/#8), with `plain` their plain versions, on the
    local heads alone and with no collective, as in JAX: a bias's
    gradient covers this rank's heads and rows, for the caller to sum. The
    JAX package runs flash unsharded under GSPMD; head-sharding it gives
    the same result."""
    if heads % tp:
        raise ValueError(f"{heads} heads do not split over tp={tp}")
    local = heads // tp
    rel = diag if diag is not None else bias
    if rel is not None and rel.shape[0] != local:
        raise ValueError(f"bias of {rel.shape[0]} heads for this rank's "
                         f"{local}")
    if diag is not None:
        return flash_attention(q, k, v, diag, lens, local, plain=plain)
    attend = attention_plain if plain else fused_attention
    return attend(q, k, v, bias, lens, local)
