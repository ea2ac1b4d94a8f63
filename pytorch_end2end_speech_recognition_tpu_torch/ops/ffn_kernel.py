"""The fused FFN block (`csrc/ffn.cu`): the kernels of the JAX package's
`ops/ffn_pallas.py`, their plain versions, and the autograd function that
puts the backward kernel on the training path.

out = x + scale * dropout(rd(W2 silu(W1 LN(x) + b1) + b2)) over the rows of
x (R, D), with LN in float32 (eps 1e-6), bf16 operands and float32 sums in
both products, and rd the rounding to x's dtype. The weights are taken as
nn.Linear holds them: w1 = fc1.weight (F, D), w2 = fc2.weight (D, F) (the
JAX kernel's w1 and w2 are their transposes). Dropout keeps element (r, c)
by a counter-based hash of (seed, global row r, column c), so the mask
depends on no tile size and the backward regenerates it; `keep_multiplier`
is its plain version, bit for bit. `ffn_fwd` and `ffn_bwd` launch their
kernel on CUDA tensors, count the launch, and take the plain version only
for CPU tensors. `FfnFused` makes the pair one differentiable function, and
`ffn_block_fused` is the counterpart of the JAX `ffn_block_fused`.
"""

from __future__ import annotations

import ctypes

import torch

LN_EPS = 1e-6
R_TILE = 256  # the TPU kernel's row tile, part of its VMEM estimate
MASK32 = 0xFFFFFFFF


def fits_vmem(D: int, F: int, budget_bytes: int = 9 * 2 ** 20) -> bool:
    """The JAX package's gate for its fused FFN (`ops/ffn_pallas.py`): bf16
    weights, float32 gradient sums and working tiles against 9 MiB. That is
    the TPU's VMEM budget, not a limit of the H100; it is kept so that one
    config takes one path in both packages, like the 15 MiB of
    `_rel_bias_repr`. True at D 256 / F 1024 (the flagship, rung 3), false
    at rung 4 (D 512 / F 2048) and rung 5."""
    weights = 2 * D * F * 2
    accums = 2 * D * F * 4
    tiles = R_TILE * (2 * D + 3 * F) * 4
    return weights + accums + tiles <= budget_bytes


# ------------------------------------------------------------ dropout mask
def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 h in [0, 2^32): the product is split into
    16-bit halves so no int64 product overflows."""
    lo, hi = h & 0xFFFF, h >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & MASK32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 tensors holding uint32 values."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def keep_multiplier(seed: torch.Tensor, rows: torch.Tensor, D: int,
                    rate: float) -> torch.Tensor:
    """The kernels' dropout multiplier, (len(rows), D) float32: 0 where
    element (row, col) is dropped, else 1 / (1 - rate). With h = fmix32(
    fmix32(fmix32(seed + 0x9E3779B9) ^ row) ^ col), the element drops iff
    (h & 0xFFFFFF) / 2^24 < rate in float32. `seed` is the (1,) int32
    tensor the kernels read; `rows` are global row indices."""
    dev = rows.device
    s = seed.to(dev, torch.int64).reshape(()) & MASK32
    rk = _fmix32(_fmix32((s + 0x9E3779B9) & MASK32) ^ rows.to(torch.int64))
    h = _fmix32(rk[:, None] ^ torch.arange(D, device=dev)[None, :])
    u = (h & 0xFFFFFF).to(torch.float32) * 2.0 ** -24
    drop = u < torch.tensor(rate, dtype=torch.float32, device=dev)
    keep = torch.tensor(_keep_scale(rate), dtype=torch.float32, device=dev)
    return torch.where(drop, torch.zeros((), device=dev), keep)


def _keep_scale(rate: float) -> float:
    """1 / (1 - rate), the multiplier of a kept element, as float32."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))


# ---------------------------------------------------------- plain versions
def _ln(xf, gamma, beta):
    mean = xf.mean(dim=1, keepdim=True)
    var = (xf - mean).square().mean(dim=1, keepdim=True)
    rstd = torch.rsqrt(var + LN_EPS)
    xn = (xf - mean) * rstd
    return xn * gamma.float() + beta.float(), xn, rstd


def _mm(a, b, wdt):
    """a @ b with both operands rounded to the weights' dtype, multiplied
    in float32."""
    return a.to(wdt).float() @ b.to(wdt).float()


def ffn_fwd_plain(x, gamma, beta, w1, b1, w2, b2, seed, rate: float,
                  scale: float) -> torch.Tensor:
    """The forward kernel in torch: x (R, D), float32 or bf16 -> out of x's
    dtype, with the kernel's roundings and mask."""
    wdt = w1.dtype
    xf = x.float()
    y, _, _ = _ln(xf, gamma, beta)
    h1 = _mm(y, w1.t(), wdt) + b1.float()
    a = h1 * torch.sigmoid(h1)
    h2 = (_mm(a, w2.t(), wdt) + b2.float()).to(x.dtype).float()
    if rate > 0.0:
        rows = torch.arange(x.shape[0], device=x.device)
        h2 = h2 * keep_multiplier(seed, rows, x.shape[1], rate)
    return (xf + scale * h2).to(x.dtype)


def ffn_bwd_plain(x, g, gamma, beta, w1, b1, w2, b2, seed, rate: float,
                  scale: float):
    """The backward kernel in torch: the cotangent g of out -> (dx,
    dgamma, dbeta, dw1, db1, dw2, db2), the forward recomputed from x, the
    gradients in their inputs' dtypes (the JAX `_ffn_bwd`'s rule), with the
    kernel's roundings: g2 = scale g keep, gh1 and y, a rounded to the
    weights' dtype before their products."""
    wdt = w1.dtype
    xf = x.float()
    y, xn, rstd = _ln(xf, gamma, beta)
    h1 = _mm(y, w1.t(), wdt) + b1.float()
    sig = torch.sigmoid(h1)
    a = h1 * sig
    gf = g.float()
    g2 = scale * gf
    if rate > 0.0:
        rows = torch.arange(x.shape[0], device=x.device)
        g2 = g2 * keep_multiplier(seed, rows, x.shape[1], rate)
    dw2 = _mm(g2.t(), a, wdt)
    db2 = g2.sum(dim=0)
    gh1 = _mm(g2, w2, wdt) * (sig * (1.0 + h1 * (1.0 - sig)))
    dw1 = _mm(gh1.t(), y, wdt)
    db1 = gh1.sum(dim=0)
    gy = _mm(gh1, w1, wdt)
    dgamma = (gy * xn).sum(dim=0)
    dbeta = gy.sum(dim=0)
    gxn = gy * gamma.float()
    m1 = gxn.mean(dim=1, keepdim=True)
    m2 = (gxn * xn).mean(dim=1, keepdim=True)
    dx = gf + rstd * (gxn - m1 - xn * m2)
    return (dx.to(x.dtype), dgamma.to(gamma.dtype), dbeta.to(beta.dtype),
            dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
            db2.to(b2.dtype))


# ------------------------------------------------------------------ kernels
def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(name, x, gamma, beta, w1, b1, w2, b2, seed, g=None):
    """Raise on what the kernels do not take; return contiguous operands
    (x, gamma, beta, w1, b1, w2, b2, seed, g)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dim() != 2 or x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: x must be (R, D) bf16 or float32, got "
                        f"{tuple(x.shape)} {x.dtype}")
    R, D = x.shape
    F = w1.shape[0]
    if D not in (256, 512) or F % 64 or F < 64:
        raise ValueError(f"{name} kernel takes D 256 or 512 and F a "
                         f"multiple of 64, got D={D}, F={F}")
    shapes = {"gamma": (gamma, (D,), torch.float32),
              "beta": (beta, (D,), torch.float32),
              "w1": (w1, (F, D), torch.bfloat16),
              "b1": (b1, (F,), torch.bfloat16),
              "w2": (w2, (D, F), torch.bfloat16),
              "b2": (b2, (D,), torch.bfloat16),
              "seed": (seed, (1,), torch.int32)}
    if g is not None:
        shapes["g"] = (g, (R, D), x.dtype)
    out = {"x": x}
    for key, (t, shape, dt) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != dt or t.device != x.device:
            raise TypeError(f"{name}: {key} must be {shape} {dt} on "
                            f"{x.device}, got {tuple(t.shape)} {t.dtype} on "
                            f"{t.device}")
    for key, t in {"x": x, **{k: v[0] for k, v in shapes.items()}}.items():
        t = t.contiguous()
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} is not 16-byte aligned")
        out[key] = t
    return out


def ffn_fwd(x, gamma, beta, w1, b1, w2, b2, seed, rate: float,
            scale: float) -> torch.Tensor:
    """out (R, D) of the block: the forward kernel on CUDA tensors,
    `ffn_fwd_plain` on CPU tensors, as the operator `asr_port::ffn_fwd`."""
    return ffn_fwd_op(x, gamma, beta, w1, b1, w2, b2, seed, float(rate),
                      float(scale))


ffn_fwd.launches = 0


@torch.library.custom_op(
    "asr_port::ffn_fwd", mutates_args=(), device_types="cpu",
    schema="(Tensor x, Tensor gamma, Tensor beta, Tensor w1, Tensor b1, "
           "Tensor w2, Tensor b2, Tensor seed, float rate, float scale) "
           "-> Tensor")
def ffn_fwd_op(x, gamma, beta, w1, b1, w2, b2, seed, rate, scale):
    """The operator's CPU version: `ffn_fwd_plain`."""
    return ffn_fwd_plain(x, gamma, beta, w1, b1, w2, b2, seed, rate, scale)


@ffn_fwd_op.register_fake
def _ffn_fwd_fake(x, gamma, beta, w1, b1, w2, b2, seed, rate, scale):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


@ffn_fwd_op.register_kernel("cuda")
def _ffn_fwd_cuda(x, gamma, beta, w1, b1, w2, b2, seed, rate, scale):
    from pytorch_end2end_speech_recognition_tpu_torch.ops import _build

    t = _check("ffn_fwd", x, gamma, beta, w1, b1, w2, b2, seed)
    R, D = x.shape
    out = torch.empty_like(t["x"])
    if R:
        err = _build.load().ffn_fwd_launch(
            *(t[k].data_ptr() for k in ("x", "gamma", "beta", "w1", "b1",
                                        "w2", "b2", "seed")),
            out.data_ptr(), int(x.dtype == torch.bfloat16), R, D,
            w1.shape[0], float(scale), float(rate),
            _keep_scale(rate), _stream(x))
        _build.check(err, "ffn_fwd")
        ffn_fwd.launches += 1
    return out


def bwd_plan(R: int, D: int, F: int) -> dict:
    """The backward kernels' plan for (R, D, F), from the library: S row
    splits of the weight-gradient pass, the rows of its partial column sums
    (part (n_part, 3, D), db1p (n_db, F)) and whether it takes the (R, F)
    a and gh1 scratch (`af`: the wgmma/TMA kernels at D 256)."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops import _build

    out = (ctypes.c_int * 4)()
    _build.check(_build.load().ffn_bwd_plan(R, D, F, out), "ffn_bwd_plan")
    return dict(zip(("S", "n_part", "n_db", "af"), out))


def ffn_bwd(x, g, gamma, beta, w1, b1, w2, b2, seed, rate: float,
            scale: float):
    """(dx, dgamma, dbeta, dw1, db1, dw2, db2) for the cotangent g of out:
    the backward kernels on CUDA tensors (row tiles, then the weight
    gradients over row splits, then a deterministic sum of their partials),
    `ffn_bwd_plain` on CPU tensors."""
    if x.device.type == "cpu":
        return ffn_bwd_plain(x, g, gamma, beta, w1, b1, w2, b2, seed, rate,
                             scale)
    from pytorch_end2end_speech_recognition_tpu_torch.ops import _build

    t = _check("ffn_bwd", x, gamma, beta, w1, b1, w2, b2, seed,
               g.to(x.dtype))
    R, D = x.shape
    F = w1.shape[0]
    dx = torch.empty_like(t["x"])
    f32 = dict(dtype=torch.float32, device=x.device)
    bf = dict(dtype=torch.bfloat16, device=x.device)
    new = torch.empty if R else torch.zeros  # the kernels write every element
    dgamma, dbeta = new(D, **f32), new(D, **f32)
    dw1, db1 = new(F, D, **bf), new(F, **bf)
    dw2, db2 = new(D, F, **bf), new(D, **bf)
    if R:
        p = bwd_plan(R, D, F)
        S = p["S"]
        yw, g2w = torch.empty(R, D, **bf), torch.empty(R, D, **bf)
        aw = hw = None
        if p["af"]:
            aw, hw = torch.empty(R, F, **bf), torch.empty(R, F, **bf)
        part = torch.empty(p["n_part"], 3, D, **f32)
        dw1p, dw2p = torch.empty(S, F, D, **f32), torch.empty(S, D, F, **f32)
        db1p = torch.empty(p["n_db"], F, **f32)
        ptr = lambda a: None if a is None else a.data_ptr()  # noqa: E731
        err = _build.load().ffn_bwd_launch(
            *(t[k].data_ptr() for k in ("x", "g", "gamma", "beta", "w1", "b1",
                                        "w2", "seed")),
            *(ptr(a) for a in (dx, yw, g2w, aw, hw, part, dw1p, dw2p, db1p,
                               dgamma, dbeta, dw1, db1, dw2, db2)),
            int(x.dtype == torch.bfloat16), R, D, F, S, float(scale),
            float(rate), _keep_scale(rate),
            _stream(x))
        _build.check(err, "ffn_bwd")
        ffn_bwd.launches += 1
    return dx, dgamma, dbeta, dw1, db1, dw2, db2


ffn_bwd.launches = 0


class FfnFused(torch.autograd.Function):
    """out (R, D) of the fused block, differentiable in (x, gamma, beta,
    w1, b1, w2, b2); the int32 seed, rate and scale are not."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w1, b1, w2, b2, seed, rate, scale):
        ctx.rate, ctx.scale = rate, scale
        ctx.save_for_backward(x, gamma, beta, w1, b1, w2, b2, seed)
        return ffn_fwd(x, gamma, beta, w1, b1, w2, b2, seed, rate, scale)

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta, w1, b1, w2, b2, seed = ctx.saved_tensors
        grads = ffn_bwd(x, g, gamma, beta, w1, b1, w2, b2, seed, ctx.rate,
                        ctx.scale)
        return (*grads, None, None, None)


def ffn_block_fused(x, gamma, beta, w1, b1, w2, b2, *, rate: float,
                    scale: float, train: bool = False,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """(B, T, D) wrapper of `FfnFused`: the rows flattened, dropout at
    `rate` only with `train`, its seed a (1,) int32 tensor drawn on x's
    device from `generator` (no host sync). Training at a rate > 0 without
    a generator raises, as `dropout` does."""
    B, T, D = x.shape
    use_rate = float(rate) if train and rate > 0.0 else 0.0
    if use_rate > 0.0:
        if generator is None:
            raise ValueError(f"dropout at rate {rate} in training needs a "
                             "torch.Generator")
        seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                             device=x.device, dtype=torch.int32)
    else:
        seed = torch.zeros(1, dtype=torch.int32, device=x.device)
    out = FfnFused.apply(x.reshape(B * T, D), gamma, beta, w1, b1, w2, b2,
                         seed, use_rate, float(scale))
    return out.reshape(B, T, D)
