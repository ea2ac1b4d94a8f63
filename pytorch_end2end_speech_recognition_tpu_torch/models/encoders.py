"""Conformer encoder (the port of the JAX package's `models/encoders.py`).

Modules take (feats (B, T, F), frame_lens) and return (enc (B, T', D),
enc_lens) with the reference's length math. Parameters are float32 and
named as in the JAX package (`bridge.py` maps one onto the other); every
matrix product and convolution runs in `cfg.dtype` and the residual stream
is kept in `cfg.residual_dtype`, exactly where the JAX modules cast. Layer
norms use eps 1e-6 (Flax's default) and compute in float32. With
`train=True` and a `torch.Generator`, dropout applies at the reference's
sites (MHSA and FFN outputs, the conv module's output, and after the
subsampling); the generator's numbers are not JAX's keys, so the tests run
training with dropout 0.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from pytorch_end2end_speech_recognition_tpu_torch.ops.attention_kernel import (
    attention_plain,
    fused_attention,
    toeplitz_dense,
    toeplitz_expand,
)
from pytorch_end2end_speech_recognition_tpu_torch.utils.config import ModelConfig

LN_EPS = 1e-6
FLASH_T = 768  # beyond this the JAX package takes the q-block flash kernel


def _dt(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _rdt(cfg: ModelConfig) -> torch.dtype:
    """Residual-stream dtype (see ModelConfig.residual_dtype)."""
    return torch.bfloat16 if cfg.residual_dtype == "bfloat16" else torch.float32


def length_mask(lens: torch.Tensor, T: int) -> torch.Tensor:
    return torch.arange(T, device=lens.device)[None, :] < lens[:, None]


def _masked(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero x where mask (broadcast from the left over x's leading dims)."""
    return torch.where(mask, x, torch.zeros((), dtype=x.dtype, device=x.device))


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            train: bool) -> torch.Tensor:
    """Stateless dropout (the JAX package's `dropout`): a no-op unless
    training at a rate > 0; kept elements scaled by 1/(1-rate) in x's dtype.
    Draws from `generator`, which must live on x's device."""
    if not train or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError(f"dropout at rate {rate} in training needs a "
                         "torch.Generator")
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return x * ((u < 1.0 - rate).to(x.dtype) * (1.0 / (1.0 - rate)))


def _linear(x: torch.Tensor, layer: nn.Linear, dt: torch.dtype) -> torch.Tensor:
    """nnx.Linear(dtype=dt): input, kernel and bias cast to dt."""
    return F.linear(x.to(dt), layer.weight.to(dt), layer.bias.to(dt))


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """nnx.LayerNorm with float32 params: computed and returned in float32."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        LN_EPS)


def _same_pad_s2(n: int) -> tuple[int, int]:
    """Flax 'SAME' padding for kernel 3, stride 2: (0, 1) when n is even,
    (1, 1) when odd."""
    total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
    return total // 2, total - total // 2


class ConvSubsample(nn.Module):
    """2-layer stride-2 conv2d subsampling (x4) over (time, mel)."""

    def __init__(self, n_mels: int, d_model: int, cfg: ModelConfig):
        super().__init__()
        C = cfg.subsample_channels or d_model
        self.conv1 = nn.Conv2d(1, C, 3, stride=2)
        self.conv2 = nn.Conv2d(C, C, 3, stride=2)
        f_out = ((n_mels + 1) // 2 + 1) // 2
        self.proj = nn.Linear(f_out * C, d_model)
        self.dt, self.rdt = _dt(cfg), _rdt(cfg)

    def _conv(self, h: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
        (t0, t1), (f0, f1) = _same_pad_s2(h.shape[2]), _same_pad_s2(h.shape[3])
        h = F.pad(h.to(self.dt), (f0, f1, t0, t1))
        return F.relu(F.conv2d(h, conv.weight.to(self.dt),
                               conv.bias.to(self.dt), stride=2))

    def forward(self, x: torch.Tensor, lens: torch.Tensor):
        h = _masked(x, length_mask(lens, x.shape[1])[:, :, None])[:, None]
        h = self._conv(h, self.conv1)                    # (B, C, T/2, F/2)
        lens = (lens + 1) // 2
        h = _masked(h, length_mask(lens, h.shape[2])[:, None, :, None])
        h = self._conv(h, self.conv2)
        lens = (lens + 1) // 2
        h = _masked(h, length_mask(lens, h.shape[2])[:, None, :, None])
        B, C, T, Fo = h.shape
        # Flax is NHWC and flattens (F, C) with C fastest
        h = h.permute(0, 2, 3, 1).reshape(B, T, Fo * C)
        return _linear(h, self.proj, self.dt).to(self.rdt), lens


class RelPosBias(nn.Module):
    """Bucketed relative position bias: a learned (layers, heads, n_buckets)
    table. The 2T-1 relative offsets are bucketed (a small gather), then
    expanded into a dense (H, T, T) Toeplitz block for every layer at once.
    """

    def __init__(self, layers: int, heads: int, n_buckets: int = 64,
                 max_dist: int = 256):
        super().__init__()
        self.n_buckets = n_buckets
        self.max_dist = max_dist
        self.table = nn.Parameter(torch.empty(layers, heads, n_buckets))

    def _bucket(self, rel: torch.Tensor) -> torch.Tensor:
        nb = self.n_buckets // 2
        sign = (rel > 0).to(torch.int32) * nb
        arel = rel.abs()
        half = nb // 2
        exact = arel < half
        log_ratio = torch.log(torch.clamp(arel.float(), min=1.0) / half)
        log_den = float(torch.log(torch.tensor(self.max_dist / half,
                                               dtype=torch.float64)))
        big = half + (log_ratio / log_den * (nb - half)).to(torch.int32)
        big = torch.clamp(big, max=nb - 1)
        return sign + torch.where(exact, arel.to(torch.int32), big)

    def diags(self, T: int, dtype=torch.float32) -> torch.Tensor:
        """(L, H, 2T-1) diagonal vectors: diag[..., (T-1) + r] is the bias
        of relative offset r = j - i."""
        rel = torch.arange(-(T - 1), T, device=self.table.device)
        return self.table[:, :, self._bucket(rel)].to(dtype)

    def forward(self, T: int, dtype=torch.float32, pad_to: int | None = None,
                impl: str = "torch") -> torch.Tensor:
        """(L, H, P, P) biases for all layers, P = pad_to or T. With
        impl='cuda' the Toeplitz kernel expands every layer in one launch,
        padded to `pad_to` (edge values in the pad band)."""
        L, H, _ = self.table.shape
        diag = self.diags(T).reshape(L * H, 2 * T - 1)
        P = pad_to or T
        if impl == "cuda":
            dense = toeplitz_dense(diag.contiguous(), T, P, dtype)
        else:
            dense = toeplitz_expand(diag, P, P, T=T).to(dtype)
        return dense.reshape(L, H, P, P)


def _rel_bias_repr(rel: RelPosBias | None, cfg: ModelConfig, T: int):
    """Dense stacked (L, H, P, P) biases, or None without a relative bias.

    On the kernel path the expansion is padded to a 128 multiple, as the
    JAX package pads for its whole-row kernel. Beyond FLASH_T frames the
    JAX package switches to its q-block flash kernel with diagonal biases;
    that kernel is not ported, so the CUDA path raises there instead of
    quietly computing something else. The plain path is dense for any T."""
    if rel is None:
        return None
    if cfg.attn_impl == "cuda":
        if T > FLASH_T:
            raise NotImplementedError(
                f"{T} encoder frames exceed FLASH_T={FLASH_T}: the long-audio "
                "flash attention kernel (JAX ops/attention_pallas.py "
                "_flash_fwd_pallas) is not ported yet; set "
                "model.attn_impl=torch to run the plain dense path")
        return rel(T, dtype=_dt(cfg), pad_to=-(-T // 128) * 128, impl="cuda")
    return rel(T, dtype=_dt(cfg))


class MhsaBlock(nn.Module):
    """Pre-LN multi-head self-attention with key padding mask and an
    optional per-head additive bias."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        D = cfg.encoder_dim
        self.ln = nn.LayerNorm(D, eps=LN_EPS)
        self.q = nn.Linear(D, D)
        self.k = nn.Linear(D, D)
        self.v = nn.Linear(D, D)
        self.o = nn.Linear(D, D)
        self.heads = cfg.encoder_heads
        self.attn_impl = cfg.attn_impl
        self.rate = cfg.encoder_dropout
        self.dt, self.rdt = _dt(cfg), _rdt(cfg)

    def forward(self, x, mask, bias=None, train=False, gen=None):
        """`bias`: this block's (H, P, P) slice of the stacked biases."""
        h = _layer_norm(x, self.ln)
        qf = _linear(h, self.q, self.dt)
        kf = _linear(h, self.k, self.dt)
        vf = _linear(h, self.v, self.dt)
        lens = mask.sum(dim=1).to(torch.int32)
        attend = fused_attention if self.attn_impl == "cuda" else attention_plain
        y = attend(qf, kf, vf, bias, lens, self.heads)
        y = _linear(y, self.o, self.dt).to(self.rdt)
        return x + dropout(y, self.rate, gen, train)


class FfnBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, scale: float = 1.0):
        super().__init__()
        D = cfg.encoder_dim
        self.scale = scale
        self.ln = nn.LayerNorm(D, eps=LN_EPS)
        self.fc1 = nn.Linear(D, cfg.encoder_ffn_dim)
        self.fc2 = nn.Linear(cfg.encoder_ffn_dim, D)
        self.rate = cfg.encoder_dropout
        self.dt, self.rdt = _dt(cfg), _rdt(cfg)

    def forward(self, x, train=False, gen=None):
        h = F.silu(_linear(_layer_norm(x, self.ln), self.fc1, self.dt))
        h = _linear(h, self.fc2, self.dt).to(self.rdt)
        return x + self.scale * dropout(h, self.rate, gen, train)


class ConvModule(nn.Module):
    """Conformer convolution module: pointwise-GLU -> depthwise -> LN -> pw."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        D = cfg.encoder_dim
        self.ln = nn.LayerNorm(D, eps=LN_EPS)
        self.pw1 = nn.Linear(D, 2 * D)
        self.dw = nn.Conv1d(D, D, cfg.conformer_kernel, groups=D)
        self.norm = nn.LayerNorm(D, eps=LN_EPS)
        self.pw2 = nn.Linear(D, D)
        self.rate = cfg.encoder_dropout
        self.dt, self.rdt = _dt(cfg), _rdt(cfg)

    def forward(self, x, mask, train=False, gen=None):
        h = F.glu(_linear(_layer_norm(x, self.ln), self.pw1, self.dt), dim=-1)
        h = _masked(h, mask[..., None])  # the depthwise conv must not see pad
        K = self.dw.kernel_size[0]
        h = F.pad(h.transpose(1, 2), ((K - 1) // 2, K - 1 - (K - 1) // 2))
        h = F.conv1d(h, self.dw.weight.to(self.dt), self.dw.bias.to(self.dt),
                     groups=self.dw.groups).transpose(1, 2)
        h = F.silu(_layer_norm(h, self.norm))
        h = _linear(h, self.pw2, self.dt).to(self.rdt)
        return x + dropout(h, self.rate, gen, train)


class ConformerBlock(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.ff1 = FfnBlock(cfg, scale=0.5)
        self.mhsa = MhsaBlock(cfg)
        self.conv = ConvModule(cfg)
        self.ff2 = FfnBlock(cfg, scale=0.5)
        self.ln = nn.LayerNorm(cfg.encoder_dim, eps=LN_EPS)

    def forward(self, x, mask, bias=None, train=False, gen=None):
        x = self.ff1(x, train, gen)
        x = self.mhsa(x, mask, bias, train, gen)
        x = self.conv(x, mask, train, gen)
        x = self.ff2(x, train, gen)
        return _layer_norm(x, self.ln).to(x.dtype)  # keep the residual dtype


class ConformerEncoder(nn.Module):
    def __init__(self, d_in: int, cfg: ModelConfig):
        super().__init__()
        if cfg.cp_mode or cfg.pp_stages > 1:
            raise NotImplementedError(
                "context and pipeline parallelism are not ported yet")
        self.cfg = cfg
        self.sub = ConvSubsample(d_in, cfg.encoder_dim, cfg)
        self.rel = (RelPosBias(cfg.encoder_layers, cfg.encoder_heads)
                    if cfg.pos_encoding == "relative" else None)
        self.blocks = nn.ModuleList(
            [ConformerBlock(cfg) for _ in range(cfg.encoder_layers)])
        self.rate = cfg.encoder_dropout
        self.d_out = cfg.encoder_dim

    def forward(self, x, lens, train: bool = False,
                generator: torch.Generator | None = None):
        x = _masked(x, length_mask(lens, x.shape[1])[..., None])
        x, lens = self.sub(x, lens)
        T = x.shape[1]
        x = dropout(x, self.rate, generator, train)
        mask = length_mask(lens, T)
        biases = _rel_bias_repr(self.rel, self.cfg, T)
        # unbind: one stacked gradient for all layers in the backward
        biases = biases.unbind(0) if biases is not None else \
            [None] * len(self.blocks)
        for blk, bias in zip(self.blocks, biases):
            x = blk(x, mask, bias, train, generator)
        return _masked(x, mask[..., None]), lens


def build_encoder(d_in: int, cfg: ModelConfig) -> nn.Module:
    if cfg.encoder == "conformer":
        return ConformerEncoder(d_in, cfg)
    if cfg.encoder in ("blstm", "pblstm", "transformer"):
        raise NotImplementedError(f"encoder {cfg.encoder!r} is not ported yet")
    raise ValueError(f"unknown encoder kind {cfg.encoder}")
