"""Encoders (the port of the JAX package's `models/encoders.py`): the
stacked BiLSTM, the pyramidal BiLSTM with its VGG front, the Transformer and
the Conformer; and the port's own E-Branchformer (`EBranchformerEncoder`),
which the JAX package does not have.

Modules take (feats (B, T, F), frame_lens) and return (enc (B, T', D),
enc_lens) with the reference's length math. Parameters are float32 and
named as in the JAX package (`bridge.py` maps one onto the other); every
matrix product and convolution runs in `cfg.dtype` and the residual stream
is kept in `cfg.residual_dtype`, exactly where the JAX modules cast. Layer
norms use eps 1e-6 (Flax's default) and compute in float32. With
`train=True` and a `torch.Generator`, dropout applies at the reference's
sites (MHSA and FFN outputs, the conv module's output, after the
subsampling, and after every LSTM layer); the generator's numbers are not JAX's keys, so the tests run
training with dropout 0. With `model.ffn_impl='cuda'` every `FfnBlock` that
the JAX package's gate would send to its fused Pallas FFN runs the fused FFN
kernels (`ops/ffn_kernel.py`), whose dropout draws its seed from the same
generator. With `model.remat` each block of the Transformer, Conformer and
E-Branchformer stacks runs under `torch.utils.checkpoint` in training (the
JAX package's `jax.checkpoint`), its recompute replaying the generator's
draws.

Tensor parallelism (`parallel/sharding.py` shards the parameters, then sets
`tp_group` on the modules that have one): MhsaBlock (q/k/v
column-parallel on this rank's H/tp heads, o row-parallel), FfnBlock (fc1,
fc2), ConvModule (pw1 in GLU halves, pw2; the depthwise conv on this
rank's channels; its channel LayerNorm's mean and variance summed over
the shards) and the relative-bias table (this rank's heads). A replicated
parameter that a rank uses only in part, or on its own part of the
activations (the column-parallel biases, the depthwise conv, the channel
LayerNorm, the bias table; under sequence parallelism the layer norms and
the row-parallel biases), enters through `copy_to`, so its gradient is
summed over the 'model' group. With `model.sp` the residual stream between
blocks is split along time over the 'model' group (Megatron sequence
parallelism: the JAX package's `sp_constrain`), when tp divides T.

Context and pipeline parallelism (`model.cp_mode`, `model.pp_stages`), as
the JAX encoders run them: without a mesh, `cp_mode` sends the relative
bias to the float32 diagonals and attention takes its ordinary (flash)
path, and `pp_stages > 1` is the plain block loop (no fused FFN). On a
mesh, `cp_mode` ('ring' or 'ulysses') runs `MhsaBlock`'s attention with
the time axis split over the 'model' group (`parallel/cp.py`; under
tensor parallelism the projections stay split by heads, and the heads are
gathered around it), and `pp_stages > 1` runs the blocks as a GPipe
pipeline over that group (`parallel/pp.py`), whose size must equal
`pp_stages`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from pytorch_end2end_speech_recognition_tpu_torch.ops.attention_kernel import (
    sharded_fused_attention,
    toeplitz_dense,
    toeplitz_expand,
)
from pytorch_end2end_speech_recognition_tpu_torch.ops.ffn_kernel import (
    ffn_block_fused,
    fits_vmem,
)
from pytorch_end2end_speech_recognition_tpu_torch.ops.masks import (
    length_mask,
    masked,
)
from pytorch_end2end_speech_recognition_tpu_torch.ops.rnn import bilstm_layer
from pytorch_end2end_speech_recognition_tpu_torch.ops.subsample_kernel import (
    subsample,
    subsample_plain,
)
from pytorch_end2end_speech_recognition_tpu_torch.parallel.collectives import (
    copy_to,
    gather_features,
    gather_time,
    gather_time_replicated,
    group_rank,
    reduce_from,
    reduce_scatter_time,
    size,
    split_features,
    split_time,
    sum_both,
)
from pytorch_end2end_speech_recognition_tpu_torch.parallel.cp import (
    sharded_self_attention,
)
from pytorch_end2end_speech_recognition_tpu_torch.parallel.pp import (
    pipeline_blocks,
)
from pytorch_end2end_speech_recognition_tpu_torch.parallel.sharding import (
    shard_tensor,
)
from pytorch_end2end_speech_recognition_tpu_torch.utils.config import ModelConfig
from pytorch_end2end_speech_recognition_tpu_torch.utils.profiling import span

LN_EPS = 1e-6
FLASH_T = 768  # beyond this the relative bias travels as diagonals and
# attention takes the flash path (the JAX package's rule, `_rel_bias_repr`)


def _dt(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _rdt(cfg: ModelConfig) -> torch.dtype:
    """Residual-stream dtype (see ModelConfig.residual_dtype)."""
    return torch.bfloat16 if cfg.residual_dtype == "bfloat16" else torch.float32


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            train: bool, group=None) -> torch.Tensor:
    """Stateless dropout (the JAX package's `dropout`): a no-op unless
    training at a rate > 0; kept elements scaled by 1/(1-rate) in x's dtype.
    Draws from `generator`, which must live on x's device. With a `group`,
    x is this rank's time slice of a (B, T, ...) tensor split over it
    (sequence parallelism): the whole mask is drawn, as without the split
    (the group's ranks hold one generator state), and this rank's slice
    kept, so the slices do not repeat one pattern."""
    if not train or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError(f"dropout at rate {rate} in training needs a "
                         "torch.Generator")
    shape = list(x.shape)
    shape[1] *= size(group)
    u = torch.rand(shape, generator=generator, device=x.device)
    if group is not None:
        u = u.chunk(size(group), 1)[group_rank(group)]
    return x * ((u < 1.0 - rate).to(x.dtype) * (1.0 / (1.0 - rate)))


def _linear(x: torch.Tensor, layer: nn.Linear, dt: torch.dtype) -> torch.Tensor:
    """nnx.Linear(dtype=dt): input, kernel and bias (if any) cast to dt."""
    bias = None if layer.bias is None else layer.bias.to(dt)
    return F.linear(x.to(dt), layer.weight.to(dt), bias)


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm,
                group=None) -> torch.Tensor:
    """nnx.LayerNorm with float32 params: computed and returned in float32.
    With a `group`, x is this rank's part of the rows (sequence
    parallelism), so the parameters' gradients are summed over it."""
    return F.layer_norm(x.float(), ln.normalized_shape,
                        copy_to(ln.weight, group), copy_to(ln.bias, group),
                        LN_EPS)


def _part(p: torch.Tensor, group, dim: int = 0,
          glu: bool = False) -> torch.Tensor:
    """This rank's slice of a replicated parameter along `dim`, its
    gradient summed over the group (the whole parameter without one)."""
    if group is None:
        return p
    return shard_tensor(copy_to(p, group), dim, glu, size(group),
                        group_rank(group))


def _enter(h: torch.Tensor, group, sp: bool) -> torch.Tensor:
    """The input of column-parallel linears: time-gathered under sequence
    parallelism, else the replicated input, its gradient summed."""
    return gather_time(h, group) if sp else copy_to(h, group)


def _col(x: torch.Tensor, layer: nn.Linear, dt: torch.dtype, group,
         glu: bool = False) -> torch.Tensor:
    """A column-parallel linear: this rank's output features (its weight
    rows; the bias's matching slice); `_linear` without a group."""
    bias = None if layer.bias is None else _part(layer.bias, group, 0,
                                                 glu).to(dt)
    return F.linear(x.to(dt), layer.weight.to(dt), bias)


def _row(x: torch.Tensor, layer: nn.Linear, dt: torch.dtype, group,
         sp: bool) -> torch.Tensor:
    """A row-parallel linear: this rank's input features' partial product,
    summed over the group (reduce-scattered along time under sequence
    parallelism), then the bias; `_linear` without a group."""
    if group is None:
        return _linear(x, layer, dt)
    y = F.linear(x.to(dt), layer.weight.to(dt))
    y = reduce_scatter_time(y, group) if sp else reduce_from(y, group)
    return y + copy_to(layer.bias, group if sp else None).to(dt)


class LstmParams(nn.Module):
    """One LSTM direction's parameters in the JAX layout: w_ih (d_in, 4H),
    w_hh (H, 4H), bias (4H,), gate order i, f, g, o."""

    def __init__(self, d_in: int, d_hid: int):
        super().__init__()
        self.w_ih = nn.Parameter(torch.empty(d_in, 4 * d_hid))
        self.w_hh = nn.Parameter(torch.empty(d_hid, 4 * d_hid))
        self.bias = nn.Parameter(torch.empty(4 * d_hid))

    def tup(self):
        return self.w_ih, self.w_hh, self.bias


class BiLstmLayer(nn.Module):
    """One bidirectional layer; `pyramid` marks a 2x time-downsample
    (frame-pair concat) before it."""

    def __init__(self, d_in: int, d_hid: int, pyramid: bool = False):
        super().__init__()
        self.pyramid = pyramid
        self.fwd = LstmParams(d_in, d_hid)
        self.bwd = LstmParams(d_in, d_hid)

    def forward(self, x, lens, dtype=torch.float32, impl: str = "torch"):
        return bilstm_layer(x, lens, self.fwd.tup(), self.bwd.tup(),
                            dtype=dtype, impl=impl)


class BiLstmEncoder(nn.Module):
    """Stacked bidirectional LSTM encoder (rung 1): (B, T, 2H) float32."""

    def __init__(self, d_in: int, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        H = cfg.encoder_dim
        dims = [d_in] + [2 * H] * (cfg.encoder_layers - 1)
        self.layers = nn.ModuleList([BiLstmLayer(d, H) for d in dims])
        self.d_out = 2 * H

    def forward(self, x, lens, train: bool = False,
                generator: torch.Generator | None = None):
        x = masked(x, length_mask(lens, x.shape[1])[..., None])
        for layer in self.layers:
            x = layer(x, lens, _dt(self.cfg), self.cfg.lstm_impl)
            x = dropout(x, self.cfg.encoder_dropout, generator, train)
        return x, lens


class VggExtractor(nn.Module):
    """VGG-style 2 x (conv3x3, conv3x3, pool2) over (time, mel): (B, T, F)
    -> (B, T//4, (F//4) * 128) float32, floor pools, the lengths halved
    twice, padding frames re-masked after every convolution."""

    def __init__(self, n_mels: int, cfg: ModelConfig):
        super().__init__()
        self.conv1a = nn.Conv2d(1, 64, 3)
        self.conv1b = nn.Conv2d(64, 64, 3)
        self.conv2a = nn.Conv2d(64, 128, 3)
        self.conv2b = nn.Conv2d(128, 128, 3)
        self.d_out = (n_mels // 4) * 128
        self.dt = _dt(cfg)

    def _conv(self, h: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
        return F.relu(F.conv2d(h.to(self.dt), conv.weight.to(self.dt),
                               conv.bias.to(self.dt), padding=1))

    def forward(self, x: torch.Tensor, lens: torch.Tensor):
        with span("asr.subsample"):
            def mask4(h, l):
                return masked(h,
                               length_mask(l, h.shape[2])[:, None, :, None])

            h = mask4(x[:, None], lens)                  # (B, 1, T, F)
            h = mask4(self._conv(h, self.conv1a), lens)
            h = mask4(self._conv(h, self.conv1b), lens)
            lens = lens // 2
            h = mask4(F.max_pool2d(h, 2), lens)
            h = mask4(self._conv(h, self.conv2a), lens)
            h = mask4(self._conv(h, self.conv2b), lens)
            lens = lens // 2
            h = mask4(F.max_pool2d(h, 2), lens)
            B, C, T, Fo = h.shape
            # Flax is NHWC and flattens (F, C) with C fastest
            return h.permute(0, 2, 3, 1).reshape(B, T, Fo * C).float(), lens


class PyramidalBiLstmEncoder(nn.Module):
    """LAS-style pBLSTM (rung 2): layer i, 0 < i <= pyramid_layers,
    concatenates adjacent frames first (an odd last frame dropped), halving
    time and the lengths; optional VGG front."""

    def __init__(self, d_in: int, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        H = cfg.encoder_dim
        self.vgg = VggExtractor(d_in, cfg) if cfg.vgg_frontend else None
        d = self.vgg.d_out if self.vgg is not None else d_in
        layers = []
        for i in range(cfg.encoder_layers):
            pyramid = 0 < i <= cfg.pyramid_layers
            if pyramid:
                d = 2 * d
            layers.append(BiLstmLayer(d, H, pyramid=pyramid))
            d = 2 * H
        self.layers = nn.ModuleList(layers)
        self.d_out = 2 * H

    def forward(self, x, lens, train: bool = False,
                generator: torch.Generator | None = None):
        x = masked(x, length_mask(lens, x.shape[1])[..., None])
        if self.vgg is not None:
            x, lens = self.vgg(x, lens)
        for layer in self.layers:
            if layer.pyramid:
                B, T, D = x.shape
                x = x[:, :T - T % 2].reshape(B, T // 2, 2 * D)
                lens = lens // 2
            x = layer(x, lens, _dt(self.cfg), self.cfg.lstm_impl)
            x = dropout(x, self.cfg.encoder_dropout, generator, train)
        # a pyramid pair that straddles a row's end is half valid: re-mask
        return masked(x, length_mask(lens, x.shape[1])[..., None]), lens


class ConvSubsample(nn.Module):
    """2-layer stride-2 conv2d subsampling (x4) over (time, mel). Recording
    no gradient at dtype bfloat16 (serving), both convolutions run as the
    operator `asr_port::subsample` (`ops/subsample_kernel.py`: one kernel on
    the card); otherwise as its plain version, under autograd."""

    def __init__(self, n_mels: int, d_model: int, cfg: ModelConfig):
        super().__init__()
        C = cfg.subsample_channels or d_model
        self.conv1 = nn.Conv2d(1, C, 3, stride=2)
        self.conv2 = nn.Conv2d(C, C, 3, stride=2)
        f_out = ((n_mels + 1) // 2 + 1) // 2
        self.proj = nn.Linear(f_out * C, d_model)
        self.dt, self.rdt = _dt(cfg), _rdt(cfg)

    def forward(self, x: torch.Tensor, lens: torch.Tensor):
        with span("asr.subsample"):
            w = (self.conv1.weight.to(self.dt), self.conv1.bias.to(self.dt),
                 self.conv2.weight.to(self.dt), self.conv2.bias.to(self.dt))
            if torch.is_grad_enabled() or self.dt != torch.bfloat16:
                h = subsample_plain(x, lens, *w)
            else:
                h = subsample(x, lens, *w)
            lens = ((lens + 1) // 2 + 1) // 2
            return _linear(h, self.proj, self.dt).to(self.rdt), lens


def sinusoidal_pe(T: int, D: int) -> np.ndarray:
    pos = np.arange(T)[:, None]
    i = np.arange(D // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / D)
    pe = np.zeros((T, D), np.float32)
    pe[:, 0::2] = np.sin(angle)
    pe[:, 1::2] = np.cos(angle)
    return pe


_PE_TABLES: dict = {}


def pe_table(T: int, D: int, device) -> torch.Tensor:
    """`sinusoidal_pe(T, D)` as a float32 tensor on `device`: the first T
    rows of a table kept per (D, device) and rebuilt only when a longer one
    is asked for (a row depends on its position alone), so the decoders'
    token steps copy nothing from the host once `init_state` has built
    it."""
    key = (D, torch.device(device))
    table = _PE_TABLES.get(key)
    if table is None or table.shape[0] < T:
        with torch.inference_mode(False):
            table = torch.from_numpy(sinusoidal_pe(T, D)).to(device)
        _PE_TABLES[key] = table
    return table[:T]


class RelPosBias(nn.Module):
    """Bucketed relative position bias: a learned (layers, heads, n_buckets)
    table. The 2T-1 relative offsets are bucketed (a small gather) into
    diagonals (`diags`), which the flash path takes as they are, or which
    are expanded into a dense (H, T, T) Toeplitz block for every layer at
    once. Gradients flow back through the bucket gather into the table.
    """

    tp_group = None  # set under tensor parallelism: this rank's heads

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

    def diags(self, T: int, dtype=torch.float32,
              whole: bool = False) -> torch.Tensor:
        """(L, H, 2T-1) diagonal vectors: diag[..., (T-1) + r] is the bias
        of relative offset r = j - i; under tensor parallelism, this rank's
        H/tp heads, unless `whole` (context parallelism attends over every
        head on every rank)."""
        rel = torch.arange(-(T - 1), T, device=self.table.device)
        table = self.table if whole else _part(self.table, self.tp_group, 1)
        return table[:, :, self._bucket(rel)].to(dtype)

    def forward(self, T: int, dtype=torch.float32, pad_to: int | None = None,
                impl: str = "torch") -> torch.Tensor:
        """(L, H, P, P) biases for all layers (this rank's heads under
        tensor parallelism), P = pad_to or T. With impl='cuda' the Toeplitz
        kernel expands every layer in one launch, padded to `pad_to` (edge
        values in the pad band)."""
        diag = self.diags(T)
        L, H, _ = diag.shape
        diag = diag.reshape(L * H, 2 * T - 1)
        P = pad_to or T
        if impl == "cuda":
            dense = toeplitz_dense(diag.contiguous(), T, P, dtype)
        else:
            dense = toeplitz_expand(diag, P, P, T=T).to(dtype)
        return dense.reshape(L, H, P, P)


def _rel_bias_repr(rel: RelPosBias | None, cfg: ModelConfig, T: int):
    """(biases, diags), at most one of them set: dense stacked (L, H, P, P)
    biases in `cfg.dtype` (P = T, or T padded to a 128 multiple on the
    kernel path), or the float32 diagonals (L, H, 2T-1) for the flash path;
    (None, None) without a relative bias. Under tensor parallelism
    (`rel.tp_group`) H is this rank's heads; the choice stays on the
    global H, so that one config takes one path on any mesh.

    The rule is the JAX package's `_rel_bias_repr`, formula and itemsize
    included, kept so that one config takes one path in both packages: its
    15 MiB is the TPU whole-row kernel's VMEM budget, not a statement about
    the H100's memory. Any `cp_mode` takes the diagonals too, of every
    head (context parallelism attends over all of them on every rank)."""
    if rel is None:
        return None, None
    Tp = -(-T // 128) * 128
    H, D = cfg.encoder_heads, cfg.encoder_dim
    itemsize = 2 if cfg.dtype == "bfloat16" else 4
    dense_vmem = (H * Tp * Tp + 4 * Tp * D) * itemsize + Tp * Tp * 4
    if cfg.cp_mode or T > FLASH_T or dense_vmem > 15 * 1024 * 1024:
        return None, rel.diags(T, whole=bool(cfg.cp_mode))
    return _dense_biases(rel, cfg, T), None


def _dense_biases(rel: RelPosBias, cfg: ModelConfig, T: int) -> torch.Tensor:
    """The stacked dense biases in `cfg.dtype`: padded to a 128 multiple by
    the Toeplitz kernel on the kernel path, else (L, H, T, T)."""
    if cfg.attn_impl == "cuda":
        return rel(T, dtype=_dt(cfg), pad_to=-(-T // 128) * 128, impl="cuda")
    return rel(T, dtype=_dt(cfg))


class MhsaBlock(nn.Module):
    """Pre-LN multi-head self-attention with key padding mask and an
    optional per-head additive bias. The attention runs through
    `sharded_fused_attention`: under tensor parallelism on this rank's
    heads alone, with no collective, on the dense and the flash path. With
    `cp_mode` and a 'model' group it runs context-parallel instead
    (`sharded_self_attention` in float32, the JAX package's CP path): the
    column-parallel projections' heads are gathered, the attention splits
    the time axis over the group, and each rank keeps its heads' columns
    of the result for the row-parallel `o`."""

    tp_group = None

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
        self.cp_mode = cfg.cp_mode
        self.rate = cfg.encoder_dropout
        self.dt, self.rdt = _dt(cfg), _rdt(cfg)

    def forward(self, x, mask, bias=None, diag=None, train=False, gen=None,
                sp=False):
        """x + dropout(`branch`): the residual sub-layer, in `asr.mhsa`."""
        with span("asr.mhsa"):
            y = self.branch(x, mask, bias, diag, sp)
            return x + dropout(y, self.rate, gen, train,
                               self.tp_group if sp else None)

    def branch(self, x, mask, bias=None, diag=None, sp=False):
        """o(attention(q, k, v)) of LN(x) in the residual dtype, without the
        dropout and the residual (E-Branchformer's global branch); opens no
        span, its caller's holds it. `bias`: this block's (H, P, P) slice of
        the stacked dense biases; `diag`: its (H, 2T-1) float32 diagonals on
        the flash and CP paths (this rank's heads under tensor parallelism,
        every head under CP); `sp`: x is this rank's time slice (mask stays
        whole)."""
        g = self.tp_group
        h = _enter(_layer_norm(x, self.ln, g if sp else None).to(self.dt),
                   g, sp)
        qf = _col(h, self.q, self.dt, g)
        kf = _col(h, self.k, self.dt, g)
        vf = _col(h, self.v, self.dt, g)
        lens = mask.sum(dim=1).to(torch.int32)
        if self.cp_mode and g is not None:
            B, T = mask.shape
            q, k, v = (gather_features(t, g).float().reshape(
                B, T, self.heads, -1) for t in (qf, kf, vf))
            y = split_features(sharded_self_attention(
                g, q, k, v, lens, self.cp_mode, diag).reshape(B, T, -1), g)
        else:
            y = sharded_fused_attention(size(g), qf, kf, vf, bias, lens,
                                        self.heads, diag=diag,
                                        plain=self.attn_impl != "cuda")
        return _row(y, self.o, self.dt, g, sp).to(self.rdt)


def ffn_fused(cfg: ModelConfig, mesh=None) -> bool:
    """The JAX package's gate of its fused FFN (`models/encoders.py:
    503-507`): the kernel impl, no mesh with a 'data' or 'model' axis > 1,
    no sequence or pipeline parallelism, and `fits_vmem(D, F)`."""
    sharded = mesh is not None and mesh.sharded
    return (cfg.ffn_impl == "cuda" and not sharded and not cfg.sp
            and cfg.pp_stages == 1
            and fits_vmem(cfg.encoder_dim, cfg.encoder_ffn_dim))


class FfnBlock(nn.Module):
    """Pre-LN FFN: x + scale * dropout(fc2(silu(fc1(LN(x))))).

    With `ffn_impl='cuda'` it takes the fused FFN kernels where the JAX
    package's gate takes its Pallas kernel (`ffn_fused`: no mesh with an
    axis > 1, no sequence or pipeline parallelism, `fits_vmem(D, F)`).
    Elsewhere (rung 4 and 5's widths) it runs plain torch, as the JAX
    package runs XLA there. On the kernel path the weights are cast to
    `cfg.dtype` first, as the JAX model casts them, so their gradients are
    rounded where the JAX package's are; the kernels raise on what they do
    not take (float32 weights on the card), there is no fallback."""

    tp_group = None

    def __init__(self, cfg: ModelConfig, scale: float = 1.0):
        super().__init__()
        D = cfg.encoder_dim
        self.cfg = cfg
        self.scale = scale
        self.ln = nn.LayerNorm(D, eps=LN_EPS)
        self.fc1 = nn.Linear(D, cfg.encoder_ffn_dim)
        self.fc2 = nn.Linear(cfg.encoder_ffn_dim, D)
        self.rate = cfg.encoder_dropout
        self.dt, self.rdt = _dt(cfg), _rdt(cfg)
        self.fused = ffn_fused(cfg)

    def set_mesh(self, mesh) -> None:
        """Apply the gate's mesh term (`shard_model` calls it)."""
        self.fused = ffn_fused(self.cfg, mesh)

    def forward(self, x, train=False, gen=None, sp=False):
        with span("asr.ffn"):
            if self.fused:
                dt = self.dt
                return ffn_block_fused(
                    x, self.ln.weight, self.ln.bias, self.fc1.weight.to(dt),
                    self.fc1.bias.to(dt), self.fc2.weight.to(dt),
                    self.fc2.bias.to(dt), rate=self.rate, scale=self.scale,
                    train=train, generator=gen)
            g = self.tp_group
            h = _enter(_layer_norm(x, self.ln, g if sp else None).to(self.dt),
                       g, sp)
            h = _row(F.silu(_col(h, self.fc1, self.dt, g)), self.fc2,
                     self.dt, g, sp).to(self.rdt)
            return x + self.scale * dropout(h, self.rate, gen, train,
                                            g if sp else None)


class ConvModule(nn.Module):
    """Conformer convolution module: pointwise-GLU -> depthwise -> LN -> pw.
    Under tensor parallelism a rank holds D/tp of the channels from pw1's
    GLU to pw2; the channel LayerNorm sums its mean and variance over the
    'model' group (`_channel_ln`), the JAX package's numbers."""

    tp_group = None

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

    def forward(self, x, mask, train=False, gen=None, sp=False):
        with span("asr.conv"):
            g = self.tp_group
            h = _enter(_layer_norm(x, self.ln, g if sp else None).to(self.dt),
                       g, sp)
            h = F.glu(_col(h, self.pw1, self.dt, g, glu=True), dim=-1)
            # the depthwise conv must not see pad
            h = _depthwise(masked(h, mask[..., None]),
                           _part(self.dw.weight, g).to(self.dt),
                           _part(self.dw.bias, g).to(self.dt))
            h = F.silu(_channel_ln(h, self.norm, g))
            h = _row(h, self.pw2, self.dt, g, sp).to(self.rdt)
            return x + dropout(h, self.rate, gen, train, g if sp else None)


def _depthwise(h: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """A depthwise convolution over time of h (B, T, C) with `weight`
    (C, 1, K): zero 'same' padding, (K - 1) // 2 frames before."""
    K = weight.shape[-1]
    h = F.pad(h.transpose(1, 2), ((K - 1) // 2, K - 1 - (K - 1) // 2))
    return F.conv1d(h, weight, bias, groups=h.shape[1]).transpose(1, 2)


def _channel_ln(h: torch.Tensor, ln: nn.LayerNorm, group) -> torch.Tensor:
    """LayerNorm over channels that `group` splits: the sum, then the
    centred sum of squares, each summed over the shards (two passes, as
    `F.layer_norm` computes them), in float32; `_layer_norm` without a
    group."""
    if group is None:
        return _layer_norm(h, ln)
    x = h.float()
    D = ln.normalized_shape[0]
    xc = x - sum_both(x.sum(-1, keepdim=True), group) / D
    var = sum_both((xc * xc).sum(-1, keepdim=True), group) / D
    return (xc * torch.rsqrt(var + LN_EPS) * _part(ln.weight, group)
            + _part(ln.bias, group))


class ConformerBlock(nn.Module):
    tp_group = None

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.ff1 = FfnBlock(cfg, scale=0.5)
        self.mhsa = MhsaBlock(cfg)
        self.conv = ConvModule(cfg)
        self.ff2 = FfnBlock(cfg, scale=0.5)
        self.ln = nn.LayerNorm(cfg.encoder_dim, eps=LN_EPS)

    def forward(self, x, mask, bias=None, diag=None, train=False, gen=None,
                sp=False):
        with span("asr.block"):
            x = self.ff1(x, train, gen, sp)
            x = self.mhsa(x, mask, bias, diag, train, gen, sp)
            x = self.conv(x, mask, train, gen, sp)
            x = self.ff2(x, train, gen, sp)
            # keep the residual dtype
            return _layer_norm(x, self.ln, self.tp_group if sp else None).to(
                x.dtype)


class TransformerBlock(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.mhsa = MhsaBlock(cfg)
        self.ffn = FfnBlock(cfg)

    def forward(self, x, mask, bias=None, diag=None, train=False, gen=None,
                sp=False):
        with span("asr.block"):
            return self.ffn(self.mhsa(x, mask, bias, diag, train, gen, sp),
                            train, gen, sp)


class CgmlpBranch(nn.Module):
    """E-Branchformer's local branch, the convolutional gating MLP (ESPnet's
    `ConvolutionalGatingMLP` with an identity gate and no linear after the
    gating convolution): (r, z) = the halves of GELU(fc1(LN(x))), then
    dropout(fc2(r * dw(norm(z)))), dw a depthwise convolution over time on
    the gate half. The pad frames are zeroed before it, as in `ConvModule`
    (ESPnet convolves them as they are), so that a row's output does not
    depend on its batch's padding."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        D, U = cfg.encoder_dim, cfg.cgmlp_units
        self.ln = nn.LayerNorm(D, eps=LN_EPS)
        self.fc1 = nn.Linear(D, U)
        self.norm = nn.LayerNorm(U // 2, eps=LN_EPS)
        self.dw = nn.Conv1d(U // 2, U // 2, cfg.cgmlp_kernel, groups=U // 2)
        self.fc2 = nn.Linear(U // 2, D)
        self.rate = cfg.encoder_dropout
        self.dt, self.rdt = _dt(cfg), _rdt(cfg)

    def forward(self, x, mask, train=False, gen=None):
        with span("asr.cgmlp"):
            h = F.gelu(_linear(_layer_norm(x, self.ln), self.fc1, self.dt))
            r, z = h.chunk(2, dim=-1)
            z = masked(_layer_norm(z, self.norm).to(self.dt), mask[..., None])
            z = _depthwise(z, self.dw.weight.to(self.dt),
                           self.dw.bias.to(self.dt))
            y = _linear(r * z, self.fc2, self.dt).to(self.rdt)
            return dropout(y, self.rate, gen, train)


class MergeBlock(nn.Module):
    """E-Branchformer's merge: m = [a, c] (the two branches' outputs side by
    side), x + dropout(proj(m + dw(m))), dw a depthwise convolution over
    time on the 2D channels, its input's pad frames zeroed (as in
    `CgmlpBranch`)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        D2 = 2 * cfg.encoder_dim
        self.dw = nn.Conv1d(D2, D2, cfg.merge_kernel, groups=D2)
        self.proj = nn.Linear(D2, cfg.encoder_dim)
        self.rate = cfg.encoder_dropout
        self.dt, self.rdt = _dt(cfg), _rdt(cfg)

    def forward(self, x, a, c, mask, train=False, gen=None):
        with span("asr.merge"):
            m = torch.cat([a, c], dim=-1).to(self.dt)
            y = m + _depthwise(masked(m, mask[..., None]),
                               self.dw.weight.to(self.dt),
                               self.dw.bias.to(self.dt))
            y = _linear(y, self.proj, self.dt).to(self.rdt)
            return x + dropout(y, self.rate, gen, train)


class EBranchformerBlock(nn.Module):
    """An E-Branchformer layer (Kim et al. 2022; ESPnet's
    `EBranchformerEncoderLayer`, pre-LN): the macaron FFN's half step; the
    attention branch (`MhsaBlock.branch`: its own layer norm, no residual)
    and the cgMLP branch side by side on that x; their merge, added to x;
    the second FFN half step; the block's layer norm. Dropout draws from
    `gen` in this order, each (B, T, D): ff1's output, the attention
    branch, the cgMLP branch, the merge's output, ff2's output."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.ff1 = FfnBlock(cfg, scale=0.5)
        self.mhsa = MhsaBlock(cfg)
        self.cgmlp = CgmlpBranch(cfg)
        self.merge = MergeBlock(cfg)
        self.ff2 = FfnBlock(cfg, scale=0.5)
        self.ln = nn.LayerNorm(cfg.encoder_dim, eps=LN_EPS)

    def forward(self, x, mask, bias=None, diag=None, train=False, gen=None,
                sp=False):
        with span("asr.block"):
            x = self.ff1(x, train, gen)
            with span("asr.mhsa"):
                a = dropout(self.mhsa.branch(x, mask, bias, diag),
                            self.mhsa.rate, gen, train)
            c = self.cgmlp(x, mask, train, gen)
            x = self.merge(x, a, c, mask, train, gen)
            x = self.ff2(x, train, gen)
            return _layer_norm(x, self.ln).to(x.dtype)


def sp_enabled(cfg: ModelConfig, group, T: int) -> bool:
    """Whether the residual stream runs time-split over the 'model' group
    (the JAX package's `sp_constrain` test): `model.sp`, a group, and T a
    multiple of its size; a no-op otherwise, and under `cp_mode` (which
    lays the time axis out itself)."""
    return (cfg.sp and not cfg.cp_mode and group is not None
            and T % size(group) == 0)


class _BlockEncoder(nn.Module):
    """The conv-subsampled block stacks (the JAX package's Transformer and
    Conformer encoders): subsampling, the relative-bias table when
    `pos_encoding='relative'`, `cfg.encoder_layers` blocks of `block`."""

    tp_group = None
    mesh = None  # set by `shard_model`: the pipeline runs over its 'model'

    def __init__(self, d_in: int, cfg: ModelConfig, block):
        super().__init__()
        self.cfg = cfg
        self.sub = ConvSubsample(d_in, cfg.encoder_dim, cfg)
        self.rel = (RelPosBias(cfg.encoder_layers, cfg.encoder_heads)
                    if cfg.pos_encoding == "relative" else None)
        self.blocks = nn.ModuleList(
            [block(cfg) for _ in range(cfg.encoder_layers)])
        self.rate = cfg.encoder_dropout
        self.d_out = cfg.encoder_dim

    def set_mesh(self, mesh) -> None:
        self.mesh = mesh

    def _apply_blocks(self, x, mask, train, generator):
        """The blocks in order, each with its layer's slice of the relative
        bias (dense, or the diagonals past FLASH_T or under `cp_mode`; none
        for absolute PE), the residual stream split along time between them
        under sequence parallelism; with `pp_stages > 1` on a mesh, the
        GPipe pipeline over its 'model' group (dense biases, no dropout,
        no remat: the JAX package's pipeline path)."""
        g = self.tp_group
        T = mask.shape[1]
        cfg = self.cfg
        if cfg.pp_stages > 1 and self.mesh is not None:
            if self.mesh.tp != cfg.pp_stages:
                raise ValueError(
                    f"pp_stages={cfg.pp_stages} must equal the 'model' mesh "
                    f"axis size {self.mesh.tp} (set train.tp=pp_stages)")
            with span("asr.rel_bias"):
                biases = (None if self.rel is None
                          else _dense_biases(self.rel, cfg, T))
            return pipeline_blocks(self.mesh.model_group, list(self.blocks),
                                   x, mask, cfg.pp_microbatches, biases)
        with span("asr.rel_bias"):
            biases, diags = _rel_bias_repr(self.rel, cfg, T)
            # unbind: one stacked gradient for all layers in the backward
            none = [None] * len(self.blocks)
            biases = biases.unbind(0) if biases is not None else none
            diags = diags.unbind(0) if diags is not None else none
        remat = self.cfg.remat and train
        sp = sp_enabled(self.cfg, g, T)
        if sp:
            x = split_time(x, g)
        for blk, bias, diag in zip(self.blocks, biases, diags):
            if remat:
                x = _remat_block(blk, x, mask, bias, diag, generator, sp)
            else:
                x = blk(x, mask, bias, diag, train, generator, sp)
        return gather_time_replicated(x, g) if sp else x


def _remat_block(blk, x, mask, bias, diag, generator, sp=False):
    """One training block under `torch.utils.checkpoint` (the JAX package's
    `jax.checkpoint` of `_apply_blocks`): its activations are recomputed in
    the backward. Checkpoint restores only the default generators, and the
    block's dropout masks and FFN kernel seed come from `generator`; so the
    recompute starts from the generator's state at the block's forward and
    draws the same numbers, and the generator is then put back where the
    recompute found it."""
    state = generator.get_state() if generator is not None else None
    calls = [0]

    def run(x, bias, diag):
        calls[0] += 1
        if calls[0] == 1 or generator is None:
            return blk(x, mask, bias, diag, True, generator, sp)
        after = generator.get_state()
        generator.set_state(state)
        try:
            return blk(x, mask, bias, diag, True, generator, sp)
        finally:
            generator.set_state(after)

    return checkpoint(run, x, bias, diag, use_reentrant=False)


class TransformerEncoder(_BlockEncoder):
    """Conv-subsampled Transformer encoder (rung 3): (MHSA, FFN) blocks,
    sinusoidal PE added after the subsampling when `pos_encoding` is
    'absolute', a final LayerNorm; (B, T', D) float32."""

    block = TransformerBlock

    def __init__(self, d_in: int, cfg: ModelConfig):
        super().__init__(d_in, cfg, self.block)
        self.ln_out = nn.LayerNorm(cfg.encoder_dim, eps=LN_EPS)

    def _positions(self, x):
        """x, the subsampled frames, with the sinusoidal table added
        under absolute PE."""
        if self.rel is None:
            pe = torch.from_numpy(sinusoidal_pe(x.shape[1], x.shape[2]))
            x = x + pe.to(x.device, x.dtype)
        return x

    def forward(self, x, lens, train: bool = False,
                generator: torch.Generator | None = None):
        x = masked(x, length_mask(lens, x.shape[1])[..., None])
        x, lens = self.sub(x, lens)
        T = x.shape[1]
        x = dropout(self._positions(x), self.rate, generator, train)
        mask = length_mask(lens, T)
        x = _layer_norm(self._apply_blocks(x, mask, train, generator),
                        self.ln_out)
        return masked(x, mask[..., None]), lens


class ConformerEncoder(_BlockEncoder):
    def __init__(self, d_in: int, cfg: ModelConfig):
        super().__init__(d_in, cfg, ConformerBlock)

    def forward(self, x, lens, train: bool = False,
                generator: torch.Generator | None = None):
        x = masked(x, length_mask(lens, x.shape[1])[..., None])
        x, lens = self.sub(x, lens)
        x = dropout(x, self.rate, generator, train)
        mask = length_mask(lens, x.shape[1])
        x = self._apply_blocks(x, mask, train, generator)
        return masked(x, mask[..., None]), lens


class EBranchformerEncoder(TransformerEncoder):
    """Conv-subsampled E-Branchformer encoder: `TransformerEncoder`'s stack
    of E-Branchformer blocks, with ESPnet's absolute positions (x * sqrt(D)
    + the sinusoidal table). One card, no mesh split: `pos_encoding` other
    than 'absolute', `cp_mode`, `pp_stages > 1` and `sp` raise here, tensor
    parallelism in `shard_model`, streaming and export where they start."""

    block = EBranchformerBlock

    def __init__(self, d_in: int, cfg: ModelConfig):
        for name, on in (("pos_encoding", cfg.pos_encoding != "absolute"),
                         ("cp_mode", bool(cfg.cp_mode)),
                         ("pp_stages", cfg.pp_stages > 1), ("sp", cfg.sp)):
            if on:
                raise ValueError(f"the e_branchformer encoder does not run "
                                 f"model.{name}={getattr(cfg, name)!r}")
        super().__init__(d_in, cfg)

    def _positions(self, x):
        T, D = x.shape[1], x.shape[2]
        return x * D ** 0.5 + pe_table(T, D, x.device).to(x.dtype)


def build_encoder(d_in: int, cfg: ModelConfig) -> nn.Module:
    """The encoder of `cfg.encoder` (`shard_model` shards it for a
    mesh)."""
    if cfg.encoder == "blstm":
        return BiLstmEncoder(d_in, cfg)
    if cfg.encoder == "pblstm":
        return PyramidalBiLstmEncoder(d_in, cfg)
    if cfg.encoder == "conformer":
        return ConformerEncoder(d_in, cfg)
    if cfg.encoder == "transformer":
        return TransformerEncoder(d_in, cfg)
    if cfg.encoder == "e_branchformer":
        return EBranchformerEncoder(d_in, cfg)
    raise ValueError(f"unknown encoder kind {cfg.encoder}")
