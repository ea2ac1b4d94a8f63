"""Typed dataclass config system (the port's own copy).

Nested dataclasses with data/model/optim/decode sections, a JSON round-trip
and dotted-path overrides (`--set model.encoder=conformer --set
train.lr=1e-3`). The fields and their defaults are the JAX package's, so one
config describes the same model in both packages; only the implementation
fields take the port's values (`auto | torch | cuda`), and `resolve_device`
maps `auto` to concrete values for a torch device.

The E-Branchformer encoder (`model.encoder='e_branchformer'`) and its
branch widths (`cgmlp_units`, `cgmlp_kernel`, `merge_kernel`) are the
port's own: the first model fields the JAX package does not have. A config
that sets them describes a model only the port runs; every other config
leaves them at their defaults and round-trips between the packages as
before.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass
class FrontendConfig:
    sample_rate: int = 16000
    win_ms: float = 25.0
    hop_ms: float = 10.0
    n_fft: int = 512
    n_mels: int = 80
    fmin: float = 0.0
    fmax: float | None = None  # None -> sample_rate / 2
    preemphasis: float = 0.97
    # normalization: 'utt' per-utterance CMVN, 'global' dataset stats, 'none'
    cmvn: str = "utt"
    cmvn_stats_path: str = ""        # JSON {mean: [n_mels], std: [n_mels]}
    # SpecAugment (train only)
    spec_augment: bool = True
    time_warp_param: int = 0       # W; 0 disables (genre default)
    freq_mask_param: int = 27
    n_freq_masks: int = 2
    time_mask_param: int = 100
    n_time_masks: int = 2
    time_mask_ratio: float = 0.05  # cap time mask width at ratio * T
    # implementation: 'auto' (cuda on a CUDA device, torch elsewhere —
    # resolved by resolve_device at model build), 'torch' (plain PyTorch)
    # or 'cuda' (the hand-written log-mel kernel)
    impl: str = "auto"
    # DFT operand dtype: 'auto' (bf16 on CUDA, f32 elsewhere) | 'float32' |
    # 'bfloat16' (audio samples and basis rounded to bf16; accumulation
    # stays f32)
    dft_dtype: str = "auto"

    @property
    def win_length(self) -> int:
        return int(round(self.sample_rate * self.win_ms / 1000.0))

    @property
    def hop_length(self) -> int:
        return int(round(self.sample_rate * self.hop_ms / 1000.0))


@dataclass
class ModelConfig:
    # encoder: 'blstm' | 'pblstm' | 'transformer' | 'conformer' |
    # 'e_branchformer' (the port's own, see the module docstring)
    encoder: str = "blstm"
    encoder_layers: int = 2
    encoder_dim: int = 320          # per-direction LSTM hidden / transformer d_model
    encoder_ffn_dim: int = 1280
    encoder_heads: int = 4
    encoder_dropout: float = 0.1
    # pBLSTM: number of pyramid (2x time-downsample) layers among encoder_layers
    pyramid_layers: int = 3
    vgg_frontend: bool = False       # conv2d feature extractor before RNN stack
    conv_subsample: int = 4          # transformer/conformer conv2d subsampling factor
    # channels of the 2-layer subsampling convs; 0 -> encoder_dim. The 2nd
    # conv's FLOPs scale with channels^2 and at channels=encoder_dim it can
    # rival a whole conformer layer; 64 is the production sweet spot (NeMo
    # conformer's subsampling_conv_channels) with negligible WER effect.
    subsample_channels: int = 0
    conformer_kernel: int = 15
    pos_encoding: str = "relative"   # 'relative' | 'absolute' for transformer/conformer
    # E-Branchformer branches (port only): the cgMLP's first linear width
    # (split into its two gate halves), the depthwise kernel on the gate
    # half, and the merge's depthwise kernel over both branches' channels;
    # the units ESPnet's default, the kernels those of OWSM v3.1
    cgmlp_units: int = 2048
    cgmlp_kernel: int = 31
    merge_kernel: int = 31
    # decoder: 'lstm' (location-aware attention speller) | 'transformer'
    decoder: str = "lstm"
    decoder_layers: int = 1
    decoder_dim: int = 320
    decoder_heads: int = 4           # transformer decoder only
    decoder_ffn_dim: int = 0         # transformer decoder FFN; 0 -> 4*decoder_dim
    embed_dim: int = 320
    attention_dim: int = 320
    location_kernel: int = 31        # location-aware attention conv kernel
    location_filters: int = 32
    decoder_dropout: float = 0.1
    # heads
    vocab_size: int = 32             # set from tokenizer at build time
    ctc_weight: float = 0.3          # lambda in L = l*CTC + (1-l)*CE; 1.0 -> pure CTC
    label_smoothing: float = 0.1
    # LM: 'lstm' (genre RNN-LM) | 'transformer'
    lm_type: str = "lstm"
    lm_layers: int = 2
    lm_dim: int = 650
    lm_embed_dim: int = 256
    lm_heads: int = 4                # transformer LM only
    lm_ffn_dim: int = 0              # transformer LM FFN; 0 -> 4*lm_dim
    # numerics. 'auto' fields resolve per device at model build
    # (resolve_device): bfloat16 + hand-written kernels on CUDA, float32 +
    # plain torch on CPU; `--set` of a concrete value is the opt-out.
    dtype: str = "auto"              # matmul compute dtype
    param_dtype: str = "float32"
    # encoder residual-stream dtype: float32 is the conservative choice;
    # bfloat16 halves the memory traffic between matmuls and is the
    # accelerator default
    residual_dtype: str = "auto"
    # kernel implementations: 'auto' | 'torch' | 'cuda'
    ctc_impl: str = "auto"
    lstm_impl: str = "auto"
    attn_impl: str = "auto"          # encoder self-attention (fused kernel)
    # fused LN+fc1+SiLU+dropout+fc2+residual FFN block (the kernels of
    # ops/ffn_kernel.py): opt-in, 'auto' resolves to 'torch' on every
    # device, as the JAX package's resolves to 'xla'
    ffn_impl: str = "auto"
    remat: bool = False              # checkpoint encoder blocks in training
    # context parallelism for encoder self-attention over the 'model' axis:
    # '' (off) | 'ring' | 'ulysses'; composes with either pos_encoding
    # (relative bias travels as Toeplitz diagonals, expanded per time shard)
    cp_mode: str = ""
    # pipeline parallelism: stage the encoder blocks over the 'model' mesh
    # axis (GPipe microbatching, parallel/pp.py). pp_stages must equal
    # cfg.train.tp (the stages live on the model axis, replacing TP there);
    # batch must divide pp_microbatches. 1 = off.
    pp_stages: int = 1
    pp_microbatches: int = 4
    # Megatron-style sequence parallelism (SURVEY.md §2c SP row): shard the
    # residual-stream time axis over the 'model' mesh axis between TP blocks
    # so norms/dropout/elementwise run on 1/tp of the activations; GSPMD
    # inserts the all-gather/reduce-scatter pairs at matmul boundaries.
    # Ignored under cp_mode / pp_stages>1 (those own the time axis layout).
    sp: bool = False


@dataclass
class DataConfig:
    train_manifest: str = ""
    dev_manifest: str = ""
    test_manifest: str = ""
    tokenizer: str = "char"          # 'char' | 'bpe'
    tokenizer_path: str = ""
    bpe_vocab_size: int = 256        # BPE target vocab (specials+chars+merges)
    batch_frames: int = 160000       # max total samples per batch (bucketing budget)
    batch_size: int = 16             # max utterances per batch
    max_audio_s: float = 30.0
    min_audio_s: float = 0.3
    max_label_len: int = 256
    # shape buckets: audio lengths padded up to one of N quantized shapes to
    # bound XLA recompiles (SURVEY.md §7 hard part (c))
    n_length_buckets: int = 8
    shuffle: bool = True
    seed: int = 0


@dataclass
class TrainConfig:
    steps: int = 10000
    eval_every: int = 1000
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3
    optimizer: str = "adamw"         # 'adamw' | 'adadelta'
    lr: float = 1e-3
    schedule: str = "noam"           # 'noam' | 'plateau' | 'constant' | 'cosine'
    warmup_steps: int = 4000
    plateau_patience: int = 3        # dev evals without improvement -> decay
    plateau_factor: float = 0.5      # host-driven LR multiplier on plateau
    weight_decay: float = 1e-6
    grad_clip: float = 5.0
    grad_accum_steps: int = 1        # micro-batches per optimizer update
    scheduled_sampling: float = 0.0  # prob of feeding model prediction in decoder
    seed: int = 0
    log_every: int = 50
    metrics_path: str = "metrics.jsonl"
    tensorboard_dir: str = ""        # optional tensorboard event dir
    # parallelism (SURVEY.md §2c): mesh axes sizes; products must divide devices
    dp: int = 1                      # data-parallel axis size ('data')
    tp: int = 1                      # tensor-parallel axis size ('model')
    donate: bool = True
    # PRNG implementation name, kept so configs round-trip between the two
    # packages; the port's training slices read it
    prng_impl: str = "rbg"


@dataclass
class DecodeConfig:
    mode: str = "greedy"             # 'greedy' | 'beam' | 'attention'
    beam_size: int = 10
    ctc_weight: float = 0.3          # decode-time joint weight
    lm_weight: float = 0.0           # RNN-LM shallow fusion gamma
    length_penalty: float = 0.0
    coverage_penalty: float = 0.0    # eta * sum(min(cum_attn, tau))
    coverage_tau: float = 0.5
    # Max output len = ratio * encoder frames. Char-level output runs at
    # ~12-15 chars/s vs ~25 encoder frames/s (x4 subsample of 100 fps), so
    # 0.5 truncates fast speech mid-word (r3 digits quality run: every fast
    # utterance's last word was cut). 1.0 is the safe genre default
    # (ESPnet maxlenratio<=1); the while_loop still exits early on EOS.
    max_decode_ratio: float = 1.0
    min_decode_ratio: float = 0.0
    nbest: int = 1
    pre_beam_k: int = 40             # candidates scored by CTC prefix scorer


@dataclass
class AsrConfig:
    name: str = "default"
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)

    # ---- serialization ----
    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), indent=2, **kw)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "AsrConfig":
        def build(tp, val):
            if dataclasses.is_dataclass(tp) and isinstance(val, dict):
                fields = {f.name: f for f in dataclasses.fields(tp)}
                kwargs = {}
                for k, v in val.items():
                    if k not in fields:
                        raise KeyError(f"unknown config key {tp.__name__}.{k}")
                    ftype = fields[k].type
                    sub = _DATACLASS_BY_NAME.get(str(ftype).split(".")[-1])
                    kwargs[k] = build(sub, v) if sub else v
                return tp(**kwargs)
            return val

        return build(cls, d)

    @classmethod
    def from_json(cls, s: str) -> "AsrConfig":
        return cls.from_dict(json.loads(s))

    def override(self, dotted: str, value: str) -> "AsrConfig":
        """Apply one `section.key=value` CLI override, parsing value by field type."""
        cfg = self
        parts = dotted.split(".")
        objs = [cfg]
        for p in parts[:-1]:
            objs.append(getattr(objs[-1], p))
        leaf, key = objs[-1], parts[-1]
        fields = {f.name: f for f in dataclasses.fields(leaf)}
        if key not in fields:
            raise KeyError(f"unknown config key {dotted}")
        cur = getattr(leaf, key)
        setattr(leaf, key, _parse_value(value, cur))
        return cfg


def _parse_value(s: str, current: Any) -> Any:
    if isinstance(current, bool):
        return s.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int) and not isinstance(current, bool):
        return int(s)
    if isinstance(current, float):
        return float(s)
    if current is None:
        try:
            return json.loads(s)
        except json.JSONDecodeError:
            return s
    return s


_DATACLASS_BY_NAME = {
    c.__name__: c
    for c in (FrontendConfig, ModelConfig, DataConfig, TrainConfig, DecodeConfig)
}


def parse_overrides(cfg: AsrConfig, pairs: list[str]) -> AsrConfig:
    """Apply a list of 'a.b=c' strings (argparse --set)."""
    for p in pairs:
        k, _, v = p.partition("=")
        cfg.override(k.strip(), v.strip())
    return cfg


def refuse_e_branchformer(model: ModelConfig, what: str) -> None:
    """Raise where `what`, a path the E-Branchformer encoder does not take
    (streaming, export, tensor parallelism), starts on such a model."""
    if model.encoder == "e_branchformer":
        raise ValueError(f"{what} does not run the e_branchformer encoder")


_IMPLS = ("auto", "torch", "cuda")


def resolve_device(cfg: AsrConfig, device) -> AsrConfig:
    """Return a COPY of `cfg` with every 'auto' implementation/dtype field
    resolved for `device` (a torch.device or its name); `cfg` is never
    touched.

    On CUDA: bfloat16 compute and residual stream, bfloat16 DFT operands,
    and the hand-written kernels for the frontend, the encoder attention,
    the LSTM recurrence and the CTC loss. On CPU: float32 and plain torch.
    `ffn_impl` 'auto' resolves to 'torch' on every device, as the JAX
    package's 'auto' resolves to 'xla': its fused FFN is opt-in there, so
    one config takes one path in both packages; `--set model.ffn_impl=cuda`
    asks for the fused FFN kernels. A concrete value is never overridden;
    'cuda' on a non-CUDA device raises.
    """
    import copy

    kind = device.type if hasattr(device, "type") else str(device).split(":")[0]
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    cuda = kind == "cuda"
    out = copy.deepcopy(cfg)
    fe, m = out.frontend, out.model
    if fe.impl == "auto":
        fe.impl = "cuda" if cuda else "torch"
    if fe.dft_dtype == "auto":
        fe.dft_dtype = "bfloat16" if cuda else "float32"
    if m.dtype == "auto":
        m.dtype = "bfloat16" if cuda else "float32"
    if m.residual_dtype == "auto":
        m.residual_dtype = "bfloat16" if cuda else "float32"
    for k in ("attn_impl", "ctc_impl", "lstm_impl"):
        if getattr(m, k) == "auto":
            setattr(m, k, "cuda" if cuda else "torch")
    if m.ffn_impl == "auto":
        m.ffn_impl = "torch"
    impls = {"frontend.impl": fe.impl, "model.attn_impl": m.attn_impl,
             "model.ctc_impl": m.ctc_impl, "model.lstm_impl": m.lstm_impl,
             "model.ffn_impl": m.ffn_impl}
    for name, val in impls.items():
        if val not in _IMPLS:
            raise ValueError(f"{name}={val!r}: expected one of {_IMPLS}")
        if val == "cuda" and not cuda:
            raise ValueError(f"{name}='cuda' needs a CUDA device, got {device!r}")
    return out
