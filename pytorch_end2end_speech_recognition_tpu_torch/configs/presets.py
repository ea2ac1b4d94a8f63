"""The five-config capability ladder (BASELINE.json:6-12, SURVEY.md §5.6).

One preset per rung; each returns a fresh AsrConfig. Manifest paths assume
`prep_*` scripts were run into ./data/<corpus>/ — adjust via --set.
"""

from __future__ import annotations

from pytorch_end2end_speech_recognition_tpu_torch.utils.config import AsrConfig


def an4_ctc() -> AsrConfig:
    """Rung 1: 2-layer BiLSTM + CTC greedy, AN4/digits, CPU-runnable."""
    cfg = AsrConfig(name="an4_ctc")
    cfg.model.encoder = "blstm"
    cfg.model.encoder_layers = 2
    cfg.model.encoder_dim = 256
    cfg.model.ctc_weight = 1.0
    cfg.frontend.spec_augment = False
    cfg.data.train_manifest = "data/an4/train.jsonl"
    cfg.data.dev_manifest = "data/an4/dev.jsonl"
    cfg.data.test_manifest = "data/an4/test.jsonl"
    cfg.data.tokenizer = "char"
    cfg.data.tokenizer_path = "data/an4/tokenizer.json"
    cfg.train.steps = 5000
    cfg.train.eval_every = 500
    cfg.train.lr = 1e-3
    cfg.train.schedule = "cosine"
    cfg.train.warmup_steps = 500
    cfg.decode.mode = "greedy"
    return cfg


def wsj_las() -> AsrConfig:
    """Rung 2: pBLSTM (LAS) + location-aware attention decoder, WSJ-scale."""
    cfg = AsrConfig(name="wsj_las")
    cfg.model.encoder = "pblstm"
    cfg.model.encoder_layers = 4
    cfg.model.pyramid_layers = 3
    cfg.model.encoder_dim = 320
    cfg.model.vgg_frontend = True
    cfg.model.ctc_weight = 0.3
    cfg.model.decoder_layers = 1
    cfg.model.decoder_dim = 320
    cfg.data.train_manifest = "data/wsj/train_si284.jsonl"
    cfg.data.dev_manifest = "data/wsj/dev93.jsonl"
    cfg.data.test_manifest = "data/wsj/eval92.jsonl"
    cfg.data.tokenizer = "char"
    cfg.data.tokenizer_path = "data/wsj/tokenizer.json"
    cfg.train.steps = 100_000
    cfg.train.eval_every = 5000
    cfg.train.lr = 1e-3
    cfg.train.schedule = "cosine"
    cfg.train.warmup_steps = 4000
    cfg.train.scheduled_sampling = 0.1
    cfg.decode.mode = "beam"
    cfg.decode.beam_size = 10
    cfg.decode.ctc_weight = 0.3
    return cfg


def libri100_transformer() -> AsrConfig:
    """Rung 3: 12-layer Transformer + joint CTC/attention, LibriSpeech-100h."""
    cfg = AsrConfig(name="libri100_transformer")
    cfg.model.encoder = "transformer"
    cfg.model.encoder_layers = 12
    cfg.model.encoder_dim = 256
    cfg.model.encoder_ffn_dim = 1024
    cfg.model.encoder_heads = 4
    cfg.model.ctc_weight = 0.3
    # genre pairing (Speech-Transformer / ESPnet): transformer decoder
    cfg.model.decoder = "transformer"
    cfg.model.decoder_layers = 6
    cfg.model.decoder_dim = 256
    cfg.model.decoder_heads = 4
    cfg.model.decoder_ffn_dim = 1024
    cfg.data.train_manifest = "data/librispeech/train-clean-100.jsonl"
    cfg.data.dev_manifest = "data/librispeech/dev-clean.jsonl"
    cfg.data.test_manifest = "data/librispeech/test-clean.jsonl"
    cfg.data.tokenizer = "bpe"
    cfg.data.tokenizer_path = "data/librispeech/bpe256.json"
    cfg.data.batch_frames = 1_600_000
    cfg.data.batch_size = 64
    cfg.train.steps = 200_000
    cfg.train.eval_every = 5000
    cfg.train.lr = 1.0e-3
    cfg.train.schedule = "noam"
    cfg.train.warmup_steps = 25_000
    cfg.decode.mode = "beam"
    cfg.decode.beam_size = 10
    return cfg


def libri960_conformer() -> AsrConfig:
    """Rung 4: Conformer + joint beam w/ RNN-LM fusion, LibriSpeech-960h."""
    cfg = AsrConfig(name="libri960_conformer")
    cfg.model.encoder = "conformer"
    cfg.model.encoder_layers = 16
    cfg.model.encoder_dim = 512
    cfg.model.encoder_ffn_dim = 2048
    cfg.model.encoder_heads = 8
    # decouple subsampling-conv width from d_model: at 512 channels the 2nd
    # subsample conv alone would cost ~2 conformer layers of FLOPs
    cfg.model.subsample_channels = 128
    cfg.model.ctc_weight = 0.3
    # ESPnet-style conformer-large pairing: 6-layer transformer decoder
    # (the lstm speller default is rung 2's genre-defining component, not
    # this rung's)
    cfg.model.decoder = "transformer"
    cfg.model.decoder_layers = 6
    cfg.model.decoder_heads = 8
    cfg.model.decoder_dim = 512
    cfg.model.embed_dim = 512
    cfg.model.attention_dim = 512
    cfg.data.train_manifest = "data/librispeech/train-960.jsonl"
    cfg.data.dev_manifest = "data/librispeech/dev-clean.jsonl"
    cfg.data.test_manifest = "data/librispeech/test-clean.jsonl"
    cfg.data.tokenizer = "bpe"
    cfg.data.tokenizer_path = "data/librispeech/bpe1024.json"
    cfg.data.batch_frames = 3_200_000
    cfg.data.batch_size = 128
    cfg.train.steps = 400_000
    cfg.train.eval_every = 10_000
    cfg.train.lr = 1.5e-3
    cfg.train.schedule = "noam"
    cfg.train.warmup_steps = 40_000
    cfg.decode.mode = "beam"
    cfg.decode.beam_size = 10
    cfg.decode.lm_weight = 0.3
    return cfg


def libri960_multihost() -> AsrConfig:
    """Rung 5: multi-host data-parallel 960h + TP-sharded large encoder,
    streaming chunked encode."""
    cfg = libri960_conformer()
    cfg.name = "libri960_multihost"
    cfg.model.encoder_layers = 24
    cfg.model.encoder_dim = 1024
    cfg.model.encoder_ffn_dim = 4096
    cfg.model.encoder_heads = 16
    cfg.train.dp = 4
    cfg.train.tp = 2
    cfg.data.batch_frames = 12_800_000
    cfg.data.batch_size = 512
    return cfg


def flagship_conformer() -> AsrConfig:
    """The headline-metric model: 12-layer Conformer d256/H4. Impl/dtype
    fields stay at their 'auto' defaults so `resolve_device` delivers the
    kernels and bf16 on CUDA and plain torch/f32 on CPU."""
    cfg = AsrConfig(name="flagship_conformer")
    cfg.model.encoder = "conformer"
    cfg.model.encoder_layers = 12
    cfg.model.encoder_dim = 256
    cfg.model.encoder_ffn_dim = 1024
    cfg.model.subsample_channels = 64  # see ModelConfig.subsample_channels
    cfg.model.encoder_heads = 4
    cfg.model.vocab_size = 64
    # transformer decoder, NOT ModelConfig's lstm default: the genre pairs
    # conformer recipes with transformer decoders
    cfg.model.decoder = "transformer"
    cfg.model.decoder_layers = 2
    cfg.model.decoder_dim = 256
    cfg.model.embed_dim = 128
    cfg.model.attention_dim = 128
    cfg.model.ctc_weight = 0.3
    cfg.frontend.spec_augment = True
    return cfg


PRESETS = {
    "an4_ctc": an4_ctc,
    "wsj_las": wsj_las,
    "libri100_transformer": libri100_transformer,
    "libri960_conformer": libri960_conformer,
    "libri960_multihost": libri960_multihost,
    "flagship_conformer": flagship_conformer,
}
