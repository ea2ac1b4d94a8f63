"""The ASR model: frontend + encoder + CTC head + attention decoder (the
port of the JAX package's `models/asr.py`). It serves encode -> CTC logits
-> greedy decode, and trains with SpecAugment, dropout and the hybrid loss
(`training/solver.py`). The decoder, built when `ctc_weight < 1` as in the
reference, is the transformer decoder or the location-aware LSTM speller
(`decoder='lstm'`)."""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from pytorch_end2end_speech_recognition_tpu_torch.models.decoder import (
    AttentionDecoder,
    LocationAwareAttention,
)
from pytorch_end2end_speech_recognition_tpu_torch.models.decoder_transformer import (  # noqa: E501
    TransformerDecoder,
)
from pytorch_end2end_speech_recognition_tpu_torch.models.encoders import (
    LstmParams,
    RelPosBias,
    build_encoder,
)
from pytorch_end2end_speech_recognition_tpu_torch.ops.frontend import Frontend
from pytorch_end2end_speech_recognition_tpu_torch.ops.specaugment import (
    spec_augment,
)
from pytorch_end2end_speech_recognition_tpu_torch.utils import device as dv
from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
    AsrConfig,
    resolve_device,
)
from pytorch_end2end_speech_recognition_tpu_torch.utils.profiling import span


class CtcHead(nn.Module):
    """Linear projection to vocab (+blank at id 0) for CTC, in float32."""

    def __init__(self, d_in: int, vocab: int):
        super().__init__()
        self.proj = nn.Linear(d_in, vocab)

    def forward(self, enc: torch.Tensor) -> torch.Tensor:
        return F.linear(enc.float(), self.proj.weight, self.proj.bias)


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation with the reference's initialisers: Flax's
    defaults, LeCun-normal weights (std 1/sqrt(fan_in)), zero biases, unit
    LayerNorm scales, embeddings of std 1/sqrt(dim); a N(0, 0.02^2)
    relative-position table; LSTM weights U(+-1/sqrt(d_in)) (w_ih) and
    U(+-1/sqrt(H)) (w_hh) with the forget-gate bias 1; the speller
    attention's zero bias. Drawn on the CPU from `generator`, so one seed
    gives the same weights on every device."""
    def uniform(shape, s):
        return (torch.rand(shape, generator=generator) * 2 - 1) * s

    for mod in module.modules():
        params = dict(mod.named_parameters(recurse=False))
        if isinstance(mod, LstmParams):
            d_in, H4 = mod.w_ih.shape
            H = H4 // 4
            bias = torch.zeros(H4)
            bias[H:2 * H] = 1.0
            vals = {"w_ih": uniform(mod.w_ih.shape, d_in ** -0.5),
                    "w_hh": uniform(mod.w_hh.shape, H ** -0.5),
                    "bias": bias}
        elif isinstance(mod, LocationAwareAttention):
            vals = {"bias": torch.zeros(mod.bias.shape)}
        elif isinstance(mod, RelPosBias):
            vals = {"table": torch.randn(mod.table.shape, generator=generator)
                    * 0.02}
        elif isinstance(mod, nn.Embedding):
            vals = {"weight": torch.randn(mod.weight.shape, generator=generator)
                    / math.sqrt(mod.weight.shape[1])}
        elif isinstance(mod, nn.LayerNorm):
            vals = {"weight": torch.ones(mod.weight.shape),
                    "bias": torch.zeros(mod.bias.shape)}
        elif isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            fan_in = math.prod(mod.weight.shape[1:])
            vals = {"weight": torch.randn(mod.weight.shape, generator=generator)
                    / math.sqrt(fan_in)}
            if mod.bias is not None:
                vals["bias"] = torch.zeros(mod.bias.shape)
        else:
            vals = {}
        for name, p in params.items():
            p.copy_(vals[name])


class AsrModel(nn.Module):
    """Frontend, encoder, CTC head and (for ctc_weight < 1) the decoder on
    one device.

    `cfg` is resolved for `device` (None -> 'cuda', or the mesh's device;
    the caller's config is not modified) and the weights are drawn from
    `seed`. With a `mesh` (parallel/mesh.py) the whole model is drawn, so
    that every mesh starts from the same weights, and then sharded
    (`parallel/sharding.py:shard_model`): this rank keeps its slices."""

    mesh = None

    def __init__(self, cfg: AsrConfig, device=None, seed: int = 0,
                 mesh=None):
        super().__init__()
        dev = dv.resolve(mesh.device if mesh is not None and device is None
                         else device)
        cfg = resolve_device(cfg, dev)
        self.cfg = cfg
        self.frontend = Frontend(cfg.frontend, dev)
        m = cfg.model
        decoders = {"transformer": TransformerDecoder,
                    "lstm": AttentionDecoder}
        if m.ctc_weight < 1.0 and m.decoder not in decoders:
            raise ValueError(f"unknown decoder kind {m.decoder}")
        with torch.device("meta"):
            self.encoder = build_encoder(cfg.frontend.n_mels, m)
            self.ctc_head = CtcHead(self.encoder.d_out, m.vocab_size)
            self.decoder = (decoders[m.decoder](self.encoder.d_out, m)
                            if m.ctc_weight < 1.0 else None)
        gen = torch.Generator().manual_seed(seed)
        for part in (self.encoder, self.ctc_head, self.decoder):
            if part is not None:
                part.to_empty(device=dev)
                init_params(part, gen)
        if mesh is not None:
            from pytorch_end2end_speech_recognition_tpu_torch.parallel.sharding import (  # noqa: E501
                shard_model,
            )

            shard_model(self, mesh)

    def features(self, audio: torch.Tensor, audio_lens: torch.Tensor,
                 train: bool = False,
                 generator: torch.Generator | None = None,
                 spec_mask: torch.Tensor | None = None):
        """Log-mel features (no gradient: the frontend learns nothing), and
        in training SpecAugment, drawn from `generator` or `spec_mask`."""
        augment = train and self.cfg.frontend.spec_augment
        if augment and generator is None and spec_mask is None:
            raise ValueError("SpecAugment in training needs a generator or "
                             "a spec_mask")
        with torch.no_grad():
            with span("asr.frontend"):
                feats, flens = self.frontend(audio, audio_lens)
            if augment:
                with span("asr.specaugment"):
                    feats = spec_augment(feats, flens, self.cfg.frontend,
                                         generator, spec_mask)
        return feats, flens

    def encode(self, audio: torch.Tensor, audio_lens: torch.Tensor,
               train: bool = False,
               generator: torch.Generator | None = None,
               spec_mask: torch.Tensor | None = None):
        """audio (B, Ts) -> (enc (B, T', D), enc_lens (B,)). With `train`,
        SpecAugment and dropout draw from `generator` (on the model's
        device); `spec_mask` (B, frames, n_mels) replaces the SpecAugment
        draw."""
        feats, flens = self.features(audio, audio_lens, train, generator,
                                     spec_mask)
        return self.encoder(feats, flens, train=train, generator=generator)

    def ctc_logits(self, enc: torch.Tensor) -> torch.Tensor:
        with span("asr.ctc_head"):
            return self.ctc_head(enc)
