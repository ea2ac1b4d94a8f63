"""The ASR model: frontend + encoder + CTC head + attention decoder (the
port of the JAX package's `models/asr.py`). It serves encode -> CTC logits
-> greedy decode, and trains with SpecAugment, dropout and the hybrid loss
(`training/solver.py`). The decoder is the transformer decoder, built when
`ctc_weight < 1` as in the reference; the LSTM speller is not ported yet."""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from pytorch_end2end_speech_recognition_tpu_torch.models.decoder_transformer import (  # noqa: E501
    TransformerDecoder,
)
from pytorch_end2end_speech_recognition_tpu_torch.models.encoders import (
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


class CtcHead(nn.Module):
    """Linear projection to vocab (+blank at id 0) for CTC, in float32."""

    def __init__(self, d_in: int, vocab: int):
        super().__init__()
        self.proj = nn.Linear(d_in, vocab)

    def forward(self, enc: torch.Tensor) -> torch.Tensor:
        return F.linear(enc.float(), self.proj.weight, self.proj.bias)


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation with Flax's defaults: LeCun-normal weights
    (std 1/sqrt(fan_in)), zero biases, unit LayerNorm scales, embeddings of
    std 1/sqrt(dim), and a N(0, 0.02^2) relative-position table. Drawn on
    the CPU from `generator`, so one seed gives the same weights on every
    device."""
    for mod in module.modules():
        params = dict(mod.named_parameters(recurse=False))
        if isinstance(mod, RelPosBias):
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
                    / math.sqrt(fan_in),
                    "bias": torch.zeros(mod.bias.shape)}
        else:
            vals = {}
        for name, p in params.items():
            p.copy_(vals[name])


class AsrModel(nn.Module):
    """Frontend, encoder, CTC head and (for ctc_weight < 1) the transformer
    decoder on one device.

    `cfg` is resolved for `device` (None -> 'cuda'; the caller's config is
    not modified) and the weights are drawn from `seed`."""

    def __init__(self, cfg: AsrConfig, device=None, seed: int = 0):
        super().__init__()
        dev = dv.resolve(device)
        cfg = resolve_device(cfg, dev)
        self.cfg = cfg
        self.frontend = Frontend(cfg.frontend, dev)
        m = cfg.model
        if m.ctc_weight < 1.0 and m.decoder != "transformer":
            raise NotImplementedError(f"decoder {m.decoder!r} is not ported "
                                      "yet (set model.decoder=transformer)")
        with torch.device("meta"):
            self.encoder = build_encoder(cfg.frontend.n_mels, m)
            self.ctc_head = CtcHead(self.encoder.d_out, m.vocab_size)
            self.decoder = (TransformerDecoder(self.encoder.d_out, m)
                            if m.ctc_weight < 1.0 else None)
        gen = torch.Generator().manual_seed(seed)
        for part in (self.encoder, self.ctc_head, self.decoder):
            if part is not None:
                part.to_empty(device=dev)
                init_params(part, gen)

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
            feats, flens = self.frontend(audio, audio_lens)
            if augment:
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
        return self.ctc_head(enc)
