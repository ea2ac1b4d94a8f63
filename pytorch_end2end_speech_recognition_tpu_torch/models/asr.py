"""The ASR model: frontend + encoder + CTC head (the port of the JAX
package's `models/asr.py`). The attention decoder comes with a later slice,
so this model serves encode -> CTC logits -> greedy decode."""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from pytorch_end2end_speech_recognition_tpu_torch.models.encoders import (
    RelPosBias,
    build_encoder,
)
from pytorch_end2end_speech_recognition_tpu_torch.ops.frontend import Frontend
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
    (std 1/sqrt(fan_in)), zero biases, unit LayerNorm scales, and a
    N(0, 0.02^2) relative-position table. Drawn on the CPU from `generator`,
    so one seed gives the same weights on every device."""
    for mod in module.modules():
        params = dict(mod.named_parameters(recurse=False))
        if isinstance(mod, RelPosBias):
            vals = {"table": torch.randn(mod.table.shape, generator=generator)
                    * 0.02}
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
    """Frontend, encoder and CTC head on one device.

    `cfg` is resolved for `device` (None -> 'cuda'; the caller's config is
    not modified) and the weights are drawn from `seed`."""

    def __init__(self, cfg: AsrConfig, device=None, seed: int = 0):
        super().__init__()
        dev = dv.resolve(device)
        cfg = resolve_device(cfg, dev)
        self.cfg = cfg
        self.frontend = Frontend(cfg.frontend, dev)
        with torch.device("meta"):
            self.encoder = build_encoder(cfg.frontend.n_mels, cfg.model)
            self.ctc_head = CtcHead(self.encoder.d_out, cfg.model.vocab_size)
        self.encoder.to_empty(device=dev)
        self.ctc_head.to_empty(device=dev)
        gen = torch.Generator().manual_seed(seed)
        init_params(self.encoder, gen)
        init_params(self.ctc_head, gen)

    def features(self, audio: torch.Tensor, audio_lens: torch.Tensor):
        return self.frontend(audio, audio_lens)

    def encode(self, audio: torch.Tensor, audio_lens: torch.Tensor):
        """audio (B, Ts) -> (enc (B, T', D), enc_lens (B,))."""
        feats, flens = self.features(audio, audio_lens)
        return self.encoder(feats, flens)

    def ctc_logits(self, enc: torch.Tensor) -> torch.Tensor:
        return self.ctc_head(enc)
