"""Solver: the training engine (the port of the JAX package's
`training/solver.py` train step and fit loop).

One step: frontend -> SpecAugment -> encoder (dropout) -> CTC head +
transformer decoder -> hybrid loss -> backward -> global-norm clip -> adamw
with the schedule -> in-place update. On CUDA the loss's backward runs the
hand-written backward kernels (attention, Toeplitz reduce, CTC). Random
draws come from one `torch.Generator` on the model's device, seeded from
`train.seed`.

Not ported yet: evaluation (greedy WER), checkpoints and resume, the
metrics log file and tensorboard, the bucketed loader and tokenizers,
gradient accumulation and adadelta.
"""

from __future__ import annotations

import time
from typing import Iterable

import torch

from pytorch_end2end_speech_recognition_tpu_torch.data.dataset import Batch
from pytorch_end2end_speech_recognition_tpu_torch.models.asr import AsrModel
from pytorch_end2end_speech_recognition_tpu_torch.training.losses import (
    hybrid_loss,
)
from pytorch_end2end_speech_recognition_tpu_torch.training.schedules import (
    make_optimizer,
)
from pytorch_end2end_speech_recognition_tpu_torch.utils import device as dv
from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
    AsrConfig,
    resolve_device,
)


class Solver:
    """Trains an `AsrModel`. `cfg` is resolved for `device` (None ->
    'cuda'; the caller's config is not modified) with `vocab_size` set; a
    `model` built from the same config may be passed in."""

    def __init__(self, cfg: AsrConfig, vocab_size: int, device=None,
                 model: AsrModel | None = None):
        dev = dv.resolve(device)
        cfg = resolve_device(cfg, dev)
        cfg.model.vocab_size = vocab_size
        self.cfg = cfg
        self.device = dev
        self.model = model or AsrModel(cfg, device=dev, seed=cfg.train.seed)
        if self.model.cfg.model.vocab_size != vocab_size:
            raise ValueError("model vocab_size differs from the Solver's")
        self.names, self.params = zip(*self.model.named_parameters())
        self.opt = make_optimizer(cfg.train, list(self.params))
        self.generator = torch.Generator(device=dev).manual_seed(
            cfg.train.seed)
        self.step = 0
        self.lr_scale = 1.0  # plateau decay multiplier (host-driven)
        self.log: list[dict] = []

    def _put(self, batch: Batch):
        return tuple(torch.as_tensor(a, device=self.device)
                     for a in (batch.audio, batch.audio_lens, batch.tokens,
                               batch.token_lens))

    def grads(self, batch: Batch, spec_mask=None):
        """(metrics, gradients in parameter order) of the train-mode pass
        over one batch, without updating: SpecAugment (from `spec_mask` when
        given), dropout, CTC head and decoder, hybrid loss, backward."""
        m, mc = self.model, self.cfg.model
        audio, audio_lens, tokens, token_lens = self._put(batch)
        enc, enc_lens = m.encode(audio, audio_lens, train=True,
                                 generator=self.generator, spec_mask=spec_mask)
        logits = m.ctc_logits(enc)
        att = None
        if m.decoder is not None:
            att = m.decoder(enc, enc_lens, tokens, train=True,
                            generator=self.generator)
        loss, metrics = hybrid_loss(logits, enc_lens, att, tokens, token_lens,
                                    mc.ctc_weight, mc.label_smoothing,
                                    ctc_impl=mc.ctc_impl)
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        return {k: v.detach() for k, v in metrics.items()}, list(grads)

    def train_step(self, batch: Batch, spec_mask=None) -> dict:
        """One update; returns the step's metrics as 0-dim device tensors:
        loss, ctc_loss, att_loss (those the model has) and grad_norm, the
        global norm before the clip."""
        metrics, grads = self.grads(batch, spec_mask)
        metrics["grad_norm"] = self.opt.step(grads, self.lr_scale)
        self.step += 1
        return metrics

    def fit(self, batches: Iterable[Batch], steps: int | None = None) -> dict:
        """Train on `batches` until `steps` updates (default train.steps)
        or the iterable ends. Every train.log_every steps and at the last
        one, the metrics and audio_s_per_s (seconds of audio trained per
        wall second since fit began) are appended to `self.log`; returns
        {'loss': [...]} of those records."""
        cfg = self.cfg.train
        steps = steps or cfg.steps
        sr = self.cfg.frontend.sample_rate
        t0 = time.perf_counter()
        audio_s = 0.0
        history = {"loss": []}
        for batch in batches:
            if self.step >= steps:
                break
            metrics = self.train_step(batch)
            audio_s += float(batch.audio_lens.sum()) / sr
            if self.step % cfg.log_every == 0 or self.step == steps:
                rec = {k: float(v) for k, v in metrics.items()}
                wall = time.perf_counter() - t0
                rec.update(step=self.step, audio_s_per_s=audio_s / wall,
                           wall_s=wall)
                self.log.append(rec)
                history["loss"].append(rec["loss"])
        return history
