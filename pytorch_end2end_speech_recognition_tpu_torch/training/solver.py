"""Solver: the training engine (the port of the JAX package's
`training/solver.py`).

One step: frontend -> SpecAugment -> encoder (dropout) -> CTC head +
decoder (the transformer decoder, or the LSTM speller with scheduled
sampling) -> hybrid loss -> backward -> the optimizer (global-norm clip,
adamw or adadelta, the schedule, optionally gradient accumulation) ->
in-place update, scaled by the host-driven plateau factor. On CUDA the
loss's backward runs the hand-written backward kernels (attention, Toeplitz
reduce, the LSTM recurrence, CTC). Random draws (SpecAugment, dropout, the
scheduled-sampling coins) come from one `torch.Generator` on the model's
device, seeded from `train.seed`; tests inject the SpecAugment mask and the
coins instead.

`fit` trains from a `BucketedLoader`, prefetched in a background thread;
on CUDA each batch is pinned there and copied to the card asynchronously.
Every `train.eval_every` steps it measures the greedy dev WER, writes a
step checkpoint (the newest `train.keep_checkpoints` kept), logs the
decoder's attention to tensorboard, keeps the best-WER checkpoint and
decays the learning rate on a plateau. Checkpoints hold the loader's
cursor and the generator's state, so a resumed run takes the batches and
draws the uninterrupted run would have taken. Not ported: the device mesh
(data and tensor parallelism).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pytorch_end2end_speech_recognition_tpu_torch.data.dataset import (
    Batch,
    BucketedLoader,
    pin_batch,
    prefetch,
)
from pytorch_end2end_speech_recognition_tpu_torch.metrics.wer import ErrorStats
from pytorch_end2end_speech_recognition_tpu_torch.models.asr import AsrModel
from pytorch_end2end_speech_recognition_tpu_torch.models.decoder import (
    AttentionDecoder,
)
from pytorch_end2end_speech_recognition_tpu_torch.ops.ctc import (
    ctc_greedy_decode,
)
from pytorch_end2end_speech_recognition_tpu_torch.training import checkpoint
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
from pytorch_end2end_speech_recognition_tpu_torch.utils.metrics_log import (
    MetricsLogger,
)


class Solver:
    """Trains an `AsrModel`. `cfg` is resolved for `device` (None ->
    'cuda'; the caller's config is not modified) with `vocab_size` set from
    `tokenizer`; a `model` built from the same config may be passed in."""

    def __init__(self, cfg: AsrConfig, tokenizer, device=None,
                 model: AsrModel | None = None, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "Solver(mesh=...): data and tensor parallelism come with the "
                "parallelism slice")
        dev = dv.resolve(device)
        cfg = resolve_device(cfg, dev)
        cfg.model.vocab_size = tokenizer.vocab_size
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.device = dev
        self.model = model or AsrModel(cfg, device=dev, seed=cfg.train.seed)
        if self.model.cfg.model.vocab_size != tokenizer.vocab_size:
            raise ValueError("model vocab_size differs from the tokenizer's")
        self.names, self.params = zip(*self.model.named_parameters())
        self.opt = make_optimizer(cfg.train, list(self.params))
        self.generator = torch.Generator(device=dev).manual_seed(
            cfg.train.seed)
        self.step = 0
        self.best_wer = float("inf")
        self.lr_scale = 1.0          # host-driven plateau decay multiplier
        self.evals_since_best = 0
        self.cursor_epoch = 0        # loader position for exact resume
        self.cursor_batch = 0
        self.log: list[dict] = []    # the train records, as logged
        self.logger = MetricsLogger(cfg.train.metrics_path or None,
                                    tensorboard_dir=cfg.train.tensorboard_dir
                                    or None)
        # pinned host batches whose copies to the card may be in flight
        self._in_flight: list[tuple[tuple, torch.cuda.Event]] = []

    # ------------------------------------------------------------ data feed
    def _put(self, batch: Batch):
        """The batch's four arrays on the device. Pinned ones (`pin_batch`)
        are copied asynchronously; each stays referenced until an event
        recorded after its copy has completed, so its page-locked buffer is
        neither freed nor reused while the DMA reads it."""
        arrays = (batch.audio, batch.audio_lens, batch.tokens,
                  batch.token_lens)
        if not (isinstance(batch.audio, torch.Tensor)
                and batch.audio.is_pinned()):
            return tuple(torch.as_tensor(a, device=self.device)
                         for a in arrays)
        out = tuple(a.to(self.device, non_blocking=True) for a in arrays)
        done = torch.cuda.Event()
        done.record()
        self._in_flight = [(a, e) for a, e in self._in_flight
                           if not e.query()] + [(arrays, done)]
        return out

    # ------------------------------------------------------------ training
    def grads(self, batch: Batch, spec_mask=None, coins=None):
        """(metrics, gradients in parameter order) of the train-mode pass
        over one batch, without updating: SpecAugment (from `spec_mask` when
        given), dropout, CTC head and decoder (the speller's
        scheduled-sampling coins (B, U+1) from `coins` when given), hybrid
        loss, backward."""
        m, mc = self.model, self.cfg.model
        audio, audio_lens, tokens, token_lens = self._put(batch)
        enc, enc_lens = m.encode(audio, audio_lens, train=True,
                                 generator=self.generator, spec_mask=spec_mask)
        logits = m.ctc_logits(enc)
        att = None
        if isinstance(m.decoder, AttentionDecoder):
            att = m.decoder(enc, enc_lens, tokens, train=True,
                            generator=self.generator,
                            scheduled_sampling=self.cfg.train.scheduled_sampling,
                            coins=coins)
        elif m.decoder is not None:
            att = m.decoder(enc, enc_lens, tokens, train=True,
                            generator=self.generator)
        loss, metrics = hybrid_loss(logits, enc_lens, att, tokens, token_lens,
                                    mc.ctc_weight, mc.label_smoothing,
                                    ctc_impl=mc.ctc_impl)
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        return {k: v.detach() for k, v in metrics.items()}, list(grads)

    def train_step(self, batch: Batch, spec_mask=None, coins=None) -> dict:
        """One micro-step; returns the step's metrics as 0-dim device
        tensors: loss, ctc_loss, att_loss (those the model has) and
        grad_norm, the global norm of this batch's gradients before the
        clip."""
        metrics, grads = self.grads(batch, spec_mask, coins)
        metrics["grad_norm"] = self.opt.step(grads, self.lr_scale)
        self.step += 1
        return metrics

    def fit(self, train_loader: BucketedLoader,
            dev_loader: BucketedLoader | None = None,
            steps: int | None = None) -> dict:
        """Train from the loader's cursor until `steps` (default
        train.steps). Every train.log_every steps and at the last one, the
        metrics and audio_s_per_s (seconds of audio trained per wall second
        since fit began) are logged and appended to `self.log`; every
        train.eval_every steps, with a dev loader, the evaluation (see the
        module's docstring). Returns {'loss': [...]} of the train records."""
        cfg = self.cfg.train
        steps = steps or cfg.steps
        sr = self.cfg.frontend.sample_rate
        t0 = time.perf_counter()
        audio_s = 0.0
        history = {"loss": []}
        batches = train_loader.repeat(self.cursor_epoch, self.cursor_batch,
                                      with_cursor=True)
        if self.device.type == "cuda":
            # pinned in the prefetch thread, off the training loop's path
            batches = ((ep, bi, pin_batch(b)) for ep, bi, b in batches)
        it = prefetch(batches, depth=2)
        try:
            for ep, bi, batch in it:
                if self.step >= steps:
                    break
                self.cursor_epoch, self.cursor_batch = ep, bi + 1
                metrics = self.train_step(batch)
                audio_s += float(batch.audio_lens.sum()) / sr
                if self.step % cfg.log_every == 0 or self.step == steps:
                    rec = {k: float(v) for k, v in metrics.items()}
                    wall = time.perf_counter() - t0
                    rec.update(step=self.step,
                               audio_s_per_s=audio_s / max(wall, 1e-9),
                               wall_s=wall)
                    self.logger.log("train", rec)
                    self.log.append(rec)
                    history["loss"].append(rec["loss"])
                if dev_loader is not None and self.step % cfg.eval_every == 0:
                    self._evaluate_and_keep(dev_loader, batch)
        finally:
            it.close()
        return history

    def _evaluate_and_keep(self, dev_loader: BucketedLoader,
                           batch: Batch) -> None:
        """Dev WER, step checkpoint, attention image, best-WER retention
        and plateau decay, in the reference's order."""
        cfg = self.cfg.train
        wer = self.evaluate(dev_loader)
        self.logger.log("dev", {"step": self.step, "wer": wer,
                                "lr_scale": self.lr_scale})
        self.save_step_checkpoint()
        self._log_attention(batch)
        if wer < self.best_wer:
            self.best_wer = wer
            self.evals_since_best = 0
            self.save_checkpoint(tag="best")
        else:
            self.evals_since_best += 1
            if (cfg.schedule == "plateau"
                    and self.evals_since_best >= cfg.plateau_patience):
                self.lr_scale *= cfg.plateau_factor
                self.evals_since_best = 0

    # ------------------------------------------------------------ evaluation
    @torch.inference_mode()
    def greedy_ids(self, batch: Batch) -> tuple[np.ndarray, np.ndarray]:
        """Greedy CTC decode of a batch on the device (encode, CTC head,
        `ctc_greedy_decode`): (ids (B, T') int32, lengths (B,)) on the host,
        in one copy."""
        audio, audio_lens = self._put(batch)[:2]
        enc, enc_lens = self.model.encode(audio, audio_lens)
        hyp, hyp_lens = ctc_greedy_decode(self.model.ctc_logits(enc),
                                          enc_lens)
        out = torch.cat([hyp_lens[:, None], hyp], dim=1).cpu().numpy()
        return out[:, 1:], out[:, 0]

    def evaluate(self, loader: BucketedLoader) -> float:
        """Greedy dev WER over one pass of `loader`."""
        stats = ErrorStats()
        for batch in loader.epoch(0):
            hyp, hyp_lens = self.greedy_ids(batch)
            for i in range(len(batch.ids)):
                if batch.audio_lens[i] == 0:
                    continue
                text = self.tokenizer.decode(hyp[i, :hyp_lens[i]])
                stats.update(batch.texts[i].split(), text.split())
        return stats.rate

    def _log_attention(self, batch: Batch) -> None:
        """One utterance's decoder attention heatmap to tensorboard (no-op
        without a decoder or a tensorboard_dir)."""
        if self.model.decoder is None or self.logger._tb is None:
            return
        with torch.inference_mode():
            audio, audio_lens, tokens, _ = self._put(batch)
            enc, enc_lens = self.model.encode(audio, audio_lens)
            _, attn = self.model.decoder(enc, enc_lens, tokens,
                                         return_attn=True)
        token_lens = np.asarray(batch.token_lens)
        u = int(np.argmax(token_lens))
        U, T = int(token_lens[u]) + 1, int(enc_lens[u])
        self.logger.log_image("dev/attention",
                              attn[u, :U, :T].float().cpu().numpy(), self.step)

    def decode_batch(self, batch: Batch) -> list[str]:
        """Greedy transcripts of every row."""
        hyp, hyp_lens = self.greedy_ids(batch)
        return [self.tokenizer.decode(hyp[i, :hyp_lens[i]])
                for i in range(hyp.shape[0])]

    # ------------------------------------------------------------ checkpoints
    def _extra_meta(self) -> dict:
        return {
            "rng": self.generator.get_state(),
            "cursor_epoch": self.cursor_epoch,
            "cursor_batch": self.cursor_batch,
            "lr_scale": self.lr_scale,
            "evals_since_best": self.evals_since_best,
            "vocab_hash": self.tokenizer.vocab_hash(),
        }

    def _params(self) -> dict:
        return dict(zip(self.names, self.params))

    def save_checkpoint(self, tag: str = "last"):
        checkpoint.save_checkpoint(
            self.cfg.train.checkpoint_dir, tag, params=self._params(),
            opt_state=self.opt.state_dict(), step=self.step,
            best_wer=self.best_wer, cfg=self.cfg,
            extra_meta=self._extra_meta())

    def save_step_checkpoint(self):
        checkpoint.save_step_checkpoint(
            self.cfg.train.checkpoint_dir, self.step, params=self._params(),
            opt_state=self.opt.state_dict(), best_wer=self.best_wer,
            cfg=self.cfg, max_to_keep=self.cfg.train.keep_checkpoints,
            extra_meta=self._extra_meta())

    def load_checkpoint(self, tag: str = "last"):
        """Restore parameters, optimizer state, step, best WER, generator
        state, loader cursor, plateau scale and evaluations since the best;
        raises ValueError when the checkpoint was trained with another
        vocabulary."""
        data = checkpoint.load_checkpoint(self.cfg.train.checkpoint_dir, tag)
        saved_hash = int(data.get("vocab_hash", 0))
        if saved_hash and saved_hash != self.tokenizer.vocab_hash():
            raise ValueError(
                f"tokenizer/checkpoint mismatch: checkpoint '{tag}' under "
                f"{self.cfg.train.checkpoint_dir} was trained with a "
                f"different vocab (hash {saved_hash:#010x} != current "
                f"{self.tokenizer.vocab_hash():#010x}). Point "
                "data.tokenizer_path at the tokenizer.json saved with the "
                "checkpoint instead of rebuilding from a changed manifest.")
        params = data["params"]
        if set(params) != set(self.names):
            raise ValueError(f"checkpoint '{tag}' holds other parameters "
                             "than this model")
        with torch.no_grad():
            for name, p in zip(self.names, self.params):
                p.copy_(params[name])
        self.opt.load_state_dict(data["opt_state"])
        self.step = int(data["step"])
        self.best_wer = float(data["best_wer"])
        self.generator.set_state(data["rng"])
        self.cursor_epoch = int(data["cursor_epoch"])
        self.cursor_batch = int(data["cursor_batch"])
        self.lr_scale = float(data["lr_scale"])
        self.evals_since_best = int(data["evals_since_best"])
