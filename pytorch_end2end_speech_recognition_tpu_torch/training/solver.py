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
draws the uninterrupted run would have taken.

On a mesh (`parallel/mesh.py`; the JAX package's `Solver(mesh=...)`) the
model is sharded (`parallel/sharding.py`), each rank trains on its loader
shard's rows, and:
- the loss divides by the valid rows of the global batch, and after the
  backward one all-reduce sums the flattened gradients over 'data', in
  parameter order, so every replica takes the global batch's step;
- the gradient's global norm sums the sharded parameters' squares over
  'model'; Adam's moments are sharded as their parameters;
- the logged metrics and the dev WER's error counts are the global
  batch's (summed over 'data'); only rank 0 writes metrics;
- a checkpoint holds whole tensors, gathered from the shards and written
  by rank 0, and restores on any mesh;
- under pipeline parallelism (`model.pp_stages > 1`) every parameter is
  replicated, and the gradients of the encoder's blocks, which each stage
  holds for its own blocks alone, are summed over 'model' before the
  data sum (`parallel/pp.py`);
- each data rank draws from its own generator, seeded train.seed + data
  rank (the ranks of one 'model' group draw alike: their SpecAugment masks
  and dropout on replicated activations must agree). A checkpoint keeps
  every data rank's generator state; resuming on another dp reseeds the
  data ranks past 0.
Every rank must make the same calls in the same order (each one of these
runs collectives): `fit`, `evaluate`, the checkpoint methods.
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
from pytorch_end2end_speech_recognition_tpu_torch.parallel import sharding
from pytorch_end2end_speech_recognition_tpu_torch.parallel.collectives import (
    all_gather_host,
    all_reduce_,
)
from pytorch_end2end_speech_recognition_tpu_torch.parallel.mesh import (
    require_mesh,
)
from pytorch_end2end_speech_recognition_tpu_torch.parallel.pp import (
    sum_stage_grads,
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
from pytorch_end2end_speech_recognition_tpu_torch.utils.profiling import span


class Solver:
    """Trains an `AsrModel`. `cfg` is resolved for `device` (None ->
    'cuda'; with a `mesh`, the mesh's device; the caller's config is not
    modified) with `vocab_size` set from `tokenizer`; a `model` built from
    the same config may be passed in (it is sharded here if it is not
    yet)."""

    def __init__(self, cfg: AsrConfig, tokenizer, device=None,
                 model: AsrModel | None = None, mesh=None):
        require_mesh(mesh)
        dev = mesh.device if mesh is not None else dv.resolve(device)
        cfg = resolve_device(cfg, dev)
        cfg.model.vocab_size = tokenizer.vocab_size
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.device = dev
        self.mesh = mesh
        self.model = model or AsrModel(cfg, device=dev, seed=cfg.train.seed,
                                       mesh=mesh)
        if mesh is not None:
            sharding.shard_train_state(mesh, self.model)
        if self.model.cfg.model.vocab_size != tokenizer.vocab_size:
            raise ValueError("model vocab_size differs from the tokenizer's")
        self.names, self.params = zip(*self.model.named_parameters())
        self.opt = make_optimizer(cfg.train, list(self.params))
        self.dims = self.model.shard_dims if mesh is not None else {}
        self.data_group = mesh.data_group if mesh is not None else None
        data_rank = mesh.data_rank if mesh is not None else 0
        if self.dims:
            self.opt.shards = (sharding.sharded_mask(self.names, self.dims),
                               mesh.model_group)
        # the pipeline's stages: each rank's blocks' gradients, to be summed
        self.stage_group = (mesh.model_group if mesh is not None
                            and cfg.model.pp_stages > 1 else None)
        self.staged = [n.startswith("encoder.blocks.") for n in self.names]
        self.generator = torch.Generator(device=dev).manual_seed(
            cfg.train.seed + data_rank)
        self.step = 0
        self.best_wer = float("inf")
        self.lr_scale = 1.0          # host-driven plateau decay multiplier
        self.evals_since_best = 0
        self.cursor_epoch = 0        # loader position for exact resume
        self.cursor_batch = 0
        self.log: list[dict] = []    # the train records, as logged
        self.rank0 = mesh is None or mesh.rank == 0
        self.logger = MetricsLogger(
            cfg.train.metrics_path if self.rank0 else None, echo=self.rank0,
            tensorboard_dir=(cfg.train.tensorboard_dir if self.rank0
                             else None) or None)
        # pinned host batches whose copies to the card may be in flight
        self._in_flight: list[tuple[tuple, torch.cuda.Event]] = []
        if mesh is not None:
            from pytorch_end2end_speech_recognition_tpu_torch.utils.debugging import (  # noqa: E501
                check_collective_consistency,
            )

            check_collective_consistency(
                {"params": dict(zip(self.names, self.params)),
                 "opt": {"m1": self.opt.m1, "m2": self.opt.m2}},
                specs={f"params/{n}": spec for n, (_, spec) in
                       zip(self.names, self.model.param_specs)})

    # ------------------------------------------------------------ data feed
    def _put(self, batch: Batch):
        """The batch's four arrays on the device. Pinned ones (`pin_batch`)
        are copied asynchronously; each stays referenced until an event
        recorded after its copy has completed, so its page-locked buffer is
        neither freed nor reused while the DMA reads it. On a mesh the
        batch is this rank's shard of the global batch, as its loader
        reads it (`host_shard_info`)."""
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
        loss, backward. On a mesh: the global batch's metrics and
        gradients (this rank's slices of the sharded ones)."""
        m, mc = self.model, self.cfg.model
        with span("train.put"):
            audio, audio_lens, tokens, token_lens = self._put(batch)
        with span("train.forward"):
            enc, enc_lens = m.encode(audio, audio_lens, train=True,
                                     generator=self.generator,
                                     spec_mask=spec_mask)
            logits = m.ctc_logits(enc)
            att = None
            if isinstance(m.decoder, AttentionDecoder):
                att = m.decoder(
                    enc, enc_lens, tokens, train=True,
                    generator=self.generator,
                    scheduled_sampling=self.cfg.train.scheduled_sampling,
                    coins=coins)
            elif m.decoder is not None:
                att = m.decoder(enc, enc_lens, tokens, train=True,
                                generator=self.generator)
        with span("train.loss"):
            loss, metrics = hybrid_loss(logits, enc_lens, att, tokens,
                                        token_lens, mc.ctc_weight,
                                        mc.label_smoothing,
                                        ctc_impl=mc.ctc_impl,
                                        data_group=self.data_group)
        with span("train.backward"):
            grads = list(torch.autograd.grad(loss, self.params,
                                             allow_unused=True))
            metrics = {k: v.detach() for k, v in metrics.items()}
            grads = sum_stage_grads(grads, self.params, self.staged,
                                    self.stage_group)
            if self.data_group is not None:
                grads = self._sum_over_data(grads)
                vals = all_reduce_(torch.stack(list(metrics.values())),
                                   self.data_group)
                metrics = dict(zip(metrics, vals.unbind(0)))
        return metrics, grads

    def _sum_over_data(self, grads: list) -> list[torch.Tensor]:
        """The gradients summed over 'data' by one all-reduce of their
        concatenation, in parameter order."""
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]),
                           self.data_group)
        return [f.view_as(g) for f, g in
                zip(flat.split([g.numel() for g in grads]), grads)]

    def train_step(self, batch: Batch, spec_mask=None, coins=None) -> dict:
        """One micro-step; returns the step's metrics as 0-dim device
        tensors: loss, ctc_loss, att_loss (those the model has) and
        grad_norm, the global norm of this batch's gradients before the
        clip."""
        metrics, grads = self.grads(batch, spec_mask, coins)
        with span("train.optimizer"):
            metrics["grad_norm"] = self.opt.step(grads, self.lr_scale)
        self.step += 1
        return metrics

    def fit(self, train_loader: BucketedLoader,
            dev_loader: BucketedLoader | None = None,
            steps: int | None = None) -> dict:
        """Train from the loader's cursor until `steps` (default
        train.steps). Every train.log_every steps and at the last one, the
        metrics, audio_s_per_s (seconds of audio trained per wall second
        since fit began) and data_wait_s (host seconds the loop has waited
        for the next batch from the prefetch thread since fit began: near
        wall_s, training is input-bound) are logged and appended to
        `self.log`; every train.eval_every steps, with a dev loader, the
        evaluation (see the module's docstring). Returns {'loss': [...]} of
        the train records."""
        cfg = self.cfg.train
        steps = steps or cfg.steps
        sr = self.cfg.frontend.sample_rate
        t0 = time.perf_counter()
        audio_s = waited = 0.0
        history = {"loss": []}
        batches = train_loader.repeat(self.cursor_epoch, self.cursor_batch,
                                      with_cursor=True)
        if self.device.type == "cuda":
            # pinned in the prefetch thread, off the training loop's path
            batches = ((ep, bi, pin_batch(b)) for ep, bi, b in batches)
        it = prefetch(batches, depth=2)
        try:
            while True:
                t = time.perf_counter()
                with span("fit.data_wait"):
                    item = next(it, None)
                waited += time.perf_counter() - t
                if item is None or self.step >= steps:
                    break
                ep, bi, batch = item
                self.cursor_epoch, self.cursor_batch = ep, bi + 1
                metrics = self.train_step(batch)
                audio_s += float(batch.audio_lens.sum()) / sr
                if self.step % cfg.log_every == 0 or self.step == steps:
                    rec = {k: float(v) for k, v in metrics.items()}
                    total_s = float(all_reduce_(
                        torch.tensor([audio_s], dtype=torch.float64),
                        self.data_group))
                    wall = time.perf_counter() - t0
                    rec.update(step=self.step,
                               audio_s_per_s=total_s / max(wall, 1e-9),
                               wall_s=wall, data_wait_s=waited)
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
        """Greedy dev WER over one pass of `loader`; on a mesh each data
        rank scores its loader shard and the error counts are summed over
        'data', so that every rank sees the global WER (the best-WER and
        plateau decisions stay in lockstep)."""
        stats = ErrorStats()
        for batch in loader.epoch(0):
            hyp, hyp_lens = self.greedy_ids(batch)
            for i in range(len(batch.ids)):
                if batch.audio_lens[i] == 0:
                    continue
                text = self.tokenizer.decode(hyp[i, :hyp_lens[i]])
                stats.update(batch.texts[i].split(), text.split())
        if self.data_group is None:
            return stats.rate
        errors, tokens = all_reduce_(
            torch.tensor([stats.errors, stats.tokens]), self.data_group)
        return int(errors) / max(int(tokens), 1)

    def _log_attention(self, batch: Batch) -> None:
        """One utterance's decoder attention heatmap to tensorboard (no-op
        without a decoder or a tensorboard_dir, and under tensor
        parallelism, whose forward runs collectives that rank 0 alone,
        the one that logs, would wait on)."""
        if (self.model.decoder is None or self.logger._tb is None
                or (self.mesh is not None and self.mesh.tp > 1)):
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
        rng = self.generator.get_state()
        ranks = (torch.stack(all_gather_host(rng, self.data_group))
                 if self.data_group is not None else torch.zeros(0))
        return {
            "rng": rng,
            "rng_data_ranks": ranks.to(torch.uint8),
            "cursor_epoch": self.cursor_epoch,
            "cursor_batch": self.cursor_batch,
            "lr_scale": self.lr_scale,
            "evals_since_best": self.evals_since_best,
            "vocab_hash": self.tokenizer.vocab_hash(),
        }

    def _params(self) -> dict:
        """Every parameter whole (gathered from the shards on a mesh)."""
        if self.mesh is None:
            return dict(zip(self.names, self.params))
        return {n: sharding.full_tensor(self.mesh, p, self.dims.get(n))
                for n, p in zip(self.names, self.params)}

    def full_state(self) -> tuple[dict, dict, dict]:
        """(whole parameters, whole optimizer state, meta) for a checkpoint;
        on a mesh a collective of every rank."""
        opt = self.opt.state_dict()
        if self.mesh is not None:
            opt = sharding.full_opt_state(opt, list(self.names), self.dims,
                                          self.mesh)
        return self._params(), opt, self._extra_meta()

    def _written(self) -> None:
        """On a mesh, wait until rank 0 has written (a host all-reduce over
        every rank)."""
        if self.mesh is not None and self.mesh.dp * self.mesh.tp > 1:
            import torch.distributed as dist

            all_reduce_(torch.zeros(1), dist.group.WORLD)

    def save_checkpoint(self, tag: str = "last"):
        params, opt, meta = self.full_state()
        if self.rank0:
            checkpoint.save_checkpoint(
                self.cfg.train.checkpoint_dir, tag, params=params,
                opt_state=opt, step=self.step, best_wer=self.best_wer,
                cfg=self.cfg, extra_meta=meta)
        self._written()

    def save_step_checkpoint(self):
        params, opt, meta = self.full_state()
        if self.rank0:
            checkpoint.save_step_checkpoint(
                self.cfg.train.checkpoint_dir, self.step, params=params,
                opt_state=opt, best_wer=self.best_wer, cfg=self.cfg,
                max_to_keep=self.cfg.train.keep_checkpoints,
                extra_meta=meta)
        self._written()

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
        opt = data["opt_state"]
        mesh = self.mesh
        if mesh is not None:
            opt = sharding.shard_train_state(mesh, self.model, opt)[1]
        with torch.no_grad():
            for name, p in zip(self.names, self.params):
                full = params[name]
                if name in self.dims:
                    full = sharding.shard_tensor(full, *self.dims[name],
                                                 mesh.tp, mesh.model_rank)
                p.copy_(full)
        self.opt.load_state_dict(opt)
        self.step = int(data["step"])
        self.best_wer = float(data["best_wer"])
        ranks = data.get("rng_data_ranks")
        dp = mesh.dp if mesh is not None else 1
        if dp == 1:
            self.generator.set_state(data["rng"])
        elif ranks is not None and len(ranks) == dp:
            self.generator.set_state(ranks[mesh.data_rank].contiguous())
        elif mesh.data_rank == 0:
            self.generator.set_state(data["rng"])
        self.cursor_epoch = int(data["cursor_epoch"])
        self.cursor_batch = int(data["cursor_batch"])
        self.lr_scale = float(data["lr_scale"])
        self.evals_since_best = int(data["evals_since_best"])
