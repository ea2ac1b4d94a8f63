"""The port's schedules, clip and optimizers against optax (as the JAX
package's `training/schedules.py` builds them), and the Solver's fit loop on
a tiny model. float32 on the CPU."""

import json

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_end2end_speech_recognition_tpu.training.schedules import (
    make_optimizer as jax_make_optimizer,
    make_schedule as jax_make_schedule,
)
from pytorch_end2end_speech_recognition_tpu.utils.config import (
    TrainConfig as JTrainConfig,
)
from pytorch_end2end_speech_recognition_tpu_torch.training import schedules
from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
    TrainConfig,
)


@pytest.mark.parametrize("name", ["noam", "cosine", "constant", "plateau"])
def test_schedules_match_jax(name):
    kw = dict(schedule=name, lr=2e-3, warmup_steps=25, steps=120)
    ours = schedules.make_schedule(TrainConfig(**kw))
    ref = jax_make_schedule(JTrainConfig(**kw))
    for count in (0, 1, 5, 24, 25, 26, 60, 119, 120, 500):
        want = float(ref(jnp.asarray(count, jnp.int32)))
        # the reference evaluates in float32: a few ulps of lr-sized terms
        assert ours(count) == pytest.approx(want, rel=1e-6,
                                            abs=1e-6 * kw["lr"]), count


@pytest.mark.parametrize("max_norm", [1e3, 0.5])
def test_clip_matches_optax(max_norm):
    rng = np.random.default_rng(0)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((7, 3), (5,))]
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    tg = [torch.from_numpy(g) for g in grads]
    norm = schedules.global_norm(tg)
    got = schedules.clip_by_global_norm(tg, max_norm, norm)
    assert float(norm) == pytest.approx(float(optax.global_norm(
        [jnp.asarray(g) for g in grads])), rel=1e-6)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    if max_norm > 10:
        assert all(torch.equal(a, b) for a, b in zip(got, tg))


@pytest.mark.parametrize("optimizer", ["adamw", "adam"])
def test_optimizer_steps_match_optax_chain(optimizer):
    """Four updates of clip + adam(w) + noam from the JAX package's
    make_optimizer, with lr_scale 1 then 0.5 (Solver's plateau factor),
    gradients above and below the clip."""
    kw = dict(optimizer=optimizer, lr=1e-2, warmup_steps=3, grad_clip=2.0,
              weight_decay=1e-2)
    tx = jax_make_optimizer(JTrainConfig(**kw))
    rng = np.random.default_rng(1)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in ((6, 4), (4,))]
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in p0]
    opt = schedules.make_optimizer(TrainConfig(**kw), tp)
    for i, (scale, lr_scale) in enumerate(((3.0, 1.0), (0.1, 1.0),
                                           (1.0, 0.5), (5.0, 0.5))):
        g = [(rng.standard_normal(p.shape) * scale).astype(np.float32)
             for p in p0]
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = [p + lr_scale * u for p, u in zip(jp, upd)]  # solver.py:145
        norm = opt.step([torch.from_numpy(x) for x in g], lr_scale)
        assert float(norm) == pytest.approx(float(optax.global_norm(
            [jnp.asarray(x) for x in g])), rel=1e-6)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7, err_msg=str(i))


@pytest.mark.parametrize("optimizer,accum", [
    ("adadelta", 1), ("adamw", 2), ("adamw", 3), ("adadelta", 2),
    ("adam", 3)])
def test_adadelta_and_accumulation_match_optax(optimizer, accum):
    """Six micro-steps of the JAX package's make_optimizer (adadelta:
    scale_by_adadelta then the learning rate; grad_accum_steps > 1:
    optax.MultiSteps with its running mean) against the port's, with the
    solver's p + lr_scale u and lr_scale 0.5 from the fourth step on,
    gradients above and below the clip. Parameters stay unchanged between
    the k-th micro-steps (bit for bit); elsewhere within 1e-6 relative +
    1e-7, float32 on both sides in another order; the update counts agree."""
    kw = dict(optimizer=optimizer, lr=0.5 if optimizer == "adadelta" else 1e-2,
              warmup_steps=3, grad_clip=2.0, weight_decay=1e-2,
              grad_accum_steps=accum)
    tx = jax_make_optimizer(JTrainConfig(**kw))
    rng = np.random.default_rng(2)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in ((6, 4), (4,))]
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in p0]
    opt = schedules.make_optimizer(TrainConfig(**kw), tp)
    for i, scale in enumerate((3.0, 0.1, 1.0, 5.0, 0.5, 2.0)):
        lr_scale = 1.0 if i < 3 else 0.5
        g = [(rng.standard_normal(p.shape) * scale).astype(np.float32)
             for p in p0]
        before = [t.clone() for t in tp]
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = [p + lr_scale * u for p, u in zip(jp, upd)]  # solver.py:145
        norm = opt.step([torch.from_numpy(x) for x in g], lr_scale)
        assert float(norm) == pytest.approx(float(optax.global_norm(
            [jnp.asarray(x) for x in g])), rel=1e-6)
        emitted = (i + 1) % accum == 0
        if not emitted:
            assert all(torch.equal(a, b) for a, b in zip(tp, before)), i
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7, err_msg=str(i))
        assert opt.count == (i + 1) // accum
        assert opt.mini_step == (i + 1) % accum
        if accum > 1:
            assert int(state.gradient_step) == opt.count
            assert int(state.mini_step) == opt.mini_step


def test_optimizer_state_round_trips_and_refuses_a_mismatch():
    """state_dict -> load_state_dict gives an optimizer that takes the same
    next step, bit for bit (mid-accumulation); a state of another shape
    (accumulation off) raises."""
    cfg = TrainConfig(optimizer="adadelta", grad_accum_steps=3, lr=0.3)
    rng = np.random.default_rng(5)
    p0 = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for s in ((5, 3), (3,))]
    grads = [[torch.from_numpy(rng.standard_normal(p.shape).astype(
        np.float32)) for p in p0] for _ in range(4)]
    a = [p.clone() for p in p0]
    oa = schedules.make_optimizer(cfg, a)
    for g in grads[:2]:
        oa.step(g)
    b = [p.clone() for p in a]
    ob = schedules.make_optimizer(cfg, b)
    ob.load_state_dict({k: ([t.clone() for t in v] if isinstance(v, list)
                            else v) for k, v in oa.state_dict().items()})
    for g in grads[2:]:
        oa.step(g)
        ob.step(g)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert (ob.count, ob.mini_step) == (oa.count, oa.mini_step) == (1, 1)
    with pytest.raises(ValueError, match="grad_accum_steps"):
        schedules.make_optimizer(TrainConfig(optimizer="adadelta"),
                                 b).load_state_dict(oa.state_dict())
    with pytest.raises(ValueError, match="unknown optimizer"):
        schedules.make_optimizer(TrainConfig(optimizer="sgd"), b)


def test_solver_fit_logs_and_learns_on_a_tiny_model(tmp_path):
    """fit() from a loader that repeats one batch: the loss falls, the log
    records the step metrics and audio_s_per_s; dropout and SpecAugment
    draw from the Solver's generator."""
    from pytorch_end2end_speech_recognition_tpu_torch.configs.presets import (
        flagship_conformer,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.data.dataset import Batch
    from pytorch_end2end_speech_recognition_tpu_torch.data.tokenizer import (
        CharTokenizer,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.training.solver import (
        Solver,
    )

    class OneBatch:
        """A loader that yields the same batch at every cursor."""

        def __init__(self, batch):
            self.batch = batch

        def repeat(self, epoch=0, batch=0, with_cursor=False):
            while True:
                yield (epoch, batch, self.batch) if with_cursor else self.batch
                batch += 1

    cfg = flagship_conformer()
    m = cfg.model
    m.encoder_layers, m.encoder_dim, m.encoder_ffn_dim = 1, 64, 128
    m.encoder_heads, m.decoder_layers, m.decoder_dim = 2, 1, 32
    m.subsample_channels = 8
    cfg.train.schedule, cfg.train.lr, cfg.train.log_every = "constant", 3e-3, 2
    cfg.train.metrics_path = str(tmp_path / "metrics.jsonl")
    solver = Solver(cfg, CharTokenizer(charset="ABCDEFGH"), device="cpu")
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((2, 8000)) * 0.1).astype(np.float32)
    batch = Batch(audio, np.asarray([8000, 5000], np.int32),
                  np.asarray([[3, 4, 5], [6, 2, 0]], np.int32),
                  np.asarray([3, 2], np.int32))
    hist = solver.fit(OneBatch(batch), steps=6)
    assert solver.step == 6 and len(hist["loss"]) == 3
    rec = solver.log[-1]
    assert rec["step"] == 6 and rec["audio_s_per_s"] > 0
    assert set(rec) >= {"loss", "ctc_loss", "att_loss", "grad_norm"}
    assert all(np.isfinite(v) for v in rec.values())
    assert hist["loss"][-1] < hist["loss"][0]
    rows = [json.loads(r) for r in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [2, 4, 6]
    assert all(r["tag"] == "train" for r in rows)
    assert (solver.cursor_epoch, solver.cursor_batch) == (0, 6)
