"""The port's schedules, clip and optimizers against optax (as the JAX
package's `training/schedules.py` builds them), and the Solver's fit loop on
a tiny model. float32 on the CPU."""

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


def test_unported_options_raise():
    p = [torch.zeros(3)]
    with pytest.raises(NotImplementedError, match="adadelta"):
        schedules.make_optimizer(TrainConfig(optimizer="adadelta"), p)
    with pytest.raises(NotImplementedError, match="accumulation"):
        schedules.make_optimizer(TrainConfig(grad_accum_steps=2), p)


def test_solver_fit_logs_and_learns_on_a_tiny_model():
    """fit() over a list of Batch: the loss falls on a repeated batch, the
    log records the step metrics and audio_s_per_s; dropout and SpecAugment
    draw from the Solver's generator."""
    from pytorch_end2end_speech_recognition_tpu_torch.configs.presets import (
        flagship_conformer,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.data.dataset import Batch
    from pytorch_end2end_speech_recognition_tpu_torch.training.solver import (
        Solver,
    )

    cfg = flagship_conformer()
    m = cfg.model
    m.encoder_layers, m.encoder_dim, m.encoder_ffn_dim = 1, 64, 128
    m.encoder_heads, m.decoder_layers, m.decoder_dim = 2, 1, 32
    m.subsample_channels = 8
    cfg.train.schedule, cfg.train.lr, cfg.train.log_every = "constant", 3e-3, 2
    solver = Solver(cfg, 12, device="cpu")
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((2, 8000)) * 0.1).astype(np.float32)
    batch = Batch(audio, np.asarray([8000, 5000], np.int32),
                  np.asarray([[3, 4, 5], [6, 2, 0]], np.int32),
                  np.asarray([3, 2], np.int32))
    hist = solver.fit([batch] * 8, steps=6)
    assert solver.step == 6 and len(hist["loss"]) == 3
    rec = solver.log[-1]
    assert rec["step"] == 6 and rec["audio_s_per_s"] > 0
    assert set(rec) >= {"loss", "ctc_loss", "att_loss", "grad_norm"}
    assert all(np.isfinite(v) for v in rec.values())
    assert hist["loss"][-1] < hist["loss"][0]
