"""The port's SpecAugment against the JAX package's: the reference's mask
(and time warp draws) injected into the port give the reference's output,
and the port's own draws keep to the policy's bounds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_end2end_speech_recognition_tpu.ops.specaugment import (
    spec_augment as jax_spec_augment,
    time_warp as jax_time_warp,
)
from pytorch_end2end_speech_recognition_tpu.utils.config import (
    FrontendConfig as JFrontendConfig,
)
from pytorch_end2end_speech_recognition_tpu_torch.ops.specaugment import (
    spec_augment,
    spec_augment_mask,
    time_warp,
)
from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
    FrontendConfig,
)


def test_injected_jax_mask_reproduces_jax_output():
    rng = np.random.default_rng(0)
    B, T, F = 4, 300, 80
    feats = rng.standard_normal((B, T, F)).astype(np.float32)
    flens = np.asarray([300, 211, 57, 0], np.int32)
    jcfg = JFrontendConfig()
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax_spec_augment(key, jnp.asarray(feats),
                                       jnp.asarray(flens), jcfg))
    mask = np.array(jax_spec_augment(key, jnp.ones((B, T, F)),
                                     jnp.asarray(flens), jcfg))
    assert set(np.unique(mask)) <= {0.0, 1.0} and (mask == 0).any()
    got = spec_augment(torch.from_numpy(feats), torch.from_numpy(flens),
                       FrontendConfig(), mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(6))
def test_own_draws_respect_the_policy(seed):
    cfg = FrontendConfig()
    B, T, F = 8, 400, 80
    flens = torch.tensor([400, 390, 250, 120, 40, 19, 1, 0])
    gen = torch.Generator().manual_seed(seed)
    mask = spec_augment_mask(flens, T, F, cfg, gen)
    assert mask.shape == (B, T, F)
    assert set(mask.unique().tolist()) <= {0.0, 1.0}
    # the mask is an outer product of a time and a frequency keep-vector
    keep_f = mask.amax(dim=1).bool()                 # (B, F)
    keep_t = mask.amax(dim=2).bool()                 # (B, T)
    assert torch.equal(mask.bool(), keep_t[:, :, None] & keep_f[:, None, :])
    masked_f = (~keep_f).sum(dim=1)
    assert int(masked_f.max()) <= cfg.n_freq_masks * cfg.freq_mask_param
    max_t = torch.clamp(torch.clamp((flens * cfg.time_mask_ratio).long(),
                                    min=1), max=cfg.time_mask_param)
    masked_t = (~keep_t).sum(dim=1)
    assert bool((masked_t <= cfg.n_time_masks * max_t).all())
    t_idx = torch.arange(T)[None, :]
    # time masks lie inside each row's frames (rows with frames)
    outside = (~keep_t) & (t_idx >= flens[:, None])
    assert not outside[flens > 0].any()


def jax_warp_draws(key, flens, T, W):
    """(center, w) as JAX's time_warp draws them from `key`."""
    k1, k2 = jax.random.split(key)
    B = flens.shape[0]
    span = np.maximum(flens - 2 * W, 1)[:, None]
    r = np.array(jax.random.randint(k1, (B, 1), 0, T))
    w = np.array(jax.random.randint(k2, (B, 1), -W, W + 1))
    return torch.from_numpy(W + r % span), torch.from_numpy(w)


@pytest.mark.parametrize("seed,W", [(0, 5), (1, 5), (2, 40), (3, 80)])
def test_time_warp_matches_jax(seed, W):
    """JAX's time_warp and the port's with the draws JAX takes from the
    same key: rows long and short (under 2W + 2 frames, unchanged), a pad
    row, float32 within 1e-6 (the same formula, evaluated in the same
    order; the interpolation weights can differ in the last ulp)."""
    rng = np.random.default_rng(seed)
    B, T, F = 5, 300, 16
    feats = rng.standard_normal((B, T, F)).astype(np.float32)
    flens = np.asarray([300, 251, 2 * W + 1, 90, 0], np.int32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_time_warp(key, jnp.asarray(feats),
                                    jnp.asarray(flens), W))
    draws = jax_warp_draws(key, flens, T, W)
    got = time_warp(torch.from_numpy(feats), torch.from_numpy(flens), W,
                    draws=draws)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    short = flens < 2 * W + 2
    np.testing.assert_array_equal(got.numpy()[short], feats[short])
    assert not np.array_equal(got.numpy()[0], feats[0])


def test_spec_augment_with_time_warp_matches_jax():
    """The whole SpecAugment at time_warp_param 20 (the warp's key split
    first, as in the reference): warp draws and mask injected."""
    rng = np.random.default_rng(9)
    B, T, F = 3, 240, 80
    feats = rng.standard_normal((B, T, F)).astype(np.float32)
    flens = np.asarray([240, 150, 60], np.int32)
    jcfg = JFrontendConfig(time_warp_param=20)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax_spec_augment(key, jnp.asarray(feats),
                                       jnp.asarray(flens), jcfg))
    # the mask: SpecAugment of ones (a warp of ones is ones)
    mask = np.array(jax_spec_augment(key, jnp.ones((B, T, F)),
                                     jnp.asarray(flens), jcfg))
    assert set(np.unique(mask)) <= {0.0, 1.0}
    _, kw = jax.random.split(key)
    got = spec_augment(torch.from_numpy(feats), torch.from_numpy(flens),
                       FrontendConfig(time_warp_param=20),
                       mask=torch.from_numpy(mask),
                       warp=jax_warp_draws(kw, flens, T, 20))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_draws_differ_by_seed_and_time_warp_runs():
    """Masks differ by seed. Time warp draws from the generator: the
    draws differ by seed, stay inside each row's frames, leave short rows
    and padded frames unchanged, and a warp by w = 0 is the identity."""
    cfg = FrontendConfig()
    flens = torch.tensor([300, 200])
    a = spec_augment_mask(flens, 300, 80, cfg, torch.Generator().manual_seed(1))
    b = spec_augment_mask(flens, 300, 80, cfg, torch.Generator().manual_seed(2))
    assert not torch.equal(a, b)
    W = 5
    feats = torch.randn(3, 300, 8, generator=torch.Generator().manual_seed(0))
    flens = torch.tensor([300, 200, 2 * W + 1])
    outs = [time_warp(feats, flens, W, torch.Generator().manual_seed(s))
            for s in (1, 2)]
    assert not torch.equal(outs[0], outs[1])
    for out in outs:
        assert bool(torch.isfinite(out).all())
        assert torch.equal(out[1, 200:], feats[1, 200:])
        assert torch.equal(out[2], feats[2])
    center = torch.tensor([[150], [100], [7]])
    same = time_warp(feats, flens, W, draws=(center, torch.zeros(3, 1)))
    assert torch.equal(same, feats)
    cfg.time_warp_param = W
    warped = spec_augment(feats, flens, cfg, torch.Generator().manual_seed(1))
    assert warped.shape == feats.shape
    with pytest.raises(ValueError, match="generator"):
        time_warp(feats, flens, W)


def test_training_without_a_generator_is_refused():
    """train=True with SpecAugment or dropout on and nothing to draw from
    raises instead of quietly skipping the augmentation."""
    from pytorch_end2end_speech_recognition_tpu_torch.configs.presets import (
        flagship_conformer,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.models.asr import (
        AsrModel,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.models.encoders import (
        dropout,
    )

    x = torch.ones(2, 3)
    assert dropout(x, 0.1, None, train=False) is x
    assert dropout(x, 0.0, None, train=True) is x
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.1, None, train=True)
    cfg = flagship_conformer()
    m = cfg.model
    m.encoder_layers, m.encoder_dim, m.encoder_ffn_dim = 1, 64, 128
    m.decoder_layers, m.decoder_dim = 1, 64
    model = AsrModel(cfg, device="cpu", seed=0)
    audio, lens = torch.zeros(1, 8000), torch.tensor([8000])
    with pytest.raises(ValueError, match="spec_mask"):
        model.encode(audio, lens, train=True)
    gen = torch.Generator().manual_seed(0)
    enc, _ = model.encode(audio, lens, train=True, generator=gen)
    assert bool(torch.isfinite(enc).all())
    cfg.frontend.spec_augment = False
    model = AsrModel(cfg, device="cpu", seed=0)
    with pytest.raises(ValueError, match="Generator"):   # dropout 0.1
        model.encode(audio, lens, train=True)
