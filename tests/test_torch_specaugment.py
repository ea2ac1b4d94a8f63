"""The port's SpecAugment against the JAX package's: the reference's mask
injected into the port gives the reference's output, and the port's own
draws keep to the policy's bounds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_end2end_speech_recognition_tpu.ops.specaugment import (
    spec_augment as jax_spec_augment,
)
from pytorch_end2end_speech_recognition_tpu.utils.config import (
    FrontendConfig as JFrontendConfig,
)
from pytorch_end2end_speech_recognition_tpu_torch.ops.specaugment import (
    spec_augment,
    spec_augment_mask,
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


def test_draws_differ_by_seed_and_time_warp_is_refused():
    cfg = FrontendConfig()
    flens = torch.tensor([300, 200])
    a = spec_augment_mask(flens, 300, 80, cfg, torch.Generator().manual_seed(1))
    b = spec_augment_mask(flens, 300, 80, cfg, torch.Generator().manual_seed(2))
    assert not torch.equal(a, b)
    cfg.time_warp_param = 5
    with pytest.raises(NotImplementedError, match="time warp"):
        spec_augment_mask(flens, 300, 80, cfg, None)


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
