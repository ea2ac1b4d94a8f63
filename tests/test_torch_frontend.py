"""The port's log-mel front-end against the JAX package: the plain version of
the fused kernel against `logmel_pallas` (Pallas interpret mode on the CPU)
and the numpy oracle, and `Frontend` with CMVN against the JAX jnp path.
Inputs are made with numpy from a seed and handed to both packages."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pytorch_end2end_speech_recognition_tpu.ops import frontend as jfe
from pytorch_end2end_speech_recognition_tpu.ops.frontend_pallas import (
    logmel_pallas,
)
from pytorch_end2end_speech_recognition_tpu.utils.config import (
    FrontendConfig as JFrontendConfig,
)
from pytorch_end2end_speech_recognition_tpu_torch.ops import frontend as tfe
from pytorch_end2end_speech_recognition_tpu_torch.ops.frontend_kernel import (
    BAND_CHUNK,
    logmel,
    logmel_plain,
    mel_band_ranges,
    mel_plan,
    mel_ranged,
    preemph_dft_bases,
)
from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
    AsrConfig,
    FrontendConfig,
    resolve_device,
)

# log-mel tolerance: float32 sums in another order, and the preemphasis
# folded into the basis instead of applied to the samples (1e-3, as the JAX
# package holds its own kernel to the oracle)
TOL = 1e-3


def _port_bases(dft_dtype):
    cfg = FrontendConfig()
    cos_b, sin_b = tfe.dft_bases(cfg.n_fft, cfg.win_length)
    basis, prev = preemph_dft_bases(cos_b, sin_b, cfg.preemphasis)
    mel = tfe.mel_filterbank(cfg.n_mels, cfg.n_fft, cfg.sample_rate)
    dt = torch.bfloat16 if dft_dtype == "bfloat16" else torch.float32
    return (torch.from_numpy(basis).to(dt), torch.from_numpy(prev),
            torch.from_numpy(mel), cfg.hop_length)


# (samples, frame_lens as fractions of the frame count): 16000 samples give
# 98 frames; 7*160+400+37 samples give an odd count of 8 with a ragged tail
CASES = [(16000, (1.0, 1 / 3)), (7 * 160 + 400 + 37, (1.0, 0.5))]


@pytest.mark.parametrize("dft_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_samples,fracs", CASES)
def test_logmel_plain_matches_pallas_interpret(n_samples, fracs, dft_dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, n_samples)).astype(np.float32) * 0.1
    jcfg = JFrontendConfig(cmvn="none", spec_augment=False, impl="pallas",
                           dft_dtype=dft_dtype)
    fe = jfe.Frontend(jcfg)
    T = fe.n_frames(n_samples)
    flens = np.asarray([int(T * f) for f in fracs], np.int32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(logmel_pallas(
            jnp.asarray(x), fe.basis_pre, fe.basis_prev, fe.mel_b, fe.hop, T,
            jnp.asarray(flens)))
    basis, prev, mel, hop = _port_bases(dft_dtype)
    out = logmel_plain(torch.from_numpy(x), basis, prev, mel, hop, T,
                       torch.from_numpy(flens)).numpy()
    assert out.shape == ref.shape == (2, T, 80)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
    for b in range(2):
        assert np.all(out[b, flens[b]:] == 0.0)


@pytest.mark.parametrize("n_samples,fracs", CASES)
def test_logmel_plain_matches_numpy_oracle(n_samples, fracs):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, n_samples)).astype(np.float32) * 0.1
    basis, prev, mel, hop = _port_bases("float32")
    cfg = JFrontendConfig(cmvn="none")
    T = jfe.Frontend(cfg).n_frames(n_samples)
    flens = np.asarray([int(T * f) for f in fracs], np.int32)
    out = logmel_plain(torch.from_numpy(x), basis, prev, mel, hop, T,
                       torch.from_numpy(flens)).numpy()
    for b in range(2):
        ref = jfe.logmel_np(x[b], cfg)
        np.testing.assert_allclose(out[b, :flens[b]], ref[:flens[b]],
                                   rtol=TOL, atol=TOL)
        # the port's own copy of the oracle is the same function
        np.testing.assert_array_equal(tfe.logmel_np(x[b], FrontendConfig()),
                                      ref)


def test_logmel_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 8000)).astype(np.float32))
    basis, prev, mel, hop = _port_bases("float32")
    flens = torch.tensor([48, 20])
    before = logmel.launches
    a = logmel(x, basis, prev, mel, hop, 48, flens)
    b = logmel_plain(x, basis, prev, mel, hop, 48, flens)
    assert torch.equal(a, b)
    assert logmel.launches == before


def test_frontend_keeps_bf16_basis_bin_major():
    # the tensor-core kernel reads the basis as (2F, win); Frontend stores it
    # so, behind a (win, 2F) view, and the values are those of the bases
    cfg = FrontendConfig(cmvn="none", dft_dtype="bfloat16", impl="torch")
    fe = tfe.Frontend(cfg, device="cpu")
    basis, _, _, _ = _port_bases("bfloat16")
    assert fe.basis.shape == basis.shape and fe.basis.t().is_contiguous()
    assert torch.equal(fe.basis, basis)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 8000)).astype(np.float32))
    lens = torch.tensor([8000, 5000])
    feats, _ = fe(x, lens)
    ref = logmel_plain(x, basis, fe.basis_prev, fe.mel_b, fe.hop, 48,
                       fe.frame_lens(lens))
    assert torch.equal(feats, ref)


def _sparse_filterbank(seed):
    """A random (257, 80) filterbank of nonnegative weights at ~6% density,
    with an all-zero interior bin and two empty bands."""
    rng = np.random.default_rng(seed)
    mel = rng.random((257, 80)).astype(np.float32)
    mel[rng.random((257, 80)) > 0.06] = 0.0
    mel[130] = 0.0
    mel[:, [7, 41]] = 0.0
    return torch.from_numpy(mel)


@pytest.mark.parametrize("which", ["flagship", "random_sparse"])
def test_mel_band_ranges_cover_every_weight(which):
    # the tensor-core kernel sums band m over [lo[m], hi[m]] only: the
    # ranges must hold every nonzero weight, and the ranged float32 product
    # must be power @ mel_b
    if which == "flagship":
        mel = torch.from_numpy(tfe.mel_filterbank(80, 512, 16000))
    else:
        mel = _sparse_filterbank(5)
    n_bins, M = mel.shape
    lo, hi = mel_band_ranges(mel)
    k, m = torch.nonzero(mel, as_tuple=True)
    assert bool(((lo[m] <= k) & (k <= hi[m])).all())
    full = (mel != 0).any(0)
    assert torch.equal(mel[lo[full], torch.arange(M)[full]] != 0,
                       torch.ones(int(full.sum()), dtype=torch.bool))
    assert torch.equal(mel[hi[full], torch.arange(M)[full]] != 0,
                       torch.ones(int(full.sum()), dtype=torch.bool))
    assert bool((lo[~full] == n_bins).all() and (hi[~full] == -1).all())
    bands, mel_t = mel_plan(mel)
    assert bands.dtype == torch.int32 and bands.shape == (2 + 2 * M,)
    assert torch.equal(mel_t, mel.t()) and mel_t.is_contiguous()
    k_lo, n_ch = int(bands[0]), int(bands[1])
    assert k_lo == int(lo[full].min())
    assert k_lo + BAND_CHUNK * n_ch > int(hi.max()) >= k_lo + BAND_CHUNK * (n_ch - 1)
    assert torch.equal(bands[2:2 + M].long(), lo)
    assert torch.equal(bands[2 + M:].long(), hi)
    if which == "flagship":  # bin 0 carries no weight: 256 bins, 8 chunks
        assert (k_lo, n_ch) == (1, 8)
    rng = np.random.default_rng(6)
    power = torch.from_numpy(
        rng.random((3, 50, n_bins)).astype(np.float32) * 10.0 ** rng.uniform(
            -6, 2, (3, 50, 1)).astype(np.float32))
    got = mel_ranged(power, mel, lo, hi)
    want = power @ mel
    assert torch.equal(got == 0, want == 0)
    rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()
    assert rel <= 1e-6, rel


@pytest.mark.parametrize("cmvn", ["utt", "global"])
def test_frontend_matches_jax_jnp(tmp_path, cmvn):
    rng = np.random.default_rng(3)
    Ts = 16000
    x = rng.standard_normal((3, Ts)).astype(np.float32) * 0.1
    lens = np.asarray([Ts, Ts // 2, 7 * 160 + 400], np.int32)
    stats = ""
    if cmvn == "global":
        stats = str(tmp_path / "cmvn.json")
        json.dump({"mean": (rng.standard_normal(80) - 20).tolist(),
                   "std": (rng.random(80) + 0.5).tolist()}, open(stats, "w"))
    jcfg = JFrontendConfig(cmvn=cmvn, cmvn_stats_path=stats, impl="jnp",
                           dft_dtype="float32")
    ref, ref_lens = jfe.Frontend(jcfg)(jnp.asarray(x), jnp.asarray(lens))
    acfg = AsrConfig()
    acfg.frontend.cmvn, acfg.frontend.cmvn_stats_path = cmvn, stats
    tcfg = resolve_device(acfg, "cpu").frontend
    assert (tcfg.impl, tcfg.dft_dtype) == ("torch", "float32")
    feats, flens = tfe.Frontend(tcfg, device="cpu")(
        torch.from_numpy(x), torch.from_numpy(lens))
    np.testing.assert_array_equal(flens.numpy(), np.asarray(ref_lens))
    # CMVN divides by the per-row std (~3 on log-mels of noise), so the
    # log-mel tolerance holds here too
    np.testing.assert_allclose(feats.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)
