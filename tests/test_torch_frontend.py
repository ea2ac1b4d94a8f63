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
    logmel,
    logmel_plain,
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
