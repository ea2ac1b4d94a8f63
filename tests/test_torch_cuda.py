"""The CUDA kernels against their plain versions, on the card. Marked `cuda`;
each test skips (inside its fixture, never at import) where there is no
card. Run on a machine with one:
`python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider -o addopts=`
(`--noconftest`: the suite conftest imports JAX, which that machine need not have).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from pytorch_end2end_speech_recognition_tpu_torch.utils.device import set_tf32

    set_tf32(False)
    return torch.device("cuda")


@pytest.mark.parametrize("dft_dtype", [torch.float32, torch.bfloat16])
def test_logmel_kernel_matches_plain(dev, dft_dtype):
    from pytorch_end2end_speech_recognition_tpu_torch.ops import frontend as fe
    from pytorch_end2end_speech_recognition_tpu_torch.ops.frontend_kernel import (
        logmel,
        logmel_plain,
        preemph_dft_bases,
    )

    rng = np.random.default_rng(0)
    Ts = 37 * 160 + 400 + 11
    audio = torch.from_numpy(
        rng.standard_normal((3, Ts)).astype(np.float32) * 0.1).to(dev)
    basis, prev = preemph_dft_bases(*fe.dft_bases(512, 400), 0.97)
    basis = torch.from_numpy(basis).to(dev, dft_dtype)
    prev = torch.from_numpy(prev).to(dev)
    mel = torch.from_numpy(fe.mel_filterbank(80, 512, 16000)).to(dev)
    T = fe.num_frames(Ts, 400, 160)
    flens = torch.tensor([T, T // 2, 0], device=dev)
    out = logmel(audio, basis, prev, mel, 160, T, flens)
    ref = logmel_plain(audio, basis, prev, mel, 160, T, flens)
    torch.cuda.synchronize()
    assert torch.allclose(out, ref, rtol=1e-3, atol=1e-3)
    assert torch.all(out[1, T // 2:] == 0) and torch.all(out[2] == 0)


@pytest.mark.parametrize("T,P", [(70, 128), (750, 768)])
def test_toeplitz_kernel_matches_plain(dev, T, P):
    from pytorch_end2end_speech_recognition_tpu_torch.ops.attention_kernel import (
        toeplitz_dense,
        toeplitz_expand,
    )

    diag = torch.randn(6, 2 * T - 1, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        out = toeplitz_dense(diag, T, P, dt)
        assert torch.equal(out, toeplitz_expand(diag, P, P, T=T).to(dt))


@pytest.mark.parametrize("T,P", [(150, 256), (750, 768)])
@pytest.mark.parametrize("with_bias", [False, True])
def test_attention_kernel_matches_plain(dev, T, P, with_bias):
    from pytorch_end2end_speech_recognition_tpu_torch.ops.attention_kernel import (
        attention_plain,
        fused_attention,
    )

    B, H, Dh = 3, 2, 64  # 64: the head width of every attention preset
    g = torch.Generator(device="cpu").manual_seed(T)
    mk = lambda *s: (torch.randn(*s, generator=g) * 0.5).to(dev, torch.bfloat16)
    q, k, v = mk(B, T, H * Dh), mk(B, T, H * Dh), mk(B, T, H * Dh)
    bias = mk(H, P, P) if with_bias else None
    lens = torch.tensor([T, 65, 1], device=dev)
    out = fused_attention(q, k, v, bias, lens, H).float()
    ref = attention_plain(q, k, v, bias, lens, H).float()
    torch.cuda.synchronize()
    valid = (torch.arange(T, device=dev)[None, :] < lens[:, None])[..., None]
    # bf16 outputs: one bf16 rounding of the output and of p (2^-8 relative)
    assert torch.allclose(out * valid, ref * valid, rtol=2e-2, atol=2e-2)


def test_attention_kernel_rejects_other_head_dims(dev):
    from pytorch_end2end_speech_recognition_tpu_torch.ops.attention_kernel import (
        fused_attention,
    )

    q = torch.zeros(1, 8, 2 * 32, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 64"):
        fused_attention(q, q, q, None, torch.tensor([8], device=dev), 2)
