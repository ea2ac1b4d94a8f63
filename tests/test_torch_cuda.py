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


def _rel_err(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


@pytest.mark.parametrize("T,P", [(70, 128), (750, 768)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_toeplitz_reduce_kernel_matches_plain(dev, T, P, dtype):
    from pytorch_end2end_speech_recognition_tpu_torch.ops.attention_kernel import (
        toeplitz_reduce,
        toeplitz_reduce_plain,
    )

    g = torch.randn(6, P, P, device=dev).to(dtype)
    out = toeplitz_reduce(g, T)
    ref = toeplitz_reduce_plain(g, T)
    torch.cuda.synchronize()
    # float32 sums of up to T terms in another order: |err| <= T u sum|g|
    bound = T * 2.0 ** -24 * toeplitz_reduce_plain(g.abs(), T) + 1e-30
    assert out.shape == (6, 2 * T - 1)
    assert bool(((out - ref).abs() <= bound).all())


@pytest.mark.parametrize("T,P", [(150, 256), (750, 768)])
@pytest.mark.parametrize("with_bias", [False, True])
def test_attention_bwd_kernel_matches_plain(dev, T, P, with_bias):
    from pytorch_end2end_speech_recognition_tpu_torch.ops.attention_kernel import (
        attention_bwd,
        attention_bwd_plain,
        attention_fwd,
    )

    B, H, Dh = 3, 2, 64
    g_ = torch.Generator(device="cpu").manual_seed(T + with_bias)
    mk = lambda *s: (torch.randn(*s, generator=g_) * 0.5).to(dev, torch.bfloat16)
    q, k, v = mk(B, T, H * Dh), mk(B, T, H * Dh), mk(B, T, H * Dh)
    bias = (mk(H, P, P) * 4) if with_bias else None
    lens = torch.tensor([T, 65, 0], device=dev)
    # the training path's cotangent is zero on rows past a row's length
    g = mk(B, T, H * Dh) * (torch.arange(T, device=dev)[None, :, None]
                            < lens[:, None, None])
    _, lse = attention_fwd(q, k, v, bias, lens, H, with_lse=True)
    got = attention_bwd(q, k, v, bias, lens, g, lse, H)
    want = attention_bwd_plain(q, k, v, bias, lens, g, H)
    torch.cuda.synchronize()
    names = ("dq", "dk", "dv", "dbias")
    for name, a, b in zip(names, got, want):
        if b is None:
            assert a is None
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, name
        # bf16 operands and outputs on both sides, rounded at the same
        # points; sums in another order: ~2^-8 relative noise
        assert _rel_err(a, b) < 2e-2, (name, _rel_err(a, b))
    assert torch.all(got[0][2] == 0) and torch.all(got[1][2] == 0)


def test_ctc_kernels_match_plain_and_torch_ctc_loss(dev):
    import torch.nn.functional as F

    from pytorch_end2end_speech_recognition_tpu_torch.ops.ctc import (
        ctc_loss,
        lattice_inputs,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops.ctc_kernel import (
        ctc_alpha,
        ctc_alpha_plain,
        ctc_beta,
        ctc_beta_plain,
    )

    rng = np.random.default_rng(0)
    B, T, V, U = 6, 60, 12, 9
    logits = torch.from_numpy(rng.standard_normal((B, T, V)).astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(1, V, (B, U))).to(dev)
    labels[0, :4] = torch.tensor([3, 3, 5, 5])           # repeats
    label_lens = torch.tensor([U, 5, 1, U, 0, 7], device=dev)
    logit_lens = torch.tensor([T, 41, T, 8, T, 0], device=dev)  # row 3 impossible
    labels = labels * (torch.arange(U, device=dev)[None] < label_lens[:, None])
    lat, skip, sok = lattice_inputs(logits, labels, label_lens)
    alpha, ll = ctc_alpha(lat, skip, sok, logit_lens, 2 * label_lens)
    a_ref, ll_ref = ctc_alpha_plain(lat, skip, sok, logit_lens, 2 * label_lens)
    g = torch.randn(B, device=dev)
    grad = ctc_beta(lat, skip, sok, logit_lens, 2 * label_lens, alpha, ll, g)
    g_ref = ctc_beta_plain(lat, skip, sok, logit_lens, 2 * label_lens, a_ref,
                           ll_ref, g)
    torch.cuda.synchronize()
    fin = a_ref > -1e29
    assert torch.equal(fin, alpha > -1e29)
    assert torch.allclose(alpha[fin], a_ref[fin], rtol=1e-5, atol=1e-4)
    assert torch.allclose(ll, ll_ref, rtol=1e-5, atol=1e-4)
    assert torch.allclose(grad, g_ref, rtol=1e-4, atol=1e-5)
    assert float(ll[3]) <= -1e29 and torch.all(grad[3] == 0)
    # against torch's CTC on the rows a path can explain (not the pad rows
    # 4-5, nor the impossible row 3)
    x = logits.clone().requires_grad_()
    loss = ctc_loss(x, logit_lens, labels, label_lens, impl="cuda")
    loss[:3].sum().backward()
    y = logits.clone().requires_grad_()
    ref = F.ctc_loss(F.log_softmax(y, -1).transpose(0, 1), labels,
                     logit_lens, label_lens, reduction="none",
                     zero_infinity=True)
    ref[:3].sum().backward()
    assert torch.allclose(loss[:3], ref[:3], rtol=1e-5, atol=1e-4)
    assert torch.allclose(x.grad, y.grad, rtol=1e-4, atol=1e-5)
    assert float(loss[4]) == 0.0 and float(loss[5]) == 0.0
