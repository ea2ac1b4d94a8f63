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


@pytest.mark.parametrize("T,P", [(150, 256), (750, 768), (1000, 1000)])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("H", [2, 8])  # 8: rung 4's d512
def test_attention_bwd_kernel_matches_plain(dev, T, P, with_bias, H):
    """The backward kernels (delta pre-pass, main kernel with its ordered dQ
    sum, dbias) against the plain backward at T 150, 750 and 1,000 (none a
    multiple of the 64- or 128-row tiles), H 2 and 8, with lens T, 65, 0
    and 1: every row of the length-0 batch row gets zero gradients."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops.attention_kernel import (
        attention_bwd,
        attention_bwd_plain,
        attention_fwd,
    )

    B, Dh = 4, 64
    g_ = torch.Generator(device="cpu").manual_seed(T + with_bias + H)
    mk = lambda *s: (torch.randn(*s, generator=g_) * 0.5).to(dev, torch.bfloat16)
    q, k, v = mk(B, T, H * Dh), mk(B, T, H * Dh), mk(B, T, H * Dh)
    bias = (mk(H, P, P) * 4) if with_bias else None
    lens = torch.tensor([T, 65, 0, 1], device=dev)
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


@pytest.mark.parametrize("U", [64, 128, 200, 9])  # S 129, 257, 401, 19
def test_ctc_kernels_match_plain_and_torch_ctc_loss(dev, U):
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

    rng = np.random.default_rng(U)
    B, T, V = 6, 60, 12
    logits = torch.from_numpy(rng.standard_normal((B, T, V)).astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(1, V, (B, U))).to(dev)
    labels[0, :4] = torch.tensor([3, 3, 5, 5])           # repeats
    # row 2 has one frame, row 3 no path (U labels in 8 frames), row 4 no
    # labels (a pad row) and row 5 no frames
    label_lens = torch.tensor([min(U, 25), 5, 1, U, 0, 7], device=dev)
    logit_lens = torch.tensor([T, 41, 1, 8, T, 0], device=dev)
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
    # no atomics: a second launch gives the same bits
    alpha2, ll2 = ctc_alpha(lat, skip, sok, logit_lens, 2 * label_lens)
    assert torch.equal(alpha2, alpha) and torch.equal(ll2, ll)
    assert torch.equal(ctc_beta(lat, skip, sok, logit_lens, 2 * label_lens,
                                alpha, ll, g), grad)
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


def _flash_inputs(dev, B, T, H, lens, seed):
    g_ = torch.Generator(device="cpu").manual_seed(seed)
    mk = lambda *s: (torch.randn(*s, generator=g_) * 0.5).to(dev, torch.bfloat16)
    q, k, v = mk(B, T, H * 64), mk(B, T, H * 64), mk(B, T, H * 64)
    diag = (torch.randn(H, 2 * T - 1, generator=g_) * 4).to(dev)
    lens = torch.tensor(lens, device=dev)
    return q, k, v, diag, lens


@pytest.mark.parametrize("T", [150, 1000])
def test_flash_kernel_matches_plain(dev, T):
    from pytorch_end2end_speech_recognition_tpu_torch.ops.attention_kernel import (
        flash_attention,
        flash_fwd_plain,
    )

    q, k, v, diag, lens = _flash_inputs(dev, 3, T, 2, [T, 65, 1], T)
    out = flash_attention(q, k, v, diag, lens, 2).float()
    ref = flash_fwd_plain(q, k, v, diag, lens, 2).float()
    torch.cuda.synchronize()
    valid = (torch.arange(T, device=dev)[None, :] < lens[:, None])[..., None]
    # bf16 outputs: one bf16 rounding of the output and of p (2^-8 relative)
    assert torch.allclose(out * valid, ref * valid, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("T", [150, 1000, 1638])
def test_flash_bwd_kernel_matches_plain(dev, T):
    """The flash backward (diagonals) against its plain version at T 150,
    1,000 and the long-audio path's 1,638, with lens T, 65, 0 and 1."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops.attention_kernel import (
        flash_bwd,
        flash_bwd_plain,
        flash_fwd,
    )

    q, k, v, diag, lens = _flash_inputs(dev, 4, T, 2, [T, 65, 0, 1], T + 1)
    g_ = torch.Generator(device="cpu").manual_seed(T)
    # the training path's cotangent is zero on rows past a row's length
    g = (torch.randn(4, T, 128, generator=g_) * 0.5).to(dev, torch.bfloat16)
    g = g * (torch.arange(T, device=dev)[None, :, None] < lens[:, None, None])
    _, lse = flash_fwd(q, k, v, diag, lens, 2, with_lse=True)
    got = flash_bwd(q, k, v, diag, lens, g, lse, 2)
    want = flash_bwd_plain(q, k, v, diag, lens, g, 2)
    torch.cuda.synchronize()
    # dq, dk, dv: bf16 operands and outputs rounded at the same points, sums
    # in another order (~2^-8); ddiag: float32 sums of the same float32 ds
    # in another order (float32 roundings of p, ~2^-18, and of the sums)
    for name, a, b, tol in zip(("dq", "dk", "dv", "ddiag"), got, want,
                               (2e-2, 2e-2, 2e-2, 1e-4)):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _rel_err(a, b) < tol, (name, _rel_err(a, b))
    assert torch.all(got[0][2] == 0) and torch.all(got[1][2] == 0)


@pytest.mark.parametrize("flash", [False, True])
def test_attention_bwd_kernel_rejects_other_head_dims(dev, flash):
    """The backward kernels take head width 64 only: a width-48 call raises
    instead of launching (or falling back to the plain version)."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops.attention_kernel import (
        attention_bwd,
        flash_bwd,
    )

    q = torch.zeros(1, 70, 96, device=dev, dtype=torch.bfloat16)
    lens = torch.tensor([70], device=dev)
    lse = torch.zeros(1, 2, 70, device=dev)
    with pytest.raises(ValueError, match="head dim 64"):
        if flash:
            diag = torch.zeros(2, 139, device=dev)
            flash_bwd(q, q, q, diag, lens, q, lse, 2)
        else:
            attention_bwd(q, q, q, None, lens, q, lse, 2)


def test_flash_kernel_rejects_a_dense_or_bf16_bias(dev):
    from pytorch_end2end_speech_recognition_tpu_torch.ops.attention_kernel import (
        flash_fwd,
    )

    q, k, v, diag, lens = _flash_inputs(dev, 1, 70, 2, [70], 0)
    for bad in (diag.to(torch.bfloat16), diag[:, :-1],
                torch.zeros(2, 70, 70, device=dev), None):
        with pytest.raises(ValueError, match="diag"):
            flash_fwd(q, k, v, bad, lens, 2)


def _lstm_inputs(dev, B, T, D, H, seed, dirs=None):
    """xg, whh, lens and a cotangent g; with `dirs`, D stacked directions
    ((dirs, B, T, 4H) ...)."""
    g_ = torch.Generator(device="cpu").manual_seed(seed)
    u = lambda *s, a: ((torch.rand(*s, generator=g_) * 2 - 1) * a).to(dev)  # noqa: E731
    lead = () if dirs is None else (dirs,)
    wih = u(*lead, D, 4 * H, a=D ** -0.5)
    xg = torch.randn(*lead, B, T, D, generator=g_).to(dev) @ (
        wih if dirs is None else wih[:, None])
    xg[..., H:2 * H] += 1.0  # the forget-gate bias of the init
    whh = u(*lead, H, 4 * H, a=H ** -0.5)
    lens = torch.randint(1, T + 1, (B,), generator=g_).to(dev)
    lens[0], lens[1] = T, 0
    return xg, whh, lens, torch.randn(*lead, B, T, H, generator=g_).to(dev)


def _lstm_close(name, a, b, mag=None):
    """float32 on both sides, sums in another order (chip_smoke.py
    LSTM_TOL): |a - b| <= 2^-16 (|b| + m), m the largest |b| or `mag`."""
    m = b.abs().max() if mag is None else mag
    assert torch.all((a - b).abs() <= 2.0 ** -16 * (b.abs() + m)), name


@pytest.mark.parametrize("B,T,D,H", [(4, 37, 12, 16), (3, 200, 64, 320)])
def test_lstm_kernels_match_plain(dev, B, T, D, H):
    """One direction (`lstm_seq_fwd`/`lstm_seq_bwd`, the counterparts of
    `lstm_seq_pallas`) against the single-direction plain versions."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops.rnn_kernel import (
        lstm_seq_bwd,
        lstm_seq_bwd_plain,
        lstm_seq_fwd,
        lstm_seq_fwd_plain,
    )

    xg, whh, lens, g = _lstm_inputs(dev, B, T, D, H, T)
    h, c = lstm_seq_fwd(xg, whh, lens)
    hp, cp = lstm_seq_fwd_plain(xg, whh, lens)
    dx, dw = lstm_seq_bwd(xg, whh, lens, hp, cp, g)
    dxp, dwp = lstm_seq_bwd_plain(xg, whh, lens, hp, cp, g)
    torch.cuda.synchronize()
    for name, a, b in (("h", h, hp), ("c", c, cp), ("dxg", dx, dxp)):
        assert (a - b).abs().max() <= 2.0 ** -16 * (1 + b.abs().max()), name
    assert _rel_err(dw, dwp) < 1e-5
    assert torch.all(h[1] == 0) and torch.all(dx[1] == 0)
    assert torch.all(h[2, int(lens[2]):] == 0)


# both rungs' layer 0 (an4_ctc 8 s, wsj_las 16 s after the VGG front), a deep
# pyramid layer (wsj_las layer 3 at 16 s: T 50) and a narrow width
@pytest.mark.parametrize("B,T,D,H", [(32, 800, 80, 256), (32, 400, 2560, 320),
                                     (32, 50, 640, 320), (5, 23, 12, 16)])
def test_lstm_two_direction_kernels_match_plain(dev, B, T, D, H):
    """Both directions in one launch against the plain versions (the
    backward's: its three parts composed), every element to 2^-16 (|plain|
    + m); the zero-length row and the steps past each length are zero;
    two backward launches give the same bits."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops.rnn_kernel import (
        lstm_bwd,
        lstm_bwd_plain,
        lstm_fwd,
        lstm_fwd_plain,
    )

    xg, whh, lens, g = _lstm_inputs(dev, B, T, D, H, T + H, dirs=2)
    h, c = lstm_fwd(xg, whh, lens)
    hp, cp = lstm_fwd_plain(xg, whh, lens)
    dx, dw = lstm_bwd(xg, whh, lens, hp, cp, g)
    dx2, dw2 = lstm_bwd(xg, whh, lens, hp, cp, g)
    dxp, dwp = lstm_bwd_plain(xg, whh, lens, hp, cp, g)
    torch.cuda.synchronize()
    hprev = torch.nn.functional.pad(hp, (0, 0, 1, 0))[..., :T, :]
    m_dw = (hprev.abs().reshape(2, -1, H).transpose(1, 2)
            @ dxp.abs().reshape(2, -1, 4 * H))
    for name, a, b, m in (("h", h, hp, None), ("c", c, cp, None),
                          ("dxg", dx, dxp, None), ("dW_hh", dw, dwp, m_dw)):
        _lstm_close(name, a, b, m)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    assert torch.all(h[:, 1] == 0) and torch.all(dx[:, 1] == 0)
    for d in range(2):
        assert torch.all(h[d, 2, int(lens[2]):] == 0)
        assert torch.all(dx[d, 2, int(lens[2]):] == 0)


def test_lstm_kernels_raise_on_what_they_do_not_take(dev):
    """No fallback: a width that is not a multiple of 4, a bf16 input, a
    W_hh of the wrong direction count, and a width whose W_hh slice fits no
    cluster's shared memory all raise. A batch of 512 rows at H 320 runs:
    its clusters take more than one wave."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops.rnn_kernel import (
        lstm_fwd,
        lstm_fwd_plain,
        lstm_seq_fwd,
    )

    xg, whh, lens, _ = _lstm_inputs(dev, 2, 5, 8, 16, 0)
    with pytest.raises(TypeError, match="multiple of 4"):
        lstm_seq_fwd(torch.zeros(2, 5, 72, device=dev),
                     torch.zeros(18, 72, device=dev), lens)
    with pytest.raises(TypeError, match="float32"):
        lstm_seq_fwd(xg.to(torch.bfloat16), whh, lens)
    with pytest.raises(ValueError, match="whh"):
        lstm_fwd(xg[None], torch.stack([whh, whh]), lens)
    # H 1,032: no cluster size leaves a multiple of 8 units a block whose
    # W_hh columns fit 227 KB
    xg, whh, lens, _ = _lstm_inputs(dev, 2, 3, 8, 1032, 1)
    with pytest.raises(RuntimeError, match="lstm_fwd"):
        lstm_seq_fwd(xg, whh, lens)
    xg, whh, lens, _ = _lstm_inputs(dev, 512, 3, 8, 320, 1, dirs=2)
    h, c = lstm_fwd(xg, whh, lens)
    hp, cp = lstm_fwd_plain(xg, whh, lens)
    _lstm_close("h", h, hp)
    _lstm_close("c", c, cp)


def _ffn_inputs(dev, R, D, F, x_dtype, seed):
    """x, gamma, beta, w1 (F, D), b1, w2 (D, F), b2 and a cotangent g: the
    weights bf16 at the init's scale, x and g of x_dtype."""
    g_ = torch.Generator(device="cpu").manual_seed(seed)
    r = lambda *s, k=1.0, c=0.0: c + k * torch.randn(*s, generator=g_)  # noqa: E731
    bf = torch.bfloat16
    return (r(R, D).to(dev, x_dtype), r(D, k=0.1, c=1.0).to(dev),
            r(D, k=0.1).to(dev), r(F, D, k=D ** -0.5).to(dev, bf),
            r(F, k=0.1).to(dev, bf), r(D, F, k=F ** -0.5).to(dev, bf),
            r(D, k=0.1).to(dev, bf), r(R, D).to(dev, x_dtype))


@pytest.mark.parametrize("R,D,F,x_dtype,rate", [
    (1000, 256, 1024, torch.bfloat16, 0.0),
    (65, 256, 1024, torch.bfloat16, 0.0),
    (23977, 256, 1024, torch.bfloat16, 0.1),
    (777, 256, 1024, torch.float32, 0.1),
    (200, 256, 256, torch.bfloat16, 0.1),
    (300, 512, 2048, torch.bfloat16, 0.1)])
def test_ffn_kernels_match_plain(dev, R, D, F, x_dtype, rate):
    """The fused FFN forward and backward against their plain versions on
    the same inputs and seed, ragged R (a partial last row tile): out and
    the seven gradients within 1e-2 relative (bf16 operands rounded at the
    same points, float32 sums in other orders), their dtypes the plain
    versions'; the backward seeded with seed + 1 does not pass."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops.ffn_kernel import (
        ffn_bwd,
        ffn_bwd_plain,
        ffn_fwd,
        ffn_fwd_plain,
    )

    *args, g = _ffn_inputs(dev, R, D, F, x_dtype, R)
    seed = torch.tensor([4321], dtype=torch.int32, device=dev)
    out = ffn_fwd(*args, seed, rate, 0.5)
    ref = ffn_fwd_plain(*args, seed, rate, 0.5)
    got = ffn_bwd(args[0], g, *args[1:], seed, rate, 0.5)
    want = ffn_bwd_plain(args[0], g, *args[1:], seed, rate, 0.5)
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype == x_dtype
    assert _rel_err(out - args[0], ref - args[0]) < 1e-2
    for name, a, b in zip(("dx", "dgamma", "dbeta", "dw1", "db1", "dw2",
                           "db2"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _rel_err(a, b) < 1e-2, (name, _rel_err(a, b))
    if rate > 0:
        bad = ffn_bwd(args[0], g, *args[1:], seed + 1, rate, 0.5)
        assert _rel_err(bad[6], want[6]) > 2e-2


def test_ffn_kernel_masks_are_the_plain_mask(dev):
    """The forward's mask, read as out = 0 + 1 * keep * (0 W2 + 1) at x = 0
    float32, equals `keep_multiplier` exactly; the backward's, read row by
    row from db2 = sum_r 0.5 g keep with g one-hot in rows 0, 63, 64 and the
    last (ragged) row, is the same mask."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops.ffn_kernel import (
        ffn_bwd,
        ffn_fwd,
        keep_multiplier,
    )

    R, D, F, rate = 333, 256, 1024, 0.1
    x, gamma, beta, w1, b1, w2, b2, _ = _ffn_inputs(dev, R, D, F,
                                                    torch.float32, 1)
    seed = torch.tensor([99], dtype=torch.int32, device=dev)
    mask = keep_multiplier(seed, torch.arange(R, device=dev), D, rate)
    out = ffn_fwd(torch.zeros_like(x), gamma, beta, w1, b1,
                  torch.zeros_like(w2), torch.ones_like(b2), seed, rate, 1.0)
    torch.cuda.synchronize()
    assert torch.equal(out, mask)
    for r in (0, 63, 64, R - 1):
        g = torch.zeros_like(x)
        g[r] = 1.0
        db2 = ffn_bwd(x, g, gamma, beta, w1, b1, w2, b2, seed, rate, 0.5)[6]
        assert torch.equal(db2 != 0, mask[r] != 0), r
        assert torch.allclose(db2.float(), 0.5 * mask[r], rtol=2 ** -7)


def test_ffn_kernels_raise_on_what_they_do_not_take(dev):
    """No fallback: float32 weights, D 128, and F not a multiple of 64
    raise."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops.ffn_kernel import (
        ffn_fwd,
    )

    x, gamma, beta, w1, b1, w2, b2, _ = _ffn_inputs(dev, 10, 256, 256,
                                                    torch.bfloat16, 2)
    seed = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="w1"):
        ffn_fwd(x, gamma, beta, w1.float(), b1, w2, b2, seed, 0.0, 1.0)
    with pytest.raises(ValueError, match="D 256 or 512"):
        ffn_fwd(x[:, :128], gamma[:128], beta[:128], w1[:, :128], b1,
                w2[:128], b2[:128], seed, 0.0, 1.0)
    with pytest.raises(ValueError, match="multiple of 64"):
        ffn_fwd(x, gamma, beta, w1[:200], b1[:200], w2[:, :200], b2, seed,
                0.0, 1.0)


@pytest.mark.parametrize("R", [1, 127, 128, 24000 - 37])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_ffn_bwd_wgmma_matches_plain_and_repeats(dev, R, rate):
    """The D-256 backward (launch A's row tiles, launch B's split products,
    launch C's ordered sums) against its plain version at row counts that
    leave a tile one row, a ragged tile and a full one: the seven gradients
    within 1e-2 relative, in the plain versions' dtypes; two launches on
    the same inputs give the same bits in every output."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops.ffn_kernel import (
        ffn_bwd,
        ffn_bwd_plain,
    )

    *args, g = _ffn_inputs(dev, R, 256, 1024, torch.bfloat16, R + 11)
    seed = torch.tensor([777], dtype=torch.int32, device=dev)
    got = ffn_bwd(args[0], g, *args[1:], seed, rate, 0.5)
    again = ffn_bwd(args[0], g, *args[1:], seed, rate, 0.5)
    want = ffn_bwd_plain(args[0], g, *args[1:], seed, rate, 0.5)
    torch.cuda.synchronize()
    for name, a, b, c in zip(("dx", "dgamma", "dbeta", "dw1", "db1", "dw2",
                              "db2"), got, want, again):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert bool(torch.isfinite(a.float()).all()), name
        assert _rel_err(a, b) < 1e-2, (name, _rel_err(a, b))
        assert int((_bits(a) != _bits(c)).sum()) == 0, name


def _logmel_case(dev, case):
    """(audio, bf16 basis, basis_prev, filterbank, hop, n_frames, lens) for
    the tensor-core log-mel cases: fewer frames than a tile; a random dense
    filterbank (every bin of every band nonzero); the flagship filterbank
    with one interior bin zeroed in every band."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops import frontend as fe
    from pytorch_end2end_speech_recognition_tpu_torch.ops.frontend_kernel import (
        preemph_dft_bases,
    )

    rng = np.random.default_rng({"short": 1, "dense": 2, "zero_bin": 3}[case])
    T = 100 if case == "short" else 300
    Ts = (T - 1) * 160 + 400 + 77
    seg = rng.standard_normal((4, Ts)).astype(np.float32)
    seg *= 10.0 ** rng.uniform(-3, 0, (4, 1)).astype(np.float32)
    audio = torch.from_numpy(seg).to(dev)
    basis, prev = preemph_dft_bases(*fe.dft_bases(512, 400), 0.97)
    mel = fe.mel_filterbank(80, 512, 16000)
    if case == "dense":
        mel = rng.random(mel.shape).astype(np.float32) * 0.1 + 0.01
    elif case == "zero_bin":
        mel[100] = 0.0
    lens = torch.tensor([T, 0, T // 3, 129 if T > 129 else T - 1], device=dev)
    return (audio, torch.from_numpy(basis).to(dev, torch.bfloat16),
            torch.from_numpy(prev).to(dev), torch.from_numpy(mel).to(dev),
            160, T, lens)


@pytest.mark.parametrize("case", ["short", "dense", "zero_bin"])
def test_logmel_wgmma_kernel_cases(dev, case):
    """The bf16 log-mel kernel against its plain version within 1e-3 (the
    float32 sums in another order, in the log domain), exact zeros past
    each row's length (a zero-length row included), and two launches with
    the same bits."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops.frontend_kernel import (
        logmel,
        logmel_plain,
    )

    args = _logmel_case(dev, case)
    out = logmel(*args)
    again = logmel(*args)
    ref = logmel_plain(*args)
    torch.cuda.synchronize()
    assert torch.allclose(out, ref, rtol=1e-3, atol=1e-3), (
        (out - ref).abs().max().item())
    lens = args[-1].tolist()
    for b, n in enumerate(lens):
        assert torch.all(out[b, n:] == 0)
    assert int((_bits(out) != _bits(again)).sum()) == 0


def test_logmel_wgmma_kernel_raises_on_a_long_window(dev):
    """No fallback: a window past the kernel's 448 samples raises."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops.frontend_kernel import (
        logmel,
    )

    audio = torch.zeros(1, 4000, device=dev)
    basis = torch.zeros(512, 2 * 257, device=dev, dtype=torch.bfloat16)
    prev = torch.zeros(1, 2 * 257, device=dev)
    mel = torch.ones(257, 80, device=dev)
    with pytest.raises(ValueError, match="at most 448"):
        logmel(audio, basis, prev, mel, 160, 10, torch.tensor([10], device=dev))


def _attn_excess(out, ref, ref_absv, lens):
    """Share of valid elements beyond 2^-7 |plain| + 2^-6 p.|v| (one bf16
    rounding of the output and of e or p on each side)."""
    T = out.shape[1]
    valid = (torch.arange(T, device=out.device)[None, :] < lens[:, None])[..., None]
    over = ((out.float() - ref.float()).abs()
            > 2.0 ** -7 * ref.float().abs() + 2.0 ** -6 * ref_absv.float())
    return float((over & valid).sum()) / float(valid.expand_as(over).sum())


@pytest.mark.parametrize("T", [750, 1638])
@pytest.mark.parametrize("path", ["dense", "flash"])
def test_attention_forward_ragged(dev, T, path):
    """The wgmma forward (dense bias and diagonals) against its plain
    version at T 750 and 1,638 (not multiples of the 128-query tile), with
    ragged lengths and a row of length 0 (output 0, lse +inf): every valid
    element within the bf16 bound. A tile that read or stored past T would
    reach the next batch row, whose outputs are checked too."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops.attention_kernel import (
        attention_fwd,
        attention_plain,
        flash_fwd,
        flash_fwd_plain,
        toeplitz_expand,
    )

    H = 4
    lens_l = [T, T - 13, 0, 129, 1]
    q, k, v, diag, lens = _flash_inputs(dev, len(lens_l), T, H, lens_l, T)
    if path == "dense":
        P = -(-T // 8) * 8
        bias = toeplitz_expand(diag, P, P, T=T).to(torch.bfloat16)
        out, lse = attention_fwd(q, k, v, bias, lens, H, with_lse=True)
        ref = attention_plain(q, k, v, bias, lens, H)
        ref_v = attention_plain(q, k, v.abs(), bias, lens, H)
    else:
        out, lse = flash_fwd(q, k, v, diag, lens, H, with_lse=True)
        ref = flash_fwd_plain(q, k, v, diag, lens, H)
        ref_v = flash_fwd_plain(q, k, v.abs(), diag, lens, H)
    torch.cuda.synchronize()
    assert _attn_excess(out, ref, ref_v, lens) == 0.0
    assert torch.all(out[2] == 0) and torch.all(torch.isinf(lse[2]))
    assert bool(torch.isfinite(lse[[0, 1, 3, 4]]).all())


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("kind", ["attention", "attention_h8", "flash",
                                  "toeplitz"])
def test_gradient_sums_are_deterministic(dev, kind):
    """Two launches of the dense attention backward (dbias summed over the
    batch), the flash backward (ddiag) and the Toeplitz reduce on the same
    inputs give the same bits in every output: the sums have one fixed
    order, no atomics."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops.attention_kernel import (
        attention_bwd,
        attention_fwd,
        flash_bwd,
        flash_fwd,
        toeplitz_expand,
        toeplitz_reduce,
    )

    g_ = torch.Generator(device="cpu").manual_seed(5)
    if kind == "toeplitz":
        g = torch.randn(48, 768, 768, generator=g_).to(dev, torch.bfloat16)
        runs = [(toeplitz_reduce(g, 750),) for _ in range(2)]
    else:
        T = 1638 if kind == "flash" else 750
        H = 8 if kind == "attention_h8" else 4  # 8: rung 4's d512
        lens_l = [T, T - 50, 3, 0, 700, 64, 65, T, 1, 129]
        q, k, v, diag, lens = _flash_inputs(dev, len(lens_l), T, H, lens_l, 9)
        g = (torch.randn(*q.shape, generator=g_) * 0.5).to(dev, torch.bfloat16)
        g = g * (torch.arange(T, device=dev)[None, :, None]
                 < lens[:, None, None])
        if kind != "flash":
            bias = toeplitz_expand(diag, 768, 768, T=T).to(torch.bfloat16)
            _, lse = attention_fwd(q, k, v, bias, lens, H, with_lse=True)
            runs = [attention_bwd(q, k, v, bias, lens, g, lse, H)
                    for _ in range(2)]
        else:
            _, lse = flash_fwd(q, k, v, diag, lens, H, with_lse=True)
            runs = [flash_bwd(q, k, v, diag, lens, g, lse, H)
                    for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert int((_bits(a) != _bits(b)).sum()) == 0


@pytest.mark.parametrize("N,T,P", [(48, 750, 768), (128, 750, 768),
                                   (5, 99, 128), (6, 37, 41), (3, 100, 1100)])
def test_toeplitz_expand_is_bit_identical(dev, N, T, P):
    """The redesigned expand (shifted copies in shared memory, 16-byte
    stores) at the flagship's N 48 and rung 4's N 128, an odd T with a pad
    band, a P that is no multiple of 8 (the element-wise store path) and a
    P past one 1,024-column item: the plain expansion's bits, bf16 and
    float32, pad band included."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops.attention_kernel import (
        toeplitz_expand,
        toeplitz_fwd,
    )

    g = torch.Generator(device="cpu").manual_seed(N + T)
    diag = (torch.randn(N, 2 * T - 1, generator=g) * 4).to(dev)
    for dt in (torch.bfloat16, torch.float32):
        out = toeplitz_fwd(diag, T, P, dt)
        ref = toeplitz_expand(diag, P, P, T=T).to(dt)
        torch.cuda.synchronize()
        assert int((_bits(out) != _bits(ref)).sum()) == 0, dt


@pytest.mark.parametrize("N,T,P", [(48, 750, 768), (128, 750, 768),
                                   (5, 99, 128), (6, 37, 41), (2, 1, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_toeplitz_reduce_repeats_and_ignores_the_pad_band(dev, N, T, P,
                                                           dtype):
    """The redesigned reduce (a band of diagonals a two-block cluster, each
    block half its rows by cp.async tiles; the element-wise kernel where P
    makes rows unaligned): within T u sum|g| of the plain sums, two
    launches bit for bit, and the same bits with a random pad band as with
    a zero one."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops.attention_kernel import (
        toeplitz_reduce,
        toeplitz_reduce_plain,
    )

    g_ = torch.Generator(device="cpu").manual_seed(N * T)
    noisy = torch.randn(N, P, P, generator=g_).to(dev, dtype)
    g = torch.zeros_like(noisy)
    g[:, :T, :T] = noisy[:, :T, :T]
    out = toeplitz_reduce(g, T)
    again = toeplitz_reduce(g, T)
    padded = toeplitz_reduce(noisy, T)
    ref = toeplitz_reduce_plain(g, T)
    torch.cuda.synchronize()
    bound = T * 2.0 ** -24 * toeplitz_reduce_plain(g.abs(), T) + 1e-30
    assert bool(((out - ref).abs() <= bound).all())
    assert int((_bits(out) != _bits(again)).sum()) == 0
    assert int((_bits(out) != _bits(padded)).sum()) == 0


@pytest.mark.parametrize("B,T,V,K,C", [(3, 750, 1024, 10, 40),
                                       (4, 50, 32, 10, 30), (2, 7, 12, 3, 5)])
def test_prefix_kernels_match_plain(dev, B, T, V, K, C):
    """The CTC prefix kernels against their plain versions on rows of T,
    1 and 0 frames (pad frames blank-certain), a dead hypothesis and a
    candidate repeating the last token: psi and the kept columns within T'
    2^-22 (1 + |plain|) (see chip_smoke.py PREFIX_STEP_TOL), two launches
    bit for bit."""
    from pytorch_end2end_speech_recognition_tpu_torch.decode.beam import (
        blank_padded,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops import ctc_prefix as cp

    g = torch.Generator(device="cpu").manual_seed(T)
    logp = torch.log_softmax(torch.randn(B, T, V, generator=g) * 2, -1)
    lens = torch.tensor([T, 1, 0, T // 2][:B])
    lp = blank_padded(logp, lens).to(dev)
    r = (torch.randn(B, K, T, 2, generator=g).cumsum(2) - 5.0)
    r[0, K - 1] = cp.NEG_INF
    last = torch.randint(2, V, (B, K), generator=g)
    lengths = torch.randint(0, 3, (B, K), generator=g)
    last[lengths == 0] = 1
    cand = torch.stack([torch.randperm(V - 2, generator=g)[:C] + 2
                        for _ in range(B * K)]).reshape(B, K, C)
    cand[:, :, 0] = torch.where(lengths > 0, last, cand[:, :, 0])
    parent = torch.randint(0, K, (B, K), generator=g)
    is_ext = torch.rand(B, K, generator=g) < 0.7
    tok = cand.gather(1, parent[..., None].expand(B, K, C))[:, :, 1]
    r, last, lengths, cand, parent, is_ext, tok = (
        t.to(dev) for t in (r, last, lengths, cand, parent, is_ext, tok))
    tol = T * 2.0 ** -22
    psi = cp.ctc_prefix_score(lp, r, last, lengths, cand)
    want = cp.prefix_recursion_plain(lp, r, cand, last, lengths)[0]
    cols = cp.ctc_prefix_select(lp, r, last, lengths, parent, tok, is_ext)
    want_cols = cp.prefix_select_plain(lp, r, last, lengths, parent, tok,
                                       is_ext)
    torch.cuda.synchronize()
    assert bool(((psi - want).abs() <= tol * (1 + want.abs())).all())
    assert bool(((cols - want_cols).abs() <= tol * (1 + want_cols.abs())).all())
    assert torch.equal(psi, cp.ctc_prefix_score(lp, r, last, lengths, cand))
    assert torch.equal(cols, cp.ctc_prefix_select(lp, r, last, lengths,
                                                  parent, tok, is_ext))


def _small_beam_model(dev, decoder="transformer", lm_type="lstm"):
    """A 2-layer conformer with a 2-layer `decoder` and a small LM of
    `lm_type` (None: no LM) on the card, from seeds."""
    from pytorch_end2end_speech_recognition_tpu_torch.models.asr import AsrModel
    from pytorch_end2end_speech_recognition_tpu_torch.models.lm import build_lm
    from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
        AsrConfig,
    )

    cfg = AsrConfig()
    m = cfg.model
    m.encoder, m.encoder_layers, m.encoder_dim, m.encoder_heads = (
        "conformer", 2, 128, 2)
    m.encoder_ffn_dim, m.subsample_channels = 256, 32
    m.decoder, m.decoder_layers, m.decoder_dim, m.decoder_heads = (
        decoder, 2, 128, 2)
    m.vocab_size, m.lm_dim, m.lm_embed_dim = 40, 64, 32
    m.lm_type, m.lm_heads = lm_type or "lstm", 2
    model = AsrModel(cfg, device=dev, seed=0).eval()
    lm = (build_lm(model.cfg.model, device=dev, seed=1).eval()
          if lm_type else None)
    g = torch.Generator(device="cpu").manual_seed(0)
    audio = (torch.randn(3, 48000, generator=g) * 0.1).to(dev)
    lens = torch.tensor([48000, 20000, 9000], device=dev)
    return model, lm, audio, lens


def test_beam_decode_on_the_kernels_matches_the_plain_prefix_scorer(dev):
    """A small transformer-decoder model with an RnnLm on the card: the beam
    search with the prefix kernels and with the plain recursion give the
    same N-best, and the kernels launch once each a token step."""
    from pytorch_end2end_speech_recognition_tpu_torch.decode.beam import (
        BeamSearchDecoder,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops import ctc_prefix as cp
    from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
        DecodeConfig,
    )

    model, lm, audio, lens = _small_beam_model(dev)
    dcfg = DecodeConfig(beam_size=4, pre_beam_k=8, lm_weight=0.3,
                        max_decode_ratio=0.2)
    kern = BeamSearchDecoder(model, dcfg, lm=lm)
    enc, elens, logp = kern.encode(audio, lens)
    max_len = max(4, int(0.2 * enc.shape[1]))
    before = (cp.ctc_prefix_score.launches, cp.ctc_prefix_select.launches)
    out = kern.search_arrays(enc, elens, logp, max_len)
    torch.cuda.synchronize()
    n = out["steps"]
    assert (cp.ctc_prefix_score.launches - before[0],
            cp.ctc_prefix_select.launches - before[1]) == (n, n)
    ref = BeamSearchDecoder(model, dcfg, lm=lm, prefix_impl="torch") \
        .search_arrays(enc, elens, logp, max_len)
    for key in ("tokens", "lengths", "finished"):
        assert torch.equal(out[key], ref[key]), key
    assert torch.allclose(out["scores"], ref["scores"], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("decoder,lm_type", [("transformer", "lstm"),
                                             ("transformer", "transformer"),
                                             ("lstm", None)])
def test_beam_token_loop_never_syncs_the_host(dev, decoder, lm_type):
    """SYNC_EVERY token steps (the loop's first test of "all finished"
    comes after them) under the sync debugger's error mode: any host sync
    in a step, a blocking copy from the host included, raises. The first
    search builds what a process builds once (the PE tables, the kernel
    library); a .item() under the same mode must raise."""
    from pytorch_end2end_speech_recognition_tpu_torch.decode import beam
    from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
        DecodeConfig,
    )

    model, lm, audio, lens = _small_beam_model(dev, decoder, lm_type)
    bsd = beam.BeamSearchDecoder(model, DecodeConfig(
        beam_size=4, pre_beam_k=8, lm_weight=0.3 if lm else 0.0,
        coverage_penalty=0.1), lm=lm)
    enc, elens, logp = bsd.encode(audio, lens)
    bsd.search_arrays(enc, elens, logp, beam.SYNC_EVERY)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):
            torch.ones((), device=dev).item()
        out = bsd.search_arrays(enc, elens, logp, beam.SYNC_EVERY)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out["steps"] == beam.SYNC_EVERY


@pytest.mark.parametrize("B,T,V,K,C", [(1, 256, 1024, 10, 40),
                                       (2, 24, 12, 3, 5)])
def test_prefix_kernels_with_r_init_match_plain(dev, B, T, V, K, C):
    """The prefix kernels at the streaming beam's window: r[-1] is each
    hypothesis's pre-window column r_init (B, K, 2), here random and
    finite; psi and the kept columns within T' 2^-22 (1 + |plain|) of the
    plain versions given the same r_init, two launches bit for bit. The
    control, the kernels without r_init, must leave that bound."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops import ctc_prefix as cp

    g = torch.Generator(device="cpu").manual_seed(T + 1)
    lp = torch.log_softmax(torch.randn(B, T, V, generator=g) * 2, -1)
    r = torch.randn(B, K, T, 2, generator=g).cumsum(2) - 5.0
    r_init = torch.log_softmax(torch.randn(B, K, 2, generator=g), -1) - 1.0
    last = torch.randint(2, V, (B, K), generator=g)
    lengths = torch.randint(1, 4, (B, K), generator=g)
    cand = torch.stack([torch.randperm(V - 2, generator=g)[:C] + 2
                        for _ in range(B * K)]).reshape(B, K, C)
    cand[:, :, 0] = last
    parent = torch.randint(0, K, (B, K), generator=g)
    is_ext = torch.rand(B, K, generator=g) < 0.7
    tok = cand.gather(1, parent[..., None].expand(B, K, C))[:, :, 1]
    lp, r, r_init, last, lengths, cand, parent, is_ext, tok = (
        t.to(dev) for t in (lp, r, r_init, last, lengths, cand, parent,
                            is_ext, tok))
    tol = T * 2.0 ** -22

    def excess(got, want):
        return ((got - want).abs() / (tol * (1 + want.abs()))).max().item()

    psi = cp.ctc_prefix_score(lp, r, last, lengths, cand, r_init)
    want = cp.prefix_recursion_plain(lp, r, cand, last, lengths,
                                     r_init=r_init)[0]
    cols = cp.ctc_prefix_select(lp, r, last, lengths, parent, tok, is_ext,
                                r_init)
    want_cols = cp.prefix_select_plain(lp, r, last, lengths, parent, tok,
                                       is_ext, r_init=r_init)
    torch.cuda.synchronize()
    assert excess(psi, want) <= 1.0 and excess(cols, want_cols) <= 1.0
    assert torch.equal(psi, cp.ctc_prefix_score(lp, r, last, lengths, cand,
                                                r_init))
    assert torch.equal(cols, cp.ctc_prefix_select(
        lp, r, last, lengths, parent, tok, is_ext, r_init))
    assert excess(cp.ctc_prefix_score(lp, r, last, lengths, cand), want) > 1
    assert excess(cp.ctc_prefix_select(lp, r, last, lengths, parent, tok,
                                       is_ext), want_cols) > 1


def _chunks(model, audio, lens, C):
    """The encoder output and CTC log-probs of row 0 in chunks of C frames
    (enc (1, C, D), logp (1, C, V), valid frames, final)."""
    with torch.inference_mode():
        enc, elens = model.encode(audio[:1], lens[:1])
        logp = torch.log_softmax(model.ctc_logits(enc), -1)
    T = int(elens[0])
    out = []
    for s in range(0, T, C):
        n = min(C, T - s)
        e = torch.zeros((1, C, enc.shape[2]), device=enc.device)
        lp = torch.zeros((1, C, logp.shape[2]), device=enc.device)
        e[0, :n], lp[0, :n] = enc[0, s:s + n].float(), logp[0, s:s + n]
        out.append((e, lp, torch.full((1,), n, device=enc.device),
                    s + C >= T))
    return out


def test_chunk_beam_on_the_kernels_matches_the_plain_prefix_scorer(dev):
    """The streaming beam (small transformer-decoder model, RnnLm) fed the
    same chunks with the prefix kernels and with the plain recursion: after
    every advance the same tokens, lengths and finished flags, scores within
    1e-4; one score and one select launch a token step."""
    from pytorch_end2end_speech_recognition_tpu_torch.decode.chunk_beam import (
        ChunkBeamDecoder,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops import ctc_prefix as cp
    from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
        DecodeConfig,
    )

    model, lm, audio, lens = _small_beam_model(dev)
    dcfg = DecodeConfig(beam_size=4, pre_beam_k=8, lm_weight=0.3)
    kw = dict(chunk_frames=16, window_frames=48, max_tokens=24,
              steps_per_chunk=8)
    kern = ChunkBeamDecoder(model, dcfg, lm=lm, **kw)
    ref = ChunkBeamDecoder(model, dcfg, lm=lm, prefix_impl="torch", **kw)
    ck, cr = kern.init(1), ref.init(1)
    for e, lp, n, final in _chunks(model, audio, lens, 16):
        before = (cp.ctc_prefix_score.launches, cp.ctc_prefix_select.launches)
        ck, bk = kern.feed(ck, e, lp, n, final=final)
        torch.cuda.synchronize()
        steps = bk["steps"]
        assert (cp.ctc_prefix_score.launches - before[0],
                cp.ctc_prefix_select.launches - before[1]) == (steps, steps)
        cr, br = ref.feed(cr, e, lp, n, final=final)
        for key in ("tokens", "lengths", "finished"):
            assert torch.equal(bk[key], br[key]), key
        assert torch.allclose(bk["scores"], br["scores"], rtol=0, atol=1e-4)


def test_chunk_beam_feed_never_syncs_the_host(dev):
    """A feed of SYNC_EVERY token steps (steps_per_chunk = SYNC_EVERY, so
    the loop never tests its flag) under the sync debugger's error mode,
    after a first feed that builds what a process builds once; a .item()
    under the same mode must raise."""
    from pytorch_end2end_speech_recognition_tpu_torch.decode.beam import (
        SYNC_EVERY,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.decode.chunk_beam import (
        ChunkBeamDecoder,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
        DecodeConfig,
    )

    model, lm, audio, lens = _small_beam_model(dev, "transformer",
                                               "transformer")
    cb = ChunkBeamDecoder(model, DecodeConfig(beam_size=4, pre_beam_k=8,
                                              lm_weight=0.3,
                                              coverage_penalty=0.1),
                          lm=lm, chunk_frames=16, window_frames=48,
                          steps_per_chunk=SYNC_EVERY)
    chunks = _chunks(model, audio, lens, 16)
    carry, _ = cb.feed(cb.init(1), *chunks[0][:3])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):
            torch.ones((), device=dev).item()
        carry, beam = cb.feed(carry, *chunks[1][:3])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert beam["steps"] == SYNC_EVERY


def _op_case(name, dev):
    """One call of each operator that a serving program reaches, at small
    shapes of the paths' widths: (the operator, its arguments)."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops import (
        attention_kernel as ak,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops import (
        ffn_kernel as fk,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops import (
        frontend_kernel as lk,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops import (
        rnn_kernel as rk,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops import (
        subsample_kernel as sk,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops.frontend import (
        Frontend,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
        AsrConfig,
        resolve_device,
    )

    g = torch.Generator(device="cpu").manual_seed(14)

    def mk(*s, dt=torch.bfloat16, scale=0.5):
        return (torch.randn(*s, generator=g) * scale).to(dev, dt)

    B, H, T = 3, 4, 150
    lens = torch.tensor([T, 97, 1], device=dev)
    q, k, v = mk(B, T, 256), mk(B, T, 256), mk(B, T, 256)
    if name == "logmel":
        fcfg = resolve_device(AsrConfig(), dev).frontend
        fr = Frontend(fcfg, dev)
        Ts = 3 * 16000 + 77
        audio = mk(2, Ts, dt=torch.float32, scale=0.1)
        n = fr.n_frames(Ts)
        return lk.logmel_op, (audio, fr.basis, fr.basis_prev, fr.mel_b,
                              fr.hop, n, torch.tensor([n, n // 3],
                                                      device=dev),
                              fr.mel_bands, fr.mel_t)
    if name == "toeplitz_expand":
        return ak.toeplitz_op, (mk(2 * H, 2 * T - 1, dt=torch.float32), T,
                                256, torch.bfloat16)
    if name.startswith("attention_fwd"):
        return ak.attention_op, (q, k, v, mk(H, 256, 256), lens, H,
                                 name.endswith("lse"))
    if name.startswith("flash_fwd"):
        return ak.flash_op, (q, k, v, mk(H, 2 * T - 1, dt=torch.float32),
                             lens, H, name.endswith("lse"))
    if name == "lstm_fwd":
        return rk.lstm_fwd_op, (mk(2, B, 40, 4 * 64, dt=torch.float32),
                                mk(2, 64, 4 * 64, dt=torch.float32, scale=0.1),
                                torch.tensor([40, 23, 0], device=dev))
    if name == "subsample":
        C = 64
        return sk.subsample_op, (mk(B, T, 80, dt=torch.float32, scale=2.0),
                                 lens, mk(C, 1, 3, 3), mk(C, scale=0.1),
                                 mk(C, C, 3, 3, scale=0.05), mk(C, scale=0.1))
    if name == "ffn_fwd":
        R, D, F = 300, 256, 1024
        return fk.ffn_fwd_op, (
            mk(R, D), mk(D, dt=torch.float32, scale=1.0),
            mk(D, dt=torch.float32, scale=0.1), mk(F, D, scale=0.06),
            mk(F, scale=0.1), mk(D, F, scale=0.03), mk(D, scale=0.1),
            torch.zeros(1, dtype=torch.int32, device=dev), 0.0, 0.5)
    raise ValueError(name)


OPS = ["logmel", "toeplitz_expand", "attention_fwd", "attention_fwd_lse",
       "flash_fwd", "flash_fwd_lse", "lstm_fwd", "ffn_fwd", "subsample"]


def _outs(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


@pytest.mark.parametrize("name", OPS)
def test_operator_fake_matches_its_cuda_output(dev, name):
    """Each serving operator's fake (the shapes and dtypes `torch.export`
    traces with) equals what its CUDA version returns."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    op, args = _op_case(name, dev)
    real = _outs(op(*args))
    torch.cuda.synchronize()
    with FakeTensorMode() as mode:
        fargs = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                 for a in args]
        fake = _outs(op(*fargs))
    assert [(tuple(t.shape), t.dtype, t.device) for t in fake] == [
        (tuple(t.shape), t.dtype, t.device) for t in real]


@pytest.mark.parametrize("name", OPS)
def test_operator_through_torch_export_is_bit_exact(dev, name):
    """Each operator called through an exported program (saved and loaded)
    gives the eager kernel's output bit for bit, the FFN at D 256 too."""
    import io

    op, args = _op_case(name, dev)
    tensors = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]

    class Call(torch.nn.Module):
        def forward(self, *ts):
            full = list(args)
            for i, t in zip(tensors, ts):
                full[i] = t
            return op(*full)

    inputs = tuple(args[i] for i in tensors)
    with torch.no_grad():
        ep = torch.export.export(Call(), inputs)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    buf.seek(0)
    got = _outs(torch.export.load(buf).module()(*inputs))
    want = _outs(op(*args))
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_greedy_bundle_exported_on_the_card_gives_live_tokens(dev, tmp_path):
    """A 2-layer flagship (d256, H4, bf16, the kernels) exported on the card
    transcribes a ragged pair as the live model does, token for token,
    through the log-mel, Toeplitz and attention operators."""
    from pytorch_end2end_speech_recognition_tpu_torch.configs.presets import (
        flagship_conformer,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.data.tokenizer import (
        CharTokenizer,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops.attention_kernel import (
        attention_fwd,
        toeplitz_fwd,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops.ctc import (
        ctc_greedy_decode,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops.frontend_kernel import (
        logmel,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.serving import (
        export_bundle,
        load_bundle,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.training.solver import (
        Solver,
    )

    cfg = flagship_conformer()
    cfg.model.encoder_layers = 2
    cfg.train.checkpoint_dir = str(tmp_path / "ckpt")
    cfg.train.metrics_path = ""
    tok = CharTokenizer(charset="abcdefghijklmnopqrstuvwxyz'")
    solver = Solver(cfg, tok, device=dev)
    with torch.no_grad():
        solver.model.encoder.rel.table.normal_(0, 4.0)
    solver.save_checkpoint("best")
    out = export_bundle(cfg, tok, tmp_path / "bundle", batch_sizes=(2,),
                        seconds=(4,), device="cuda")
    bundle = load_bundle(out)
    rng = np.random.default_rng(3)
    audios = [rng.standard_normal(n).astype(np.float32) * 0.1
              for n in (64000, 37123)]
    for fn in (logmel, toeplitz_fwd, attention_fwd):
        fn.launches = 0
    got = bundle.transcribe_ids(audios)
    assert (logmel.launches, toeplitz_fwd.launches,
            attention_fwd.launches) == (1, 1, 2)
    batch = torch.zeros(2, 64000, device=dev)
    for i, a in enumerate(audios):
        batch[i, :len(a)] = torch.from_numpy(a)
    lens = torch.tensor([len(a) for a in audios], device=dev)
    with torch.no_grad():
        enc, el = solver.model.encode(batch, lens)
        ids, il = ctc_greedy_decode(solver.model.ctc_logits(enc), el)
    assert got == [ids[i, :int(il[i])].tolist() for i in range(2)]


def test_world1_nccl_process_group(dev, tmp_path):
    """A one-rank process group over 'cpu:gloo,cuda:nccl' (the card's
    default backend): a card tensor's all-reduce runs over NCCL, a host
    tensor's over gloo, and the mesh takes cuda:0."""
    import torch.distributed as dist

    from pytorch_end2end_speech_recognition_tpu_torch.parallel.mesh import (
        abort,
        initialize_multihost,
        make_mesh,
    )

    initialize_multihost(f"file://{tmp_path / 'rdzv'}",
                         num_processes=1, process_id=0,
                         backend="cpu:gloo,cuda:nccl", timeout_s=120)
    try:
        mesh = make_mesh(1, 1, device="cuda")
        x = torch.arange(4.0, device=dev)
        y = torch.arange(4.0)
        dist.all_reduce(x)
        dist.all_reduce(y)
        torch.cuda.synchronize()
        assert mesh.device == torch.device("cuda", 0)
        assert torch.equal(x.cpu(), y) and torch.equal(y, torch.arange(4.0))
    finally:
        abort()


@pytest.mark.parametrize("flash", [False, True])
def test_sharded_attention_launches_on_local_heads(dev, flash):
    """`sharded_fused_attention` at tp 2: each model rank launches the
    forward and backward kernels once on its 2 of 4 heads (with those
    heads' bias rows or diagonals), and its outputs and gradients equal
    the plain version's on those heads."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops import (
        attention_kernel as ak,
    )

    B, T, H, Dh = 3, (1000 if flash else 150), 4, 64
    q, k, v, diag, lens = _flash_inputs(dev, B, T, H, [T, 65, 1], 7)
    bias = None if flash else ak.toeplitz_expand(diag, 256, 256, T=T).to(
        torch.bfloat16)
    g = torch.Generator(device="cpu").manual_seed(8)
    cot = (torch.randn(B, T, H * Dh, generator=g) * 0.5).to(dev, torch.bfloat16)
    cot = cot * (torch.arange(T, device=dev)[None, :, None]
                 < lens[:, None, None])
    fwd, bwd = (ak.flash_fwd, ak.flash_bwd) if flash else (ak.attention_fwd,
                                                            ak.attention_bwd)
    w = H // 2 * Dh
    for r in range(2):
        cols = slice(r * w, (r + 1) * w)
        hd = slice(2 * r, 2 * r + 2)
        ql, kl, vl = (t[:, :, cols].clone().requires_grad_()
                      for t in (q, k, v))
        n_fwd, n_bwd = fwd.launches, bwd.launches
        out = ak.sharded_fused_attention(
            2, ql, kl, vl, None if flash else bias[hd], lens, H,
            diag=diag[hd] if flash else None)
        out.backward(cot[:, :, cols])
        torch.cuda.synchronize()
        assert (fwd.launches - n_fwd, bwd.launches - n_bwd) == (1, 1)
        qp, kp, vp = (t[:, :, cols].detach().clone().requires_grad_()
                      for t in (q, k, v))
        if flash:
            ref = ak.flash_attention(qp, kp, vp, diag[hd], lens, 2,
                                     plain=True)
        else:
            ref = ak.attention_plain(qp, kp, vp, bias[hd], lens, 2)
        ref.backward(cot[:, :, cols])
        valid = (torch.arange(T, device=dev)[None, :] < lens[:, None])[..., None]
        assert _rel_err(out.detach() * valid, ref.detach() * valid) < 2e-2
        for a, b in ((ql, qp), (kl, kp), (vl, vp)):
            assert _rel_err(a.grad, b.grad) < 2e-2


def _counted():
    from pytorch_end2end_speech_recognition_tpu_torch.ops import (
        attention_kernel as ak,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops import (
        ctc_kernel as ck,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops import (
        ffn_kernel as fk,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops import (
        frontend_kernel as fr,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops import (
        subsample_kernel as sk,
    )

    return (fr.logmel, ak.toeplitz_fwd, ak.toeplitz_reduce, ak.attention_fwd,
            ak.attention_bwd, ak.flash_fwd, ak.flash_bwd, ck.ctc_alpha,
            ck.ctc_beta, fk.ffn_fwd, fk.ffn_bwd, sk.subsample)


def _launches_of(fn):
    counted = _counted()
    for f in counted:
        f.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {f.__name__: f.launches for f in counted if f.launches}


def _small_flagship(dev, **model):
    """A 2-layer flagship (d256, H4, bf16, the kernels), its relative bias
    at std 4, dropout 0, as a Solver on the card, and a ragged batch of 2
    rows of 4 s with 12 tokens."""
    from pytorch_end2end_speech_recognition_tpu_torch.configs.presets import (
        flagship_conformer,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.data.dataset import (
        Batch,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.data.tokenizer import (
        CharTokenizer,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.training.solver import (
        Solver,
    )

    cfg = flagship_conformer()
    cfg.model.encoder_layers = 2
    cfg.model.encoder_dropout = cfg.model.decoder_dropout = 0.0
    cfg.frontend.spec_augment = False
    cfg.train.metrics_path = ""
    for k, v in model.items():
        setattr(cfg.model, k, v)
    solver = Solver(cfg, CharTokenizer(charset="abcdefghijklmnopqrstuvwxyz'"),
                    device=dev)
    with torch.no_grad():
        solver.model.encoder.rel.table.copy_(torch.randn(
            solver.model.encoder.rel.table.shape,
            generator=torch.Generator().manual_seed(5)).to(dev) * 4.0)
    rng = np.random.default_rng(11)
    audio = (rng.standard_normal((2, 64000)) * 0.1).astype(np.float32)
    lens = np.asarray([64000, 41000], np.int32)
    audio[1, 41000:] = 0
    tokens = rng.integers(3, 20, (2, 12)).astype(np.int32)
    return solver, Batch(audio, lens, tokens, np.asarray([12, 9], np.int32))


def test_cp_mode_without_a_mesh_runs_the_flash_kernels(dev):
    """`cp_mode` with no mesh sends the relative bias to the float32
    diagonals at any T (JAX `models/encoders.py:389`): a Solver step of a
    2-layer flagship launches flash 2 + 2, log-mel 1 and CTC 1 + 1, no
    Toeplitz or dense-attention kernel; 'ulysses' gives 'ring's logits bit
    for bit, and both the dense path's within [4]'s logit tolerance."""
    ring, batch = _small_flagship(dev, cp_mode="ring")
    uly, _ = _small_flagship(dev, cp_mode="ulysses")
    dense, _ = _small_flagship(dev)
    _, step = _launches_of(lambda: ring.train_step(batch))
    assert step == {"logmel": 1, "flash_fwd": 2, "flash_bwd": 2,
                    "ctc_alpha": 1, "ctc_beta": 1}
    audio = torch.from_numpy(batch.audio).to(dev)
    lens = torch.from_numpy(batch.audio_lens).to(dev)
    uly.model.load_state_dict(ring.model.state_dict())
    dense.model.load_state_dict(ring.model.state_dict())
    with torch.no_grad():
        (enc, el), fwd = _launches_of(lambda: ring.model.encode(audio, lens))
        got = ring.model.ctc_logits(enc)
        assert torch.equal(uly.model.ctc_logits(uly.model.encode(audio,
                                                                 lens)[0]),
                           got)
        want = dense.model.ctc_logits(dense.model.encode(audio, lens)[0])
    assert fwd == {"logmel": 1, "flash_fwd": 2, "subsample": 1}
    valid = torch.arange(got.shape[1], device=dev)[None, :] < el[:, None]
    assert float((got - want).abs().amax(-1)[valid].max()) <= 0.1


def test_pp_stages_keep_the_fused_ffn_off(dev):
    """`pp_stages` 2 with no mesh is the plain block loop, and the JAX gate
    (`models/encoders.py:507`) keeps its FFN blocks off the fused kernels:
    with ffn_impl='cuda' a forward and a step launch no FFN kernel, and the
    logits equal pp_stages 1 with ffn_impl='torch' bit for bit; the same
    model at pp_stages 1 launches the FFN kernel in each of its 4 FFN
    blocks."""
    pp, batch = _small_flagship(dev, pp_stages=2, ffn_impl="cuda")
    ref, _ = _small_flagship(dev)
    on, _ = _small_flagship(dev, ffn_impl="cuda")
    for s in (ref, on):
        s.model.load_state_dict(pp.model.state_dict())
    audio = torch.from_numpy(batch.audio).to(dev)
    lens = torch.from_numpy(batch.audio_lens).to(dev)
    with torch.no_grad():
        got, fwd = _launches_of(
            lambda: pp.model.ctc_logits(pp.model.encode(audio, lens)[0]))
        want = ref.model.ctc_logits(ref.model.encode(audio, lens)[0])
        _, fused = _launches_of(lambda: on.model.encode(audio, lens))
    assert "ffn_fwd" not in fwd and fwd["attention_fwd"] == 2
    assert torch.equal(got, want)
    assert fused["ffn_fwd"] == 4
    _, step = _launches_of(lambda: pp.train_step(batch))
    assert "ffn_fwd" not in step and "ffn_bwd" not in step
    assert step["attention_bwd"] == 2


# ---------------------------------------------------------------- subsampling
def _sub_inputs(dev, B, T, n_mels, C, seed, lens=None, b1_shift=0.0):
    """x (B, T, n_mels) float32, lens (T, 1, then random, unless given) and
    bf16 weights at the scales of a trained layer (activations O(1))."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, T, n_mels, generator=g) * 2.0
    w1 = torch.randn(C, 1, 3, 3, generator=g) / 3.0
    b1 = torch.randn(C, generator=g) * 0.3 + b1_shift
    w2 = torch.randn(C, C, 3, 3, generator=g) / (3.0 * C ** 0.5)
    b2 = torch.randn(C, generator=g) * 0.1
    if lens is None:
        lens = [T, 1] + torch.randint(1, T + 1, (B - 2,), generator=g).tolist()
    return (x.to(dev), torch.tensor(lens[:B], device=dev),
            *(w.to(dev, torch.bfloat16) for w in (w1, b1, w2, b2)))


def _sub_excess(out, ref) -> float:
    """max |out - ref| / (2^-5 |ref| + 2^-4 rms(ref)): above 1 fails. Both
    are bf16; the plain version rounds each convolution before its bias
    (cuDNN, then the add), so an output may differ by up to 2^-7 |ref| from
    that alone, and each conv1 activation by an ulp, of which conv2 sums
    9 C: at B 8 x 30 s the worst element read 0.91-0.94 of half this
    bound. A wrong tap, mask or channel moves outputs by a sizeable share
    of rms(ref)."""
    out, ref = out.float(), ref.float()
    rms = ref.pow(2).mean().sqrt()
    return float(((out - ref).abs() / (2.0 ** -5 * ref.abs()
                                       + 2.0 ** -4 * rms)).max())


@pytest.mark.parametrize("B,T,n_mels,C", [
    (4, 37, 80, 32), (4, 40, 81, 64), (4, 101, 13, 128), (3, 64, 80, 256),
    (3, 63, 79, 512), (2, 50, 80, 1024), (3, 33, 80, 48),
    (2, 2998, 80, 256), (2, 2998, 80, 512), (2, 6551, 80, 256)])
def test_subsample_kernel_matches_plain(dev, B, T, n_mels, C):
    """The kernel against `subsample_plain` at every preset width, the
    card tests' 32, odd and even T and n_mels, lengths 1 and T, and the
    serving cells' shapes (30 s: T 2,998; 65.5 s: 6,551) at B 2."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops import (
        subsample_kernel as sk,
    )

    args = _sub_inputs(dev, B, T, n_mels, C, seed=C + T)
    out = sk.subsample(*args)
    ref = sk.subsample_plain(*args)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    assert _sub_excess(out, ref) <= 1.0
    lens2 = ((args[1] + 1) // 2 + 1) // 2
    for b in range(B):
        assert torch.all(out[b, int(lens2[b]):] == 0)
    assert torch.count_nonzero(out[0]) > out[0].numel() // 4


def _sub_control(x, lens, w1, b1, w2, b2, conv1_mask=True, flip_pad=False):
    """`subsample_plain` with a fault: conv1's mask dropped, or the SAME
    padding of an even extent put before it instead of after."""
    import torch.nn.functional as F

    from pytorch_end2end_speech_recognition_tpu_torch.ops import (
        subsample_kernel as sk,
    )

    def pad(n):
        p = sk._same_pad_s2(n)
        return p[::-1] if flip_pad and n % 2 == 0 else p

    def conv(h, w, b):
        (t0, t1), (f0, f1) = pad(h.shape[2]), pad(h.shape[3])
        h = F.pad(h.to(w.dtype), (f0, f1, t0, t1))
        return F.relu(F.conv2d(h, w, b, stride=2))

    def mask(h, n):
        valid = torch.arange(h.shape[2], device=n.device)[None, :] < n[:, None]
        return torch.where(valid[:, None, :, None], h, torch.zeros_like(h))

    h = torch.where((torch.arange(x.shape[1], device=x.device)[None, :]
                     < lens[:, None])[..., None], x, 0.0)[:, None]
    h = conv(h, w1, b1)
    lens = (lens + 1) // 2
    if conv1_mask:
        h = mask(h, lens)
    h = mask(conv(h, w2, b2), (lens + 1) // 2)
    B, C, T, Fo = h.shape
    return h.permute(0, 2, 3, 1).reshape(B, T, Fo * C)


def test_subsample_kernel_comparison_fails_its_controls(dev):
    """The comparison above fails the plain version with conv1's mask
    dropped, with the SAME padding's parity flipped (even T and n_mels:
    the pad before, not after) and with lens ignored, and passes the plain
    version itself. conv1's bias is shifted positive, so that positions past
    lens1 would read relu(b1) != 0 without the mask."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops import (
        subsample_kernel as sk,
    )

    T = 40
    args = _sub_inputs(dev, 6, T, 80, 64, seed=5,
                       lens=[T, 1, 13, 17, 22, 30], b1_shift=0.5)
    out = sk.subsample(*args)
    assert _sub_excess(out, sk.subsample_plain(*args)) <= 1.0
    x, lens, *w = args
    controls = {
        "conv1 mask dropped": _sub_control(*args, conv1_mask=False),
        "pad parity flipped": _sub_control(*args, flip_pad=True),
        "lens ignored": sk.subsample_plain(x, torch.full_like(lens, T), *w),
    }
    torch.cuda.synchronize()
    for name, ref in controls.items():
        assert _sub_excess(out, ref) > 1.0, name


def test_subsample_launches_once_a_serving_forward_and_not_in_training(dev):
    """`ConvSubsample` launches the kernel once a forward that records no
    gradient at bf16 and never under autograd; a Solver step of a 2-layer
    flagship launches none, its serving forward one."""
    from pytorch_end2end_speech_recognition_tpu_torch.models import (
        encoders as enc,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops import (
        subsample_kernel as sk,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
        ModelConfig,
    )

    cfg = ModelConfig(encoder_dim=256, subsample_channels=256,
                      dtype="bfloat16", residual_dtype="bfloat16")
    sub = enc.ConvSubsample(80, 256, cfg).to(dev)
    x, lens, *_ = _sub_inputs(dev, 3, 301, 80, 256, seed=1)
    sk.subsample.launches = 0
    with torch.no_grad():
        got, got_lens = sub(x, lens)
    assert sk.subsample.launches == 1
    want, want_lens = sub(x, lens)
    assert sk.subsample.launches == 1 and want.requires_grad
    assert torch.equal(got_lens, want_lens)
    torch.cuda.synchronize()
    assert _rel_err(got, want.detach()) < 2e-2  # after the bf16 projection
    solver, batch = _small_flagship(dev)
    _, step = _launches_of(lambda: solver.train_step(batch))
    assert "subsample" not in step
    audio = torch.from_numpy(batch.audio).to(dev)
    alens = torch.from_numpy(batch.audio_lens).to(dev)
    with torch.no_grad():
        _, fwd = _launches_of(lambda: solver.model.encode(audio, alens))
    assert fwd["subsample"] == 1


@pytest.mark.parametrize("case", ["c24", "c1040", "f32_weights", "bf16_x",
                                  "n_mels_900"])
def test_subsample_kernel_raises_on_what_it_does_not_take(dev, case):
    from pytorch_end2end_speech_recognition_tpu_torch.ops import (
        subsample_kernel as sk,
    )

    C = {"c24": 24, "c1040": 1040}.get(case, 64)
    n_mels = 900 if case == "n_mels_900" else 80  # conv1 window too wide
    x, lens, *w = _sub_inputs(dev, 2, 20, n_mels, C, seed=0)
    if case == "f32_weights":
        w = [t.float() for t in w]
    if case == "bf16_x":
        x = x.bfloat16()
    err = TypeError if case in ("f32_weights", "bf16_x") else ValueError
    with pytest.raises(err, match="subsample"):
        sk.subsample(x, lens, *w)
