"""The port's attention backward and Toeplitz reduce (plain versions, and the
autograd.Functions around them on CPU tensors) against the JAX package's
Pallas backward kernels in interpret mode and its XLA oracles. float32;
inputs made with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pytorch_end2end_speech_recognition_tpu.ops import attention_pallas as ap
from pytorch_end2end_speech_recognition_tpu_torch.ops.attention_kernel import (
    attention_bwd_plain,
    attention_plain,
    fused_attention,
    toeplitz_dense,
    toeplitz_expand,
    toeplitz_reduce_plain,
)

# float32 both sides; sums over up to 256 keys in another order. The JAX
# package's own backward tests hold the kernel to 2e-4 (5e-4 for the
# head-split layout); so does this.
TOL = 2e-4


def _inputs(B, T, H, Dh, P, lens, seed, mask_g=True):
    """q, k, v (B, T, H*Dh), a padded (H, P, P) bias of std ~4 (zero pad
    band, as the Toeplitz kernel's output is masked there), the cotangent g:
    zero on query rows past a row's length when `mask_g`, as on the
    training path; else zero only on rows of length 0, whose uniform
    weights the TPU kernel spreads over its Tp padded keys and the XLA
    reference over T."""
    rng = np.random.default_rng(seed)
    mk = lambda: rng.standard_normal((B, T, H * Dh)).astype(np.float32) * 0.5
    q, k, v = mk(), mk(), mk()
    bias = np.zeros((H, P, P), np.float32)
    bias[:, :T, :T] = rng.standard_normal((H, T, T)) * 4.0
    g = rng.standard_normal((B, T, H * Dh)).astype(np.float32)
    lens_ = np.asarray(lens)[:, None, None]
    g *= (np.arange(T)[None, :, None] < lens_) if mask_g else (lens_ > 0)
    return q, k, v, bias, np.asarray(lens, np.int32), g


def _plain(q, k, v, bias, lens, g, H):
    out = attention_bwd_plain(*(torch.from_numpy(a) for a in (q, k, v, bias,
                                                              lens, g)), H)
    return [x.numpy() for x in out]


@pytest.mark.parametrize("T", [96, 250])
@pytest.mark.parametrize("mask_g", [True, False])
def test_attention_bwd_plain_matches_pallas_interpret(T, mask_g):
    """Tp 128 / 256 (the TPU kernel pads T to the lane width), ragged lens
    with a row of length 0, the bias pre-padded to Tp as the port's kernel
    path passes it. With an unmasked cotangent the rows past a row's length
    are compared too: the plain version computes them as the TPU kernel
    does."""
    H, Dh = 2, 64
    Tp = -(-T // 128) * 128
    q, k, v, bias, lens, g = _inputs(3, T, H, Dh, Tp, [T, T // 3, 0], T,
                                     mask_g)
    with pltpu.force_tpu_interpret_mode():
        ref = ap._attention_bwd_pallas(*(jnp.asarray(a) for a in (
            q, k, v, bias, lens, g)), H)
    got = _plain(q, k, v, bias, lens, g, H)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, ref):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=TOL,
                                   err_msg=name)
    if mask_g:  # the lens-0 row's cotangent is zero, so are its gradients
        for a in got[:3]:
            assert not a[2].any()


def test_attention_bwd_plain_matches_headsplit_interpret():
    """The head-split TPU backward (#5: the same function in the (H, B, Tp,
    Dh) layout, which the JAX package takes when H Tp^2 4 B > 12 MiB, e.g.
    rung 4's H 8) against the same plain version, called directly at a
    small shape."""
    B, T, H, Dh = 2, 200, 8, 16
    Tp = 256
    q, k, v, bias, lens, g = _inputs(B, T, H, Dh, Tp, [200, 77], 11)
    pad = ((0, 0), (0, Tp - T), (0, 0))
    jq, jk, jv, jg = (jnp.pad(jnp.asarray(a), pad) for a in (q, k, v, g))
    with pltpu.force_tpu_interpret_mode():
        dq, dk, dv, dbias = ap._attention_bwd_headsplit(
            jq, jk, jv, jnp.asarray(bias), jnp.asarray(lens), jg, H, Tp,
            True, jnp.asarray(bias))
    got = _plain(q, k, v, bias, lens, g, H)
    for name, a, b in zip(("dq", "dk", "dv"), got, (dq, dk, dv)):
        np.testing.assert_allclose(a, np.asarray(b)[:, :T], rtol=2.5 * TOL,
                                   atol=2.5 * TOL, err_msg=name)
    np.testing.assert_allclose(got[3], np.asarray(dbias), rtol=2.5 * TOL,
                               atol=2.5 * TOL)


@pytest.mark.parametrize("with_bias", [False, True])
def test_fused_attention_grad_on_cpu_is_autograd_of_plain(with_bias):
    """The autograd.Function's backward (the plain backward on CPU tensors)
    equals autograd through the plain forward, bias gradient included."""
    q, k, v, bias, lens, g = _inputs(3, 70, 2, 32, 128, [70, 33, 1], 3)
    grads = []
    for fn in (fused_attention, attention_plain):
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
        b = ts[3] if with_bias else None
        out = fn(ts[0], ts[1], ts[2], b, torch.from_numpy(lens), 2)
        (out * torch.from_numpy(g)).sum().backward()
        grads.append([t.grad for t in ts[:3 + with_bias]])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def _toep_reduce_interpret(g, T, Tp):
    """The TPU reduce kernel in interpret mode, called as the JAX package's
    own test calls it: rows pre-reversed, whole (Tp, Tp) block summed."""
    N = g.shape[0]
    with pltpu.force_tpu_interpret_mode():
        s = pl.pallas_call(
            ap._toep_reduce_kernel,
            grid=(N,),
            in_specs=[pl.BlockSpec((1, Tp, Tp), lambda n: (n, 0, 0))],
            out_specs=pl.BlockSpec((1, 1, 2 * Tp), lambda n: (n, 0, 0)),
            out_shape=jax.ShapeDtypeStruct((N, 1, 2 * Tp), jnp.float32),
        )(jnp.asarray(g)[:, ::-1])[:, 0]
    return np.asarray(jnp.roll(s, Tp - 1, axis=1)[:, Tp - T: Tp - T + 2 * T - 1])


@pytest.mark.parametrize("T,Tp", [(96, 128), (250, 256), (128, 128)])
def test_toeplitz_reduce_plain_matches_pallas_interpret_and_hlo(T, Tp):
    """The port sums the T x T core; the TPU kernel the whole padded block,
    the JAX CPU path the core. With the pad band zero (as on the training
    path) all three agree; with a nonzero pad band the port still equals the
    core sum."""
    rng = np.random.default_rng(T)
    N = 6
    g = np.zeros((N, Tp, Tp), np.float32)
    g[:, :T, :T] = rng.standard_normal((N, T, T))
    out = toeplitz_reduce_plain(torch.from_numpy(g), T).numpy()
    hlo = np.asarray(ap._toeplitz_reduce_hlo(jnp.asarray(g[:, :T, :T]), T))
    kernel = _toep_reduce_interpret(g, T, Tp)
    # float32 sums of up to T terms, another order (5e-5, as the JAX tests)
    for ref in (hlo, kernel):
        np.testing.assert_allclose(out, ref, rtol=5e-5, atol=5e-5)
    if Tp > T:
        g[:, T:, :] = 7.0
        g[:, :, T:] = -3.0
        np.testing.assert_allclose(
            toeplitz_reduce_plain(torch.from_numpy(g), T).numpy(), hlo,
            rtol=5e-5, atol=5e-5)


def test_toeplitz_dense_grad_on_cpu():
    """toeplitz_dense's backward (the reduce) equals autograd through the
    plain gather expansion on the core, and the JAX custom VJP's gradient."""
    rng = np.random.default_rng(2)
    N, T, Tp = 4, 45, 128
    diag = rng.standard_normal((N, 2 * T - 1)).astype(np.float32)
    ct = np.zeros((N, Tp, Tp), np.float32)
    ct[:, :T, :T] = rng.standard_normal((N, T, T))
    d1 = torch.from_numpy(diag).requires_grad_()
    (toeplitz_dense(d1, T, Tp, torch.float32) * torch.from_numpy(ct)
     ).sum().backward()
    d2 = torch.from_numpy(diag).requires_grad_()
    (toeplitz_expand(d2, T, T) * torch.from_numpy(ct[:, :T, :T])
     ).sum().backward()
    want = jax.grad(lambda d: jnp.sum(
        ap.toeplitz_dense(d, T, Tp, jnp.float32) * jnp.asarray(ct)))(
            jnp.asarray(diag))
    np.testing.assert_allclose(d1.grad.numpy(), d2.grad.numpy(), rtol=5e-5,
                               atol=5e-5)
    np.testing.assert_allclose(d1.grad.numpy(), np.asarray(want), rtol=5e-5,
                               atol=5e-5)
