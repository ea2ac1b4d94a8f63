"""The port's Toeplitz bias expansion and fused attention (plain versions)
against the JAX package's Pallas kernels, run in interpret mode on the CPU,
and its XLA oracles. Inputs are made with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pytorch_end2end_speech_recognition_tpu.ops import attention_pallas as ap
from pytorch_end2end_speech_recognition_tpu_torch.ops.attention_kernel import (
    attention_bwd,
    attention_fwd,
    attention_plain,
    fused_attention,
    toeplitz_dense,
    toeplitz_expand,
    toeplitz_fwd,
    toeplitz_reduce,
)


def _toep_interpret(diag, T, Tp):
    """The TPU expand kernel in interpret mode, called as the JAX package's
    own test calls it."""
    N = diag.shape[0]
    dpad = jnp.pad(jnp.asarray(diag), ((0, 0), (Tp - T, Tp - T + 1)),
                   mode="edge")
    with pltpu.force_tpu_interpret_mode():
        out = pl.pallas_call(
            ap._toep_expand_kernel,
            grid=(N,),
            in_specs=[pl.BlockSpec((1, 1, 2 * Tp), lambda n: (n, 0, 0))],
            out_specs=pl.BlockSpec((1, Tp, Tp), lambda n: (n, 0, 0)),
            out_shape=jax.ShapeDtypeStruct((N, Tp, Tp), jnp.float32),
        )(dpad[:, None])
    return np.asarray(out)


@pytest.mark.parametrize("T,Tp", [(96, 128), (250, 256), (128, 128)])
def test_toeplitz_matches_pallas_interpret_and_hlo(T, Tp):
    rng = np.random.default_rng(T)
    N = 6
    diag = rng.standard_normal((N, 2 * T - 1)).astype(np.float32)
    ref_kernel = _toep_interpret(diag, T, Tp)
    ref_hlo = np.asarray(ap._toeplitz_dense_hlo(jnp.asarray(diag), T, Tp,
                                                jnp.float32))
    out = toeplitz_dense(torch.from_numpy(diag), T, Tp, torch.float32).numpy()
    assert out.shape == (N, Tp, Tp)
    # a pure copy: exact on the T x T core (1e-6 as stated), and the pad
    # band repeats the edge diagonals as the TPU kernel's does
    np.testing.assert_allclose(out[:, :T, :T], ref_kernel[:, :T, :T],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out[:, :T, :T], ref_hlo[:, :T, :T],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(out, ref_kernel)


def test_toeplitz_expand_matches_jax_helper():
    """toeplitz_expand realizes block[n,i,j] = diag[n, T-1 + j - i], as the
    JAX helper does, on square and rectangular blocks."""
    rng = np.random.default_rng(1)
    N, T = 3, 17
    diag = rng.standard_normal((N, 2 * T - 1)).astype(np.float32)
    dense = toeplitz_expand(torch.from_numpy(diag), T, T).numpy()
    idx = (T - 1) + np.arange(T)[None, :] - np.arange(T)[:, None]
    np.testing.assert_array_equal(dense, diag[:, idx])
    for Tq, Tk in ((T, T), (5, 4), (4, 9)):
        blk = toeplitz_expand(torch.from_numpy(diag), Tq, Tk, T=T).numpy()
        ref = np.asarray(ap.toeplitz_expand(jnp.asarray(diag), Tq, Tk, T=T))
        np.testing.assert_array_equal(blk, ref)


def _qkv(B=3, T=70, H=2, Dh=32, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda: rng.standard_normal((B, T, H * Dh)).astype(np.float32) * 0.5
    bias = rng.standard_normal((H, T, T)).astype(np.float32) * 0.3
    return mk(), mk(), mk(), bias


@pytest.mark.parametrize("with_bias", [False, True])
def test_attention_plain_matches_pallas_interpret(with_bias):
    """T=70 is not lane-aligned, so the TPU kernel pads to 128; lens include
    1. Only query rows i < lens[b] are compared: rows past a row's length
    are masked downstream and differ by design."""
    q, k, v, bias = _qkv()
    H = 2
    lens = np.asarray([70, 33, 1], np.int32)
    b = bias if with_bias else None
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(ap._attention_fwd_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            None if b is None else jnp.asarray(b), jnp.asarray(lens), H))
    xla = np.asarray(ap._attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if b is None else jnp.asarray(b), jnp.asarray(lens), H))
    out = attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if b is None else torch.from_numpy(b), torch.from_numpy(lens),
        H).numpy()
    valid = np.arange(70)[None, :, None] < lens[:, None, None]
    for r in (ref, xla):
        np.testing.assert_allclose(out * valid, r * valid, rtol=2e-4,
                                   atol=2e-4)


def test_attention_plain_takes_padded_bias():
    """A bias padded past T (the kernel path's 128-multiple) gives the same
    result as the unpadded one."""
    q, k, v, bias = _qkv(T=50)
    lens = torch.tensor([50, 20, 7])
    padded = np.pad(bias, ((0, 0), (0, 78), (0, 78)), mode="edge")
    args = [torch.from_numpy(a) for a in (q, k, v)]
    a = attention_plain(*args, torch.from_numpy(bias), lens, 2)
    b = attention_plain(*args, torch.from_numpy(padded), lens, 2)
    assert torch.equal(a, b)


def test_wrappers_take_plain_versions_on_cpu():
    """Forward and backward: the differentiable entry points take the plain
    versions on CPU tensors and launch (count) nothing."""
    q, k, v, bias = _qkv()
    args = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    lens = torch.tensor([70, 33, 1])
    counters = (attention_fwd, attention_bwd, toeplitz_fwd, toeplitz_reduce)
    before = [f.launches for f in counters]
    out = fused_attention(*args, torch.from_numpy(bias), lens, 2)
    assert torch.equal(out, attention_plain(*args, torch.from_numpy(bias),
                                            lens, 2))
    out.sum().backward()
    diag = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 139)).astype(np.float32)).requires_grad_()
    dense = toeplitz_dense(diag, 70, 128, torch.bfloat16)
    assert torch.equal(dense,
                       toeplitz_expand(diag, 128, 128, T=70).to(torch.bfloat16))
    dense.float().sum().backward()
    assert [f.launches for f in counters] == before
