"""The port's fused FFN block against the JAX package: the plain versions of
the FFN kernels (`ops/ffn_kernel.py`), through `FfnFused` on CPU tensors,
against `ffn_fused` in Pallas interpret mode (value and all seven
gradients, one partial row tile and several, scale 0.5 and 1.0, the JAX
tests' tolerances); the dropout mask held to its own formula (interpret
mode's PRNG returns zeros); the port's `FfnBlock` on both of its paths
against the JAX `FfnBlock` with bridged weights. float32 on the CPU; inputs
made with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_train_case as case_mod
from flax import nnx
from jax.experimental.pallas import tpu as pltpu

from pytorch_end2end_speech_recognition_tpu.models import encoders as jenc
from pytorch_end2end_speech_recognition_tpu.ops.ffn_pallas import ffn_fused
from pytorch_end2end_speech_recognition_tpu.utils.config import (
    ModelConfig as JModelConfig,
)
from pytorch_end2end_speech_recognition_tpu_torch import bridge
from pytorch_end2end_speech_recognition_tpu_torch.models import encoders as tenc
from pytorch_end2end_speech_recognition_tpu_torch.ops import ffn_kernel as fk
from pytorch_end2end_speech_recognition_tpu_torch.utils.config import ModelConfig

D, F = 64, 256


def _args(R: int, seed: int = 0):
    """x, gamma, beta, w1 (D, F), b1, w2 (F, D), b2 in the JAX layout (the
    JAX tests' `_ffn_args`), and a cotangent."""
    rng = np.random.default_rng(seed)
    f = lambda *s, k=1.0, c=0.0: (c + k * rng.standard_normal(s)).astype(  # noqa: E731
        np.float32)
    return (f(R, D), f(D, k=0.1, c=1.0), f(D, k=0.1), f(D, F, k=D ** -0.5),
            f(F, k=0.1), f(F, D, k=F ** -0.5), f(D, k=0.1)), f(R, D)


def _port(args):
    """The JAX-layout arrays as the port's tensors: w1, w2 transposed to
    nn.Linear's (out, in), each a leaf that requires grad."""
    x, gamma, beta, w1, b1, w2, b2 = args
    return [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()
            for a in (x, gamma, beta, w1.T, b1, w2.T, b2)]


SEED0 = torch.zeros(1, dtype=torch.int32)


@pytest.mark.parametrize("R,scale", [(70, 0.5), (70, 1.0), (520, 0.5),
                                     (520, 1.0)])
def test_plain_kernels_match_pallas_interpret(R, scale):
    """`FfnFused` (the kernels' plain versions on CPU tensors) against the
    JAX `ffn_fused` in interpret mode at rate 0: the output (rtol 2e-5)
    and the gradients of sum(out * cot) in x, gamma, beta, w1, b1, w2 and
    b2 (2e-4; 5e-4 over several row tiles, the JAX tests' own)."""
    args, cot = _args(R, seed=R + int(10 * scale))

    def loss(*a):
        return jnp.sum(ffn_fused(0.0, scale, *a, jnp.zeros((), jnp.int32))
                       * cot)

    with pltpu.force_tpu_interpret_mode():
        ref = ffn_fused(0.0, scale, *args, jnp.zeros((), jnp.int32))
        g_ref = jax.grad(loss, argnums=tuple(range(7)))(*args)
    ts = _port(args)
    out = fk.FfnFused.apply(*ts, SEED0, 0.0, scale)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(cot))
    tol = 2e-4 if R <= 256 else 5e-4
    for name, got, want in zip(("x", "gamma", "beta", "w1", "b1", "w2", "b2"),
                               grads, g_ref):
        want = np.asarray(want)
        if name in ("w1", "w2"):
            want = want.T
        np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol,
                                   err_msg=name)


def test_dropout_mask_is_a_function_of_seed_row_and_column():
    """The same seed gives the same mask, another seed another; the mask
    of rows 0..519 is the concatenation of those of any row chunks; the
    drop fraction lies within 6 sigma of the rate and kept elements carry
    1 / (1 - rate) in float32."""
    rate = 0.1
    s1, s2 = torch.tensor([12345], dtype=torch.int32), \
        torch.tensor([12346], dtype=torch.int32)
    rows = torch.arange(520)
    m = fk.keep_multiplier(s1, rows, D, rate)
    assert torch.equal(m, fk.keep_multiplier(s1, rows, D, rate))
    assert not torch.equal(m, fk.keep_multiplier(s2, rows, D, rate))
    for cut in (1, 64, 70, 256):
        parts = [fk.keep_multiplier(s1, rows[:cut], D, rate),
                 fk.keep_multiplier(s1, rows[cut:], D, rate)]
        assert torch.equal(m, torch.cat(parts)), cut
    n = m.numel()
    frac = float((m == 0).float().mean())
    assert abs(frac - rate) <= 6 * (rate * (1 - rate) / n) ** 0.5
    assert torch.all((m == 0) | (m == np.float32(1.0 / 0.9)))
    # seeds of the whole int32 range, negative ones included
    big = fk.keep_multiplier(torch.tensor([-2 ** 31], dtype=torch.int32),
                             rows, D, rate)
    assert abs(float((big == 0).float().mean()) - rate) <= \
        6 * (rate * (1 - rate) / n) ** 0.5


def test_plain_backward_is_the_gradient_of_the_plain_forward_with_dropout():
    """At rate 0.1, `ffn_bwd_plain` (the mask regenerated from the seed)
    equals autograd through `ffn_fwd_plain` with the same seed: the
    backward replays the forward's mask."""
    args, cot = _args(70, seed=3)
    seed = torch.tensor([777], dtype=torch.int32)
    ts = _port(args)
    out = fk.ffn_fwd_plain(*ts, seed, 0.1, 0.5)
    assert float((out - ts[0]).detach().eq(0).float().mean()) > 0.05
    want = torch.autograd.grad(out, ts, torch.from_numpy(cot))
    got = fk.ffn_bwd_plain(ts[0].detach(), torch.from_numpy(cot),
                           *(t.detach() for t in ts[1:]), seed, 0.1, 0.5)
    for name, a, b in zip(("x", "gamma", "beta", "w1", "b1", "w2", "b2"),
                          got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    other = fk.ffn_bwd_plain(ts[0].detach(), torch.from_numpy(cot),
                             *(t.detach() for t in ts[1:]),
                             seed + 1, 0.1, 0.5)
    assert (other[0] - got[0]).abs().max() > 1e-2


def test_block_fused_dropout_needs_train_and_a_generator():
    """Rate applies only in training; training at a rate > 0 without a
    generator raises; with one, the output is the plain forward under the
    seed drawn from it."""
    args, _ = _args(2 * 35, seed=5)
    x, *w = (t.detach() for t in _port(args))
    x3 = x.reshape(2, 35, D)
    kw = dict(rate=0.1, scale=0.5)
    eval_out = fk.ffn_block_fused(x3, *w, **kw)
    np.testing.assert_array_equal(
        eval_out.reshape(70, D).numpy(),
        fk.ffn_fwd_plain(x, *w, SEED0, 0.0, 0.5).numpy())
    with pytest.raises(ValueError, match="Generator"):
        fk.ffn_block_fused(x3, *w, train=True, **kw)
    gen = torch.Generator().manual_seed(9)
    seed = torch.randint(0, 2 ** 31 - 1, (1,), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(9))
    out = fk.ffn_block_fused(x3, *w, train=True, generator=gen, **kw)
    np.testing.assert_array_equal(
        out.reshape(70, D).numpy(),
        fk.ffn_fwd_plain(x, *w, seed, 0.1, 0.5).numpy())


def test_fits_vmem_is_the_jax_gate():
    from pytorch_end2end_speech_recognition_tpu.ops import ffn_pallas

    for d, f in ((256, 1024), (512, 2048), (1024, 4096), (64, 256)):
        assert fk.fits_vmem(d, f) == ffn_pallas.fits_vmem(d, f), (d, f)
    assert fk.fits_vmem(256, 1024) and not fk.fits_vmem(512, 2048)


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_ffn_block_matches_jax(impl):
    """The port's `FfnBlock` (scale 0.5) with the JAX block's weights
    bridged in, on its fused path (`ffn_impl='cuda'`: the kernels' plain
    versions on CPU tensors) and its torch path, against the JAX `FfnBlock`
    on the CPU (XLA): output within 1e-5, gradients in x and every
    parameter within 1e-4 of each tensor's largest."""
    jcfg = JModelConfig(encoder_dim=D, encoder_ffn_dim=F, dtype="float32",
                        residual_dtype="float32", encoder_dropout=0.0)
    tcfg = ModelConfig(encoder_dim=D, encoder_ffn_dim=F, dtype="float32",
                       residual_dtype="float32", encoder_dropout=0.0,
                       ffn_impl=impl)
    j = jenc.FfnBlock(jcfg, nnx.Rngs(0), scale=0.5)
    t = tenc.FfnBlock(tcfg, scale=0.5)
    assert t.fused == (impl == "cuda")
    flat = case_mod.flat(j)
    rng = np.random.default_rng(4)
    flat = {k: v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
            for k, v in flat.items()}  # nonzero biases, gamma off 1
    sd = {}
    for name, arr in flat.items():
        key, val = bridge._convert(name, arr)
        sd[key] = torch.from_numpy(np.ascontiguousarray(val))
    t.load_state_dict(sd)
    nnx.update(j, nnx.from_flat_state(
        {tuple(k.split(".")): jnp.asarray(v) for k, v in flat.items()}))
    x = rng.standard_normal((3, 23, D)).astype(np.float32)
    cot = rng.standard_normal((3, 23, D)).astype(np.float32)
    graphdef, params = nnx.split(j, nnx.Param)

    def loss(params, x):
        out = nnx.merge(graphdef, params)(x)
        return jnp.sum(out * cot), out

    (_, ref), (g_p, g_x) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = t(xt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    names, ps = zip(*t.named_parameters())
    grads = torch.autograd.grad(out, (xt, *ps), torch.from_numpy(cot))
    want = {"x": np.asarray(g_x)}
    for name, g in case_mod.flat(g_p).items():
        key, val = bridge._convert(name, g)
        want[key] = val
    assert set(want) == {"x", *names}
    for name, got in zip(("x", *names), grads):
        w = want[name]
        np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=name)
