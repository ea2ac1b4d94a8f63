"""CTC at the LSTM rungs' frame counts (T' 420 and 800, lattices of up to
S = 401 states): the port's `ctc_loss(impl='torch')`, the kernel path's
plain versions (`impl='cuda'` on CPU tensors), the JAX package's
`ctc_loss_xla` and its `ctc_loss_pallas` (interpret mode), each held to a
float64 recursion of the same lattice (the port's alpha recursion run in
float64, differentiated by autograd).

The bound is that of float32 roundings over T steps. Step t of the alpha
recursion adds lp to a log-sum-exp of the previous column: two float32
additions at the magnitude of alpha_t (each within u |alpha_t|, u = 2^-24)
and the exp/log terms of the log-sum-exp, of magnitude at most log 3
(within a few u). Summed over a row's frames, to first order,

    |ll_32 - ll_64| <= B_ll = sum_t (2 u A_t + 8 u),   A_t = max_s |alpha_t[s]|

over the row's live states (A_t grows about linearly in t, so B_ll grows as
T^2: a bound on errors that add up in the worst direction).

The gradient wrt logit v of frame t is softmax_v sum_s occ_s - post_v,
post_v the sum of the occupancies occ_s = exp(alpha + beta - lp - ll) of
the states labelled v; each occupancy's exponent carries the errors of
alpha, beta and ll, each within B_ll (an autograd of the alpha recursion
makes the same errors in its normalised weights). The softmax of float32
logits x is within 4 u (1 + |x| + |lse|) of itself. So

    |grad_32 - grad_64| <= 3 B_ll (post_64 + soft_64)
                           + 4 u (1 + |x| + |lse|) soft_64 + 4 u |grad_64|

with soft_64 the float64 softmax and post_64 = soft_64 - grad_64.

Beside the bound, the test says which side drifts: the two kernel paths
(the port's and `ctc_loss_pallas`) form the occupancies from alpha + beta -
ll, whose float32 roundings at |ll| in the thousands (ulp 2.4e-4 at 2,400)
leave a frame's occupancies summing to 1 only within ~1e-3, and the port's
kernel path must err no more than the reference's kernel (1.01x); the two
autograd paths (`impl='torch'`, `ctc_loss_xla`) err several times less,
and the port's no more than twice the reference's. Each implementation's largest errors
and their share of the bound are printed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from pytorch_end2end_speech_recognition_tpu.ops.ctc import ctc_loss_xla
from pytorch_end2end_speech_recognition_tpu.ops.ctc_pallas import (
    ctc_loss_pallas,
)
from pytorch_end2end_speech_recognition_tpu_torch.ops.ctc import (
    ctc_lattice,
    ctc_loss,
    lattice_flags,
)
from pytorch_end2end_speech_recognition_tpu_torch.ops.ctc_kernel import (
    NEG_INF,
    ctc_alpha_plain,
)

U32 = 2.0 ** -24


def _case(T: int):
    """(logits (3, T, 32), frame lens, labels (3, 200), label lens): a full
    row with 200 labels (S 401), a row of 2T/3 frames with 120, and a full
    row with 60, labels drawn without immediate repeats."""
    rng = np.random.default_rng(T)
    B, V, U = 3, 32, 200
    logits = (rng.standard_normal((B, T, V)) * 2).astype(np.float32)
    tlen = np.asarray([T, 2 * T // 3, T], np.int32)
    llen = np.asarray([200, 120, 60], np.int32)
    steps = rng.integers(1, V - 1, (B, U))
    labels = (1 + np.cumsum(steps, 1) % (V - 1)).astype(np.int32)
    labels *= np.arange(U)[None, :] < llen[:, None]
    return logits, tlen, labels, llen


def _float64_reference(logits, tlen, labels, llen):
    """(ll (B,), grad of sum(-ll) wrt the logits (B, T, V), alpha (B, T,
    S)), all float64, by the port's plain alpha recursion on the lattice
    built in float64."""
    x = torch.from_numpy(logits).double().requires_grad_()
    lab = torch.from_numpy(labels).long()
    ll_t = torch.from_numpy(llen).long()
    ext = ctc_lattice(lab)
    B, T, _ = x.shape
    S = ext.shape[1]
    lp = F.log_softmax(x, -1).gather(2, ext[:, None, :].expand(B, T, S))
    skip, sok = lattice_flags(ext, ll_t)
    lp = torch.where(sok[:, None, :], lp, torch.full((), NEG_INF,
                                                     dtype=torch.float64))
    alpha, ll = ctc_alpha_plain(lp, skip, sok, torch.from_numpy(tlen).long(),
                                2 * ll_t)
    (-ll).sum().backward()
    return ll.detach().numpy(), x.grad.numpy(), alpha.detach().numpy(), sok


def _bounds(alpha, sok, tlen, logits, grad64):
    """(B_ll (B,), the gradient bound (B, T, V)) of the module docstring."""
    B = alpha.shape[0]
    b_ll = np.zeros(B)
    for b in range(B):
        a = np.abs(alpha[b, :tlen[b]][:, sok[b].numpy()])
        a = np.where(a < 1e29, a, 0.0)           # dead states hold NEG_INF
        b_ll[b] = np.sum(2 * U32 * a.max(axis=1) + 8 * U32)
    x = torch.from_numpy(logits).double()
    lse = torch.logsumexp(x, -1, keepdim=True)
    soft = torch.exp(x - lse).numpy()
    post = np.abs(soft - grad64)
    frame = np.arange(logits.shape[1])[None, :, None] < tlen[:, None, None]
    post, soft_f = np.where(frame, post, 0.0), np.where(frame, soft, 0.0)
    rounding = 4 * U32 * (1 + x.abs() + lse.abs()).numpy() * soft_f
    return b_ll, (3 * b_ll[:, None, None] * (post + soft_f) + rounding
                  + 4 * U32 * np.abs(grad64))


def _port(impl, logits, tlen, labels, llen):
    x = torch.from_numpy(logits).requires_grad_()
    loss = ctc_loss(x, *(torch.from_numpy(a) for a in (tlen, labels, llen)),
                    impl=impl)
    loss.sum().backward()
    return -loss.detach().double().numpy(), x.grad.double().numpy()


def _jax(loss_fn, logits, tlen, labels, llen):
    args = [jnp.asarray(a) for a in (tlen, labels, llen)]
    fn = lambda z: loss_fn(z, *args)  # noqa: E731
    loss = fn(jnp.asarray(logits))
    grad = jax.grad(lambda z: jnp.sum(fn(z)))(jnp.asarray(logits))
    return -np.asarray(loss, np.float64), np.asarray(grad, np.float64)


def _pallas(*case):
    with pltpu.force_tpu_interpret_mode():
        return _jax(ctc_loss_pallas, *case)


@pytest.mark.parametrize("T", [420, 800])
def test_ctc_float32_recursions_within_rounding_bound_of_float64(T):
    case = _case(T)
    logits, tlen, labels, llen = case
    ll64, g64, alpha, sok = _float64_reference(*case)
    assert np.all(ll64 > -1e29) and alpha.shape[2] == 401
    b_ll, b_g = _bounds(alpha, sok, tlen, logits, g64)
    err = {}
    for name, (ll, g) in {
            "ctc_loss(impl='torch')": _port("torch", *case),
            "ctc_loss_xla": _jax(ctc_loss_xla, *case),
            "kernel path, plain versions": _port("cuda", *case),
            "ctc_loss_pallas": _pallas(*case)}.items():
        d_ll, d_g = np.abs(ll - ll64), np.abs(g - g64)
        err[name] = d_g.max()
        share = (d_g / np.maximum(b_g, 1e-30)).max()
        print(f"T {T}, {name}: |d ll| {d_ll.max():.3e} ({(d_ll / b_ll).max():.4f}"
              f" of B_ll {b_ll.max():.3e}), |d grad| {d_g.max():.3e} "
              f"({share:.4f} of its bound)")
        assert np.all(d_ll <= b_ll), (name, d_ll, b_ll)
        assert np.all(d_g <= b_g), (name, share)
    assert err["ctc_loss(impl='torch')"] <= 2 * err["ctc_loss_xla"] + 1e-7
    assert err["kernel path, plain versions"] <= 1.01 * err["ctc_loss_pallas"]
