"""The port's CTC loss against the JAX package: the plain alpha recursion
(`ctc_loss(impl='torch')`, autograd gradient) against `ctc_loss_xla`, and
the kernel path with its plain kernel versions (`impl='cuda'` on CPU
tensors) against `ctc_loss_pallas` in interpret mode; `torch.nn.functional.ctc_loss`
as a third oracle. float32; inputs made with numpy from a seed."""

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
from pytorch_end2end_speech_recognition_tpu_torch.ops import ctc_kernel
from pytorch_end2end_speech_recognition_tpu_torch.ops.ctc import (
    ctc_loss,
    lattice_inputs,
)


def _case(kind: str):
    """(logits, logit_lens, labels, label_lens, rows a path can explain).
    'crafted' (B 5, T 20, V 8, U 6): repeated labels in row 0, an
    impossible row 3 (6 labels in 4 frames) and a pad row 4 (no frames);
    'ragged' (B 6, T 33, V 11, U 9): random lengths, a pad row without
    labels; 'wide' (B 3, T 40, V 12, U 200): the S = 401 lattice of the
    LSTM rungs' steps, a row no path can explain (200 labels); 'short' (B 5,
    T 12, V 8, U 4): rows of one frame (with a label, and without, which
    counts as a pad row) beside a pad row of no frames."""
    if kind == "crafted":
        rng = np.random.default_rng(5)
        B, T, V, U = 5, 20, 8, 6
        logit_lens = np.asarray([20, 15, 20, 4, 0], np.int32)
        label_lens = np.asarray([6, 4, 1, 6, 3], np.int32)
        explained = [0, 1, 2]
    elif kind == "ragged":
        rng = np.random.default_rng(7)
        B, T, V, U = 6, 33, 11, 9
        logit_lens = np.asarray([33, 30, 19, 27, 33, 12], np.int32)
        label_lens = np.asarray([9, 3, 7, 0, 1, 5], np.int32)
        explained = [0, 1, 2, 4, 5]
    elif kind == "wide":
        rng = np.random.default_rng(11)
        B, T, V, U = 3, 40, 12, 200
        logit_lens = np.asarray([40, 31, 40], np.int32)
        label_lens = np.asarray([19, 12, 200], np.int32)
        explained = [0, 1]
    else:
        rng = np.random.default_rng(13)
        B, T, V, U = 5, 12, 8, 4
        logit_lens = np.asarray([1, 12, 1, 7, 0], np.int32)
        label_lens = np.asarray([1, 4, 0, 3, 2], np.int32)
        explained = [0, 1, 3]
    logits = rng.standard_normal((B, T, V)).astype(np.float32) * 2
    labels = rng.integers(1, V, (B, U)).astype(np.int32)
    if kind == "crafted":
        labels[0] = [2, 2, 3, 3, 2, 5]
    labels *= np.arange(U)[None, :] < label_lens[:, None]
    return logits, logit_lens, labels, label_lens, explained


def _jax_loss_grad(fn, logits, logit_lens, labels, label_lens, w):
    args = [jnp.asarray(a) for a in (logit_lens, labels, label_lens)]
    loss = fn(jnp.asarray(logits), *args)
    grad = jax.grad(lambda x: jnp.sum(fn(x, *args) * w))(jnp.asarray(logits))
    return np.asarray(loss), np.asarray(grad)


def _torch_loss_grad(fn, logits, logit_lens, labels, label_lens, w):
    x = torch.from_numpy(logits).requires_grad_()
    loss = fn(x, *(torch.from_numpy(a) for a in (logit_lens, labels,
                                                 label_lens)))
    (loss * torch.from_numpy(w)).sum().backward()
    return loss.detach().numpy(), x.grad.numpy()


# float32 recursions over <= 33 frames in another order: losses agree to
# ~1e-6 relative, gradients (probabilities) to ~1e-6 absolute; 1e-5/1e-5 as
# the JAX package's own CTC tests state
RTOL, ATOL = 1e-5, 1e-5


@pytest.mark.parametrize("kind", ["crafted", "ragged"])
def test_plain_loss_and_grad_match_ctc_loss_xla(kind):
    logits, tl, lab, ll, _ = _case(kind)
    w = np.linspace(0.5, 1.5, len(tl)).astype(np.float32)
    ref_loss, ref_grad = _jax_loss_grad(ctc_loss_xla, logits, tl, lab, ll, w)
    loss, grad = _torch_loss_grad(lambda *a: ctc_loss(*a, impl="torch"),
                                  logits, tl, lab, ll, w)
    np.testing.assert_allclose(loss, ref_loss, rtol=RTOL, atol=ATOL)
    # on a row no path can explain ctc_loss_xla differentiates a log-sum-exp
    # of NEG_INF values and leaves an arbitrary gradient; the port gives it
    # none, as ctc_loss_pallas does
    possible = ref_loss < 1e29
    np.testing.assert_allclose(grad[possible], ref_grad[possible], rtol=RTOL,
                               atol=ATOL)
    assert not grad[~possible].any()
    assert loss[tl == 0].tolist() == [0.0] * int((tl == 0).sum())


@pytest.mark.parametrize("kind", ["crafted", "ragged", "wide", "short"])
def test_kernel_path_matches_ctc_loss_pallas_interpret(kind):
    """The kernel path's plain versions (alpha recursion, beta recursion and
    gradient, the autograd.Function around them) against the TPU kernels:
    the impossible row gets loss 1e30 and a zero gradient in both."""
    logits, tl, lab, ll, _ = _case(kind)
    w = np.linspace(0.5, 1.5, len(tl)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref_loss, ref_grad = _jax_loss_grad(ctc_loss_pallas, logits, tl, lab,
                                            ll, w)
    before = (ctc_kernel.ctc_alpha.launches, ctc_kernel.ctc_beta.launches)
    loss, grad = _torch_loss_grad(
        lambda *a: ctc_loss(*a, impl="cuda"), logits, tl, lab, ll, w)
    assert (ctc_kernel.ctc_alpha.launches,
            ctc_kernel.ctc_beta.launches) == before  # plain on CPU tensors
    np.testing.assert_allclose(loss, ref_loss, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(grad, ref_grad, rtol=RTOL, atol=ATOL)
    if kind == "crafted":
        assert loss[3] == pytest.approx(1e30) and not grad[3].any()
        assert loss[4] == 0.0 and not grad[4].any()


@pytest.mark.parametrize("kind", ["crafted", "ragged", "wide", "short"])
@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_both_paths_match_torch_ctc_loss(kind, impl):
    """torch's own CTC as a third oracle, on the rows a path can explain
    (its pad-row convention differs: no frames is an impossible row)."""
    logits, tl, lab, ll, rows = _case(kind)
    w = np.zeros(len(tl), np.float32)
    w[rows] = 1.0
    loss, grad = _torch_loss_grad(lambda *a: ctc_loss(*a, impl=impl),
                                  logits, tl, lab, ll, w)
    x = torch.from_numpy(logits).requires_grad_()
    ref = F.ctc_loss(F.log_softmax(x, -1).transpose(0, 1),
                     torch.from_numpy(lab).long(), torch.from_numpy(tl).long(),
                     torch.from_numpy(ll).long(), reduction="none",
                     zero_infinity=True)
    (ref * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(loss[rows], ref.detach().numpy()[rows],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(grad, x.grad.numpy(), rtol=RTOL, atol=ATOL)


def test_plain_kernel_versions_agree_with_each_other():
    """alpha/beta plain versions: the gradient from the beta recursion equals
    autograd through the alpha recursion's log-likelihood."""
    logits, tl, lab, ll, _ = _case("ragged")
    lat, skip, sok = lattice_inputs(torch.from_numpy(logits),
                                    torch.from_numpy(lab), torch.from_numpy(ll))
    lat = lat.detach().requires_grad_()
    tlen, last = torch.from_numpy(tl), 2 * torch.from_numpy(ll)
    alpha, llh = ctc_kernel.ctc_alpha_plain(lat, skip, sok, tlen, last)
    g = torch.linspace(0.5, 1.5, len(tl))
    (llh * g).sum().backward()
    grad = ctc_kernel.ctc_beta_plain(lat.detach(), skip, sok, tlen, last,
                                     alpha.detach(), llh.detach(), g)
    np.testing.assert_allclose(grad.numpy(), lat.grad.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("kind", ["crafted", "ragged", "short"])
@pytest.mark.parametrize("pad_to", [32, 7])
def test_padded_lattice_gives_the_unpadded_states_exactly(kind, pad_to):
    """The kernels' layout (`lattice_inputs(..., pad_to)`: padded states
    NEG_INF, both flags False) through the plain versions: alpha, ll and the
    gradient of the first S states equal the unpadded lattice's bit for
    bit, and the padded states keep NEG_INF and a zero gradient."""
    logits, tl, lab, ll, _ = _case(kind)
    args = [torch.from_numpy(a) for a in (logits, lab, ll)]
    lat, skip, sok = lattice_inputs(*args)
    lat_p, skip_p, sok_p = lattice_inputs(*args, pad_to=pad_to)
    S = lat.shape[2]
    assert lat_p.shape[2] % pad_to == 0 and lat_p.shape[2] - S < pad_to
    assert torch.equal(lat_p[..., :S], lat) and torch.equal(
        skip_p[:, :S], skip) and torch.equal(sok_p[:, :S], sok)
    assert not skip_p[:, S:].any() and not sok_p[:, S:].any()
    assert bool((lat_p[..., S:] == ctc_kernel.NEG_INF).all())
    tlen, last = torch.from_numpy(tl), 2 * args[2]
    g = torch.linspace(0.5, 1.5, len(tl))
    alpha, llh = ctc_kernel.ctc_alpha_plain(lat, skip, sok, tlen, last)
    alpha_p, llh_p = ctc_kernel.ctc_alpha_plain(lat_p, skip_p, sok_p, tlen,
                                                last)
    assert torch.equal(alpha_p[..., :S], alpha) and torch.equal(llh_p, llh)
    assert bool((alpha_p[..., S:] == ctc_kernel.NEG_INF).all())
    grad = ctc_kernel.ctc_beta_plain(lat, skip, sok, tlen, last, alpha, llh,
                                     g)
    grad_p = ctc_kernel.ctc_beta_plain(lat_p, skip_p, sok_p, tlen, last,
                                       alpha_p, llh_p, g)
    assert torch.equal(grad_p[..., :S], grad) and not grad_p[..., S:].any()
