"""The port's two-direction LSTM recurrence (`ops/rnn_kernel.py`: D
directions stacked in one call, and the backward as three parts: the gate
activations of every step, the reverse-time recurrence on them, dW_hh)
against the JAX package's `rnn_pallas` kernels in interpret mode: two calls
of `lstm_seq_pallas`, one per direction, outputs and VJP; `_vjp_bwd`; the
gate activations against `_gates_fwd`. float32, tolerance 1e-5; B 3, T 7,
H 8 and 16, ragged lengths with a zero-length row; inputs made with numpy
from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pytorch_end2end_speech_recognition_tpu.ops import rnn as jrnn
from pytorch_end2end_speech_recognition_tpu.ops import rnn_pallas as jrp
from pytorch_end2end_speech_recognition_tpu_torch.ops import rnn as trnn
from pytorch_end2end_speech_recognition_tpu_torch.ops import rnn_kernel as trk

B, T, D = 3, 7, 5
LENS = np.asarray([7, 0, 4], np.int32)
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(H: int, seed: int):
    """Both directions' xg (2, B, T, 4H) (the reverse one flipped, as
    `bilstm_layer` feeds it), W_hh (2, H, 4H) and a cotangent (2, B, T,
    H)."""
    rng = np.random.default_rng(seed)
    f = lambda *s, k=1.0: (rng.standard_normal(s) * k).astype(np.float32)  # noqa: E731
    x = f(B, T, D)
    xs = [x, np.asarray(jrnn.flip_sequences(jnp.asarray(x),
                                            jnp.asarray(LENS)))]
    wih, b = f(2, D, 4 * H, k=0.4), f(2, 4 * H, k=0.1)
    xg = np.stack([xs[d] @ wih[d] + b[d] for d in range(2)])
    return xg.astype(np.float32), f(2, H, 4 * H, k=0.3), f(2, B, T, H)


def _t(a):
    return torch.from_numpy(np.array(a))


def _pallas_both(xg, whh, g):
    """h_all, c_all, dxg, dW_hh of two interpret-mode `lstm_seq_pallas`
    calls, stacked."""
    lens = jnp.asarray(LENS)
    out = []
    with pltpu.force_tpu_interpret_mode():
        for d in range(2):
            h, c = jrp._fwd_call(jnp.asarray(xg[d]), jnp.asarray(whh[d]), lens)
            _, vjp = jax.vjp(lambda a, w: jrp.lstm_seq_pallas(a, w, lens),
                             jnp.asarray(xg[d]), jnp.asarray(whh[d]))
            out.append((h, c) + vjp(jnp.asarray(g[d])))
    return [np.stack([np.asarray(o[i]) for o in out]) for i in range(4)]


@pytest.mark.parametrize("H,seed", [(8, 0), (16, 1)])
def test_two_direction_plain_matches_two_pallas_calls(H, seed):
    """`lstm_fwd` and `lstm_bwd` on CPU tensors (the plain versions, both
    directions in one call) against one `lstm_seq_pallas` per direction:
    h_all, the frozen c_all, dxg and dW_hh."""
    xg, whh, g = _inputs(H, seed)
    h_ref, c_ref, dxg_ref, dwhh_ref = _pallas_both(xg, whh, g)
    h, c = trk.lstm_fwd(_t(xg), _t(whh), _t(LENS))
    dxg, dwhh = trk.lstm_bwd(_t(xg), _t(whh), _t(LENS), h, c, _t(g))
    for name, got, want in (("h", h, h_ref), ("c", c, c_ref),
                            ("dxg", dxg, dxg_ref), ("dW_hh", dwhh, dwhh_ref)):
        np.testing.assert_allclose(got.numpy(), want, err_msg=name, **TOL)
    assert torch.all(h[:, 1] == 0) and torch.all(dxg[:, 1] == 0)
    assert torch.all(h[:, 2, 4:] == 0) and torch.all(dxg[:, 2, 4:] == 0)
    assert torch.equal(c[:, 2, 4:], c[:, 2, 3:4].expand(2, T - 4, H))


@pytest.mark.parametrize("H,seed", [(8, 2), (16, 3)])
def test_backward_parts_compose_to_the_reference(H, seed):
    """The backward's three plain parts, composed, against the
    one-direction plain backward (`lstm_seq_bwd_plain`, the gates
    recomputed inside the loop) and against JAX `_vjp_bwd` in interpret
    mode; part (a) alone against `_gates_fwd` on the shifted h."""
    xg, whh, g = _inputs(H, seed)
    lens = jnp.asarray(LENS)
    h, c = trk.lstm_fwd_plain(_t(xg), _t(whh), _t(LENS))
    act = trk.lstm_bwd_gates_plain(_t(xg), _t(whh), h)
    dgates = trk.lstm_bwd_recur_plain(act, _t(whh), _t(LENS), c, _t(g))
    dwhh = trk.lstm_bwd_dw_plain(h, dgates)
    for d in range(2):
        ref = trk.lstm_seq_bwd_plain(_t(xg[d]), _t(whh[d]), _t(LENS), h[d],
                                     c[d], _t(g[d]))
        with pltpu.force_tpu_interpret_mode():
            jref = jrp._vjp_bwd((jnp.asarray(xg[d]), jnp.asarray(whh[d]), lens,
                                 jnp.asarray(h[d].numpy()),
                                 jnp.asarray(c[d].numpy())),
                                jnp.asarray(g[d]))
        for name, got, want in (("dxg", dgates[d], ref[0]),
                                ("dW_hh", dwhh[d], ref[1])):
            torch.testing.assert_close(got, want, msg=name, **TOL)
            np.testing.assert_allclose(
                got.numpy(), np.asarray(jref[0 if name == "dxg" else 1]),
                err_msg=name, **TOL)
        h_prev = np.pad(h[d].numpy(), ((0, 0), (1, 0), (0, 0)))[:, :T]
        for t in range(T):
            _, _, gates = jrp._gates_fwd(jnp.asarray(xg[d][:, t]),
                                         jnp.asarray(h_prev[:, t]),
                                         jnp.zeros((B, H)),
                                         jnp.asarray(whh[d]))
            np.testing.assert_allclose(act[d][:, t].numpy(),
                                       np.concatenate(gates, axis=-1),
                                       err_msg=f"activations, t={t}", **TOL)


@pytest.mark.parametrize("H,seed", [(8, 4), (16, 5)])
def test_lstm_layer_matches_autograd_through_two_pallas_scans(H, seed):
    """`bilstm_kernel` (one `LstmLayer` for both directions, on CPU
    tensors) against `lstm_scan_pallas` forward and reverse in interpret
    mode: outputs and the gradients of a weighted sum wrt x and both
    directions' (W_ih, W_hh, b)."""
    rng = np.random.default_rng(seed)
    f = lambda *s, k=1.0: (rng.standard_normal(s) * k).astype(np.float32)  # noqa: E731
    x = f(B, T, D)
    ps = [(f(D, 4 * H, k=0.4), f(H, 4 * H, k=0.3), f(4 * H, k=0.1))
          for _ in range(2)]
    w = f(B, T, 2 * H)
    lens = jnp.asarray(LENS)

    def loss_j(x_, pf, pb):
        yf = jrp.lstm_scan_pallas(x_, lens, *pf, reverse=False)
        yb = jrp.lstm_scan_pallas(x_, lens, *pb, reverse=True)
        y = jnp.concatenate([yf, yb], axis=-1)
        return jnp.sum(y * w), y

    with pltpu.force_tpu_interpret_mode():
        (_, y_ref), g_ref = jax.value_and_grad(loss_j, argnums=(0, 1, 2),
                                               has_aux=True)(
            jnp.asarray(x), *[tuple(map(jnp.asarray, p)) for p in ps])
    xt = _t(x).requires_grad_()
    pt = [tuple(_t(a).requires_grad_() for a in p) for p in ps]
    yf, yb = trk.bilstm_kernel(xt, _t(LENS), pt[0], pt[1])
    y = torch.cat([yf, yb], dim=-1)
    (y * _t(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_ref[0]),
                               err_msg="x", **TOL)
    for d in range(2):
        for name, a, r in zip(("w_ih", "w_hh", "b"), pt[d], g_ref[1 + d]):
            np.testing.assert_allclose(a.grad.numpy(), np.asarray(r),
                                       err_msg=f"{name}[{d}]", **TOL)


def test_bilstm_layer_cuda_is_one_stacked_call_of_the_kernels():
    """`bilstm_layer(impl='cuda')` on CPU tensors runs the kernels' plain
    versions through one stacked `lstm_fwd` call a layer (not one per
    direction) and gives the same output as the two one-direction calls
    of `lstm_scan_kernel`; an unknown impl raises."""
    rng = np.random.default_rng(6)
    f = lambda *s, k=1.0: _t((rng.standard_normal(s) * k).astype(np.float32))  # noqa: E731
    H = 8
    x = f(B, T, D)
    pf = (f(D, 4 * H, k=0.4), f(H, 4 * H, k=0.3), f(4 * H, k=0.1))
    pb = (f(D, 4 * H, k=0.4), f(H, 4 * H, k=0.3), f(4 * H, k=0.1))
    calls = []
    real = trk.lstm_fwd

    def spy(xg, whh, lens):
        calls.append(tuple(xg.shape))
        return real(xg, whh, lens)

    trk.lstm_fwd = spy
    try:
        got = trnn.bilstm_layer(x, _t(LENS), pf, pb, impl="cuda")
    finally:
        trk.lstm_fwd = real
    assert calls == [(2, B, T, 4 * H)]
    want = torch.cat([trk.lstm_scan_kernel(x, _t(LENS), *pf),
                      trk.lstm_scan_kernel(x, _t(LENS), *pb, reverse=True)],
                     dim=-1)
    torch.testing.assert_close(got, want, **TOL)
    with pytest.raises(ValueError, match="lstm impl"):
        trnn.bilstm_layer(x, _t(LENS), pf, pb, impl="pallas")


@pytest.mark.parametrize("H,seed", [(8, 7), (16, 8)])
def test_one_direction_is_a_stacked_call(H, seed):
    """`lstm_seq_fwd`/`lstm_seq_bwd` (one direction, D = 1 of the stacked
    wrappers) against the one-direction plain versions on CPU tensors."""
    xg, whh, g = _inputs(H, seed)
    args = (_t(xg[1]), _t(whh[1]), _t(LENS))
    h, c = trk.lstm_seq_fwd(*args)
    hp, cp = trk.lstm_seq_fwd_plain(*args)
    assert torch.equal(h, hp) and torch.equal(c, cp)
    dxg, dwhh = trk.lstm_seq_bwd(*args, h, c, _t(g[1]))
    ref = trk.lstm_seq_bwd_plain(*args, h, c, _t(g[1]))
    torch.testing.assert_close(dxg, ref[0], **TOL)
    torch.testing.assert_close(dwhh, ref[1], **TOL)
