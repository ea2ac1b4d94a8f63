"""The port's LSTM recurrence against the JAX package: the plain versions of
the recurrence kernels (`ops/rnn_kernel.py`) against `_fwd_call` and the
`lstm_seq_pallas` VJP in interpret mode, also through `lstm_scan_pallas`
in both directions; the port's `lstm_scan` (initial and final states
included) against JAX `lstm_scan`; `LstmSeq` against autograd through the
plain scan; `flip_sequences`. float32; B 4, T 37, H 16, lengths with a 0;
inputs made with numpy from a seed."""

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

B, T, D, H = 4, 37, 12, 16
LENS = np.asarray([37, 20, 5, 0], np.int32)


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    f = lambda *s, k=1.0: (rng.standard_normal(s) * k).astype(np.float32)  # noqa: E731
    return dict(x=f(B, T, D), wih=f(D, 4 * H, k=0.2), whh=f(H, 4 * H, k=0.2),
                b=f(4 * H, k=0.1), g=f(B, T, H), h0=f(B, H, k=0.5),
                c0=f(B, H, k=0.5))


def _t(a):
    return torch.from_numpy(np.array(a))


def _weights(shape):
    """A fixed cotangent pattern, as the JAX package's kernel test uses."""
    return np.cos(np.arange(np.prod(shape))).reshape(shape).astype(np.float32)


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_kernels_match_pallas_interpret(reverse):
    """`lstm_seq_fwd_plain` against `_fwd_call` (h_all and the frozen
    c_all) and `lstm_seq_bwd_plain` against the `lstm_seq_pallas` VJP (dxg,
    dW_hh), on the gates of either direction's (flipped) input."""
    a = _inputs()
    lens = jnp.asarray(LENS)
    x = jnp.asarray(a["x"])
    if reverse:
        x = jrnn.flip_sequences(x, lens)
    xg = x @ jnp.asarray(a["wih"]) + jnp.asarray(a["b"])
    whh = jnp.asarray(a["whh"])
    with pltpu.force_tpu_interpret_mode():
        h_ref, c_ref = jrp._fwd_call(xg, whh, lens)
        _, vjp = jax.vjp(lambda xg_, w_: jrp.lstm_seq_pallas(xg_, w_, lens),
                         xg, whh)
        dxg_ref, dwhh_ref = vjp(jnp.asarray(a["g"]))
    args = [_t(xg), _t(whh), _t(LENS)]
    h, c = trk.lstm_seq_fwd_plain(*args)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), rtol=1e-5,
                               atol=1e-5)
    assert torch.all(h[3] == 0) and torch.all(c[3] == 0)
    assert torch.equal(c[2, 5:], c[2, 4:5].expand(T - 5, H))  # frozen
    dxg, dwhh = trk.lstm_seq_bwd_plain(*args, h, c, _t(a["g"]))
    np.testing.assert_allclose(dxg.numpy(), np.asarray(dxg_ref), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(dwhh.numpy(), np.asarray(dwhh_ref), rtol=1e-4,
                               atol=1e-5)
    assert torch.all(dxg[3] == 0) and torch.all(dxg[2, 5:] == 0)


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_kernel_matches_lstm_scan_pallas(reverse):
    """`lstm_scan_kernel` (the kernels' plain versions on CPU tensors)
    against `lstm_scan_pallas` in interpret mode: outputs and the gradients
    of a weighted sum wrt (W_ih, W_hh, b, x)."""
    a = _inputs(1)
    w = _weights((B, T, H))
    lens = jnp.asarray(LENS)

    def loss_j(x, wih, whh, b):
        y = jrp.lstm_scan_pallas(x, lens, wih, whh, b, reverse=reverse)
        return jnp.sum(y * w), y

    with pltpu.force_tpu_interpret_mode():
        (_, y_ref), g_ref = jax.value_and_grad(loss_j, argnums=(0, 1, 2, 3),
                                               has_aux=True)(
            *(jnp.asarray(a[k]) for k in ("x", "wih", "whh", "b")))
    ts = [_t(a[k]).requires_grad_() for k in ("x", "wih", "whh", "b")]
    y = trk.lstm_scan_kernel(ts[0], _t(LENS), *ts[1:], reverse=reverse)
    (y * _t(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               rtol=1e-5, atol=1e-5)
    for name, t, r in zip(("x", "wih", "whh", "b"), ts, g_ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_scan_matches_jax(reverse):
    """Outputs and the final (h, c) from given initial states; a row of
    length 0 returns its initial state."""
    a = _inputs(2)
    args = [a[k] for k in ("x",)] + [LENS] + [a[k] for k in ("wih", "whh",
                                                              "b")]
    ys_ref, (h_ref, c_ref) = jrnn.lstm_scan(
        *map(jnp.asarray, args), reverse=reverse, h0=jnp.asarray(a["h0"]),
        c0=jnp.asarray(a["c0"]))
    ys, (h, c) = trnn.lstm_scan(*map(_t, args), reverse=reverse,
                                h0=_t(a["h0"]), c0=_t(a["c0"]))
    for got, want in ((ys, ys_ref), (h, h_ref), (c, c_ref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    assert torch.equal(h[3], _t(a["h0"])[3]) and torch.all(ys[3] == 0)


def test_lstm_seq_matches_autograd_through_plain_scan():
    """`LstmSeq` (the kernels' plain versions) inside `lstm_scan_kernel`
    against autograd through the plain `lstm_scan`, float32: the two
    compute the same function, so outputs and gradients agree to float32
    rounding."""
    a = _inputs(4)
    w = _t(_weights((B, T, H)))
    grads = []
    for fn in (lambda *p: trnn.lstm_scan(*p)[0], trk.lstm_scan_kernel):
        ts = [_t(a[k]).requires_grad_() for k in ("x", "wih", "whh", "b")]
        y = fn(ts[0], _t(LENS), *ts[1:])
        (y * w).sum().backward()
        grads.append([y.detach()] + [t.grad for t in ts])
    for name, got, want in zip(("y", "x", "wih", "whh", "b"), *grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6,
                                   msg=name)


def test_flip_sequences_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, T, 3)).astype(np.float32)
    for a in (x, x[..., 0]):
        np.testing.assert_array_equal(
            trnn.flip_sequences(_t(a), _t(LENS)).numpy(),
            np.asarray(jrnn.flip_sequences(jnp.asarray(a),
                                           jnp.asarray(LENS))))


def test_bilstm_layer_impls_agree_and_reject_unknown():
    """impl='cuda' on CPU tensors runs the kernels' plain versions: the
    same layer output as impl='torch' in float32."""
    a = _inputs(6)
    p = tuple(_t(a[k]) for k in ("wih", "whh", "b"))
    q = tuple(t * 0.5 for t in p)
    x, lens = _t(a["x"]), _t(LENS)
    ref = trnn.bilstm_layer(x, lens, p, q, impl="torch")
    got = trnn.bilstm_layer(x, lens, p, q, impl="cuda")
    assert ref.shape == (B, T, 2 * H)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="lstm impl"):
        trnn.bilstm_layer(x, lens, p, q, impl="pallas")
