"""The hybrid training step's loss and gradients (SpecAugment -> encoder ->
CTC + transformer decoder -> hybrid loss -> backward) of the port's Solver
against the JAX Solver.train_step's loss function, at flagship-small with
the JAX weights bridged in (the case: `torch_train_case.py`): float32 on
the CPU, dropout 0, the JAX SpecAugment mask injected, a ragged batch with
one pad row."""

import jax
import numpy as np
import pytest
import torch
import torch_train_case as case_mod
from flax import nnx

from pytorch_end2end_speech_recognition_tpu_torch import bridge
from pytorch_end2end_speech_recognition_tpu_torch.ops import attention_kernel as ak


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The JAX loss function of `Solver._build_train_step` (replicated:
    it is a closure there) with its gradients, and the port's
    `Solver.grads` on the same batch, weights and mask."""
    from pytorch_end2end_speech_recognition_tpu.training.losses import (
        hybrid_loss,
    )

    c = case_mod.build(tmp_path_factory.mktemp("train"))
    jcfg, arrays, key = c["jcfg"], c["arrays"], c["key"]
    graphdef, params, rest = nnx.split(c["jmodel"], nnx.Param, ...)

    def loss_fn(params):  # training/solver.py:121-142
        model = nnx.merge(graphdef, params, rest)
        k_spec, k_dec = jax.random.split(key)
        enc, enc_lens = model.encode(arrays[0], arrays[1], train=True,
                                     rng=k_spec)
        logits = model.ctc_logits(enc)
        att = model.decoder(enc, enc_lens, arrays[2], arrays[3], train=True,
                            rng=k_dec)
        return hybrid_loss(logits, enc_lens, att, arrays[2], arrays[3],
                           jcfg.model.ctc_weight, jcfg.model.label_smoothing,
                           ctc_impl=jcfg.model.ctc_impl)

    (_, jm), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    jg = case_mod.flat(jg)
    c["jmetrics"] = case_mod.scalars(jm)
    c["jmetrics"]["grad_norm"] = float(np.sqrt(sum(
        (g.astype(np.float64) ** 2).sum() for g in jg.values())))
    c["jgrads"] = jg
    c["tsolver"] = tsolver = case_mod.port_solver(c)
    tm, tg = tsolver.grads(c["batch"], spec_mask=c["mask"])
    c["tmetrics"] = case_mod.scalars(tm)
    c["tgrads"] = dict(zip(tsolver.names, tg))
    return c


def test_losses_match_jax(case):
    """loss, ctc_loss and att_loss: float32 through 4 conformer layers, the
    decoder and a 32-frame CTC lattice (~1e-6 relative measured)."""
    for k in ("loss", "ctc_loss", "att_loss"):
        assert case["tmetrics"][k] == pytest.approx(case["jmetrics"][k],
                                                    rel=1e-5), k


def test_every_gradient_matches_jax(case):
    """Each parameter's gradient elementwise within 1e-4 of the tensor's
    largest JAX gradient, plus 1e-7 absolute (worst measured: 1.4e-5
    relative, the relative-bias table). The key projections' biases have
    zero gradient in exact arithmetic (softmax ignores a shift common to a
    row's scores) and carry only float32 noise of ~1e-8 on both sides."""
    tg, names = case["tgrads"], set()
    for name, g in case["jgrads"].items():
        key, want = bridge._convert(name, g)
        names.add(key)
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(tg[key].numpy(), want, rtol=0,
                                   atol=1e-4 * scale + 1e-7, err_msg=key)
    assert names == set(tg)
    norm = np.sqrt(sum((g.numpy().astype(np.float64) ** 2).sum()
                       for g in tg.values()))
    assert norm == pytest.approx(case["jmetrics"]["grad_norm"], rel=1e-5)


def test_cotangent_is_zero_on_masked_attention_rows(case, monkeypatch):
    """On the main path the attention output's cotangent is exactly zero on
    query rows at or past a row's length and on the pad row (lens 0), where
    the port's kernel (0) and the reference (weights on key 0 on its CPU
    path, the mean of v in its TPU kernel) compute different outputs; so
    the parameter gradients above cannot see that difference."""
    seen = []
    plain = ak.attention_plain

    def spy(q, k, v, bias, lens, heads):
        out = plain(q, k, v, bias, lens, heads)
        out.register_hook(lambda g: seen.append((g.detach().clone(), lens)))
        return out

    monkeypatch.setattr(ak, "attention_plain", spy)
    tsolver = case["tsolver"]
    tsolver.grads(case["batch"], spec_mask=case["mask"])
    assert len(seen) == tsolver.cfg.model.encoder_layers
    for g, lens in seen:
        past = torch.arange(g.shape[1])[None, :] >= lens[:, None]
        assert int(lens.min()) == 0 and g.abs().sum() > 0
        assert torch.all(g[past] == 0)
