"""One full update of the port's Solver (hybrid step, global-norm clip,
adamw, noam) against the JAX package's `Solver.train_step` itself, at
flagship-small with the JAX weights bridged in (the case:
`torch_train_case.py`): the step's metrics and every parameter after it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch_train_case as case_mod

from pytorch_end2end_speech_recognition_tpu_torch import bridge


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    c = case_mod.build(tmp_path_factory.mktemp("update"))
    js = c["jsolver"]
    new_params, _, _, jm = js._train_step(
        js.params, js.opt_state, js.rest, *c["arrays"], c["key"],
        jnp.asarray(1.0, jnp.float32))
    c["jstep"] = case_mod.scalars(jm)
    c["jnew"] = case_mod.flat(new_params)
    tsolver = case_mod.port_solver(c)
    _, tg = tsolver.grads(c["batch"], spec_mask=c["mask"])
    c["tgrads"] = {k: g.numpy() for k, g in zip(tsolver.names, tg)}
    c["tstep"] = case_mod.scalars(tsolver.train_step(c["batch"],
                                                     spec_mask=c["mask"]))
    c["tnew"] = {k: p.detach().numpy().copy()
                 for k, p in tsolver.model.named_parameters()}
    c["lr0"] = tsolver.opt.schedule(0)
    return c


def test_step_metrics_match_jax_train_step(case):
    """loss, ctc_loss, att_loss and grad_norm (before the clip, which this
    step triggers) as `Solver.train_step` reports them."""
    for k in ("loss", "ctc_loss", "att_loss", "grad_norm"):
        assert case["tstep"][k] == pytest.approx(case["jstep"][k],
                                                 rel=1e-5), k
    assert case["jstep"]["grad_norm"] > case["jcfg"].train.grad_clip


def test_every_parameter_after_one_update_matches_jax(case):
    """Adam's first step moves an element by lr0 g / (|g| + 1e-8) plus the
    weight decay: sign-like, so an element whose gradient is within the two
    packages' float32 noise of zero may move either way. Every element must
    lie within 2 lr0 of JAX's; those with |g| above 1e-3 of the tensor's
    largest gradient and above 1e-6 (most elements) within 1e-3 lr0 + 1e-7
    |p|; the typical element moved by about lr0."""
    lr0 = case["lr0"]
    assert lr0 == pytest.approx(1e-3 * 10 ** 0.5 * 10 ** -1.5)
    n_clear = n_all = 0
    moved = []
    for name, want in case["jnew"].items():
        key, want = bridge._convert(name, want)
        got, g = case["tnew"][key], case["tgrads"][key]
        _, p0 = bridge._convert(name, case["flat0"][name])
        assert np.abs(got - want).max() <= 2 * lr0 * (1 + np.abs(p0).max()), key
        clear = (np.abs(g) > 1e-3 * np.abs(g).max()) & (np.abs(g) > 1e-6)
        np.testing.assert_allclose(got[clear], want[clear], rtol=1e-7,
                                   atol=1e-3 * lr0, err_msg=key)
        moved.append(np.abs(want - p0)[clear])
        n_clear += int(clear.sum())
        n_all += clear.size
    assert n_clear > 0.9 * n_all
    assert np.median(np.concatenate(moved)) > 0.5 * lr0
