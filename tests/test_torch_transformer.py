"""Rung 3 (`libri100_transformer`) of the port against the JAX package, with
the JAX weights bridged in, at rung-3-small (2 encoder layers, d64, H4, FFN
256, a 2-layer transformer decoder, vocab 64): the `TransformerEncoder` with
relative and with absolute position encoding, the `AsrModel` encode + CTC
logits, and one hybrid `Solver.train_step` against the JAX
`Solver.train_step` (loss, every gradient, every parameter after the update;
the case: `torch_train_case.py`, SpecAugment mask injected, dropout 0).
float32 on the CPU; inputs made with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_train_case as case_mod
from flax import nnx

from pytorch_end2end_speech_recognition_tpu.models import encoders as jenc
from pytorch_end2end_speech_recognition_tpu_torch import bridge
from pytorch_end2end_speech_recognition_tpu_torch.models import encoders as tenc

PRESET = "libri100_transformer"


def _bridged(jmodule) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in (
        bridge._convert(n, a) for n, a in case_mod.flat(jmodule).items())}


@pytest.mark.parametrize("pos", ["relative", "absolute"])
def test_transformer_encoder_matches_jax(pos):
    """(B=3, T=61, F=20) features with lengths 61/40/0 through 2 Transformer
    blocks: the encoder output (float32, after ln_out, masked) within 1e-5
    and the lengths exact; absolute PE adds the sinusoids and has no bias
    table. The relative-bias table is drawn at std 1 so that the bias moves
    the output."""
    jcfg, tcfg = case_mod.configs(2, preset=PRESET)
    for c in (jcfg, tcfg):
        c.model.pos_encoding = pos
    j = jenc.TransformerEncoder(20, jcfg.model, nnx.Rngs(0))
    t = tenc.TransformerEncoder(20, tcfg.model)
    assert (t.rel is None) == (pos == "absolute")
    if pos == "relative":
        j.rel.table[...] = jax.random.normal(jax.random.PRNGKey(1),
                                             j.rel.table[...].shape)
    t.load_state_dict(_bridged(j))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 61, 20)).astype(np.float32)
    lens = np.asarray([61, 40, 0], np.int32)
    ref, ref_lens = nnx.jit(lambda m, a, b: m(a, b))(j, jnp.asarray(x),
                                                    jnp.asarray(lens))
    with torch.no_grad():
        out, out_lens = t(torch.from_numpy(x), torch.from_numpy(lens))
    assert out.shape == ref.shape == (3, 16, 64) and out.dtype == torch.float32
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(ref_lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    assert torch.all(out[2] == 0) and torch.all(out[1, 10:] == 0)


def test_asr_model_encode_and_ctc_logits_match_jax():
    """The serving path, frontend to CTC logits (vocab 64), on rows of 2 s
    and 1.5 s and a pad row: logits within 1e-4 relative + 1e-5."""
    from pytorch_end2end_speech_recognition_tpu.models.asr import (
        AsrModel as JAsrModel,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.models.asr import (
        AsrModel,
    )

    jcfg, tcfg = case_mod.configs(2, preset=PRESET)
    jm = JAsrModel(jcfg, nnx.Rngs(0))
    tm = AsrModel(tcfg, device="cpu").eval()
    assert isinstance(tm.encoder, tenc.TransformerEncoder)
    assert tm.decoder is not None and len(tm.decoder.blocks) == 2
    missing, unexpected = tm.load_state_dict(
        bridge.state_dict_from_jax(case_mod.flat(jm)), strict=False)
    assert not unexpected and all(k.startswith("frontend.") for k in missing)
    rng = np.random.default_rng(3)
    audio = (rng.standard_normal((3, 32000)) * 0.1).astype(np.float32)
    alens = np.asarray([32000, 24000, 0], np.int32)
    audio *= np.arange(32000)[None, :] < alens[:, None]
    logits_j, lens_j = nnx.jit(lambda m, a, al: (
        lambda e, el: (m.ctc_logits(e), el))(*m.encode(a, al)))(
        jm, jnp.asarray(audio), jnp.asarray(alens))
    with torch.no_grad():
        enc, lens = tm.encode(torch.from_numpy(audio), torch.from_numpy(alens))
        logits = tm.ctc_logits(enc)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(lens_j))
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j),
                               rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The JAX Solver's own train step and the gradients of its loss, and
    the port's Solver with the JAX weights and SpecAugment mask."""
    from pytorch_end2end_speech_recognition_tpu.training.losses import (
        hybrid_loss,
    )

    c = case_mod.build(tmp_path_factory.mktemp("rung3"), layers=2,
                       preset=PRESET)
    jcfg, arrays, key = c["jcfg"], c["arrays"], c["key"]
    graphdef, params, rest = nnx.split(c["jmodel"], nnx.Param, ...)

    def loss_fn(params):  # training/solver.py:121-142
        model = nnx.merge(graphdef, params, rest)
        k_spec, k_dec = jax.random.split(key)
        enc, enc_lens = model.encode(arrays[0], arrays[1], train=True,
                                     rng=k_spec)
        att = model.decoder(enc, enc_lens, arrays[2], arrays[3], train=True,
                            rng=k_dec)
        return hybrid_loss(model.ctc_logits(enc), enc_lens, att, arrays[2],
                           arrays[3], jcfg.model.ctc_weight,
                           jcfg.model.label_smoothing,
                           ctc_impl=jcfg.model.ctc_impl)[0]

    c["jgrads"] = case_mod.flat(jax.jit(jax.grad(loss_fn))(params))
    js = c["jsolver"]
    new_params, _, _, jm = js._train_step(
        js.params, js.opt_state, js.rest, *arrays, key,
        jnp.asarray(1.0, jnp.float32))
    c["jstep"], c["jnew"] = case_mod.scalars(jm), case_mod.flat(new_params)
    ts = case_mod.port_solver(c)
    assert isinstance(ts.model.encoder, tenc.TransformerEncoder)
    _, tg = ts.grads(c["batch"], spec_mask=c["mask"])
    c["tgrads"] = {k: g.numpy() for k, g in zip(ts.names, tg)}
    c["tstep"] = case_mod.scalars(ts.train_step(c["batch"],
                                                spec_mask=c["mask"]))
    c["tnew"] = {k: p.detach().numpy().copy()
                 for k, p in ts.model.named_parameters()}
    c["lr0"] = ts.opt.schedule(0)
    return c


def test_train_step_metrics_match_jax(case):
    """loss, ctc_loss, att_loss and grad_norm of one update (1e-5)."""
    assert case["mask"].min() == 0
    for k in ("loss", "ctc_loss", "att_loss", "grad_norm"):
        assert case["tstep"][k] == pytest.approx(case["jstep"][k],
                                                 rel=1e-5), k


def test_train_step_every_gradient_matches_jax(case):
    """Each parameter's gradient elementwise within 1e-4 of the tensor's
    largest JAX gradient, plus 1e-7 absolute, every parameter of the port
    compared."""
    names = set()
    for name, want in case["jgrads"].items():
        key, want = bridge._convert(name, want)
        names.add(key)
        np.testing.assert_allclose(
            case["tgrads"][key], want, rtol=0,
            atol=1e-4 * float(np.abs(want).max()) + 1e-7, err_msg=key)
    assert names == set(case["tgrads"])


def test_train_step_update_matches_jax(case):
    """Every parameter after one update against the JAX step's own: within
    2 lr0 everywhere (Adam's first step is sign-like), and within 1e-3 lr0
    where |g| is above 1e-3 of the tensor's largest and above 1e-6, which
    holds for most elements."""
    lr0 = case["lr0"]
    names, n_clear, n_all = set(), 0, 0
    for name, want in case["jnew"].items():
        key, want = bridge._convert(name, want)
        names.add(key)
        got, g = case["tnew"][key], case["tgrads"][key]
        _, p0 = bridge._convert(name, case["flat0"][name])
        assert np.abs(got - want).max() <= 2 * lr0 * (1 + np.abs(p0).max()), \
            key
        clear = (np.abs(g) > 1e-3 * np.abs(g).max()) & (np.abs(g) > 1e-6)
        np.testing.assert_allclose(got[clear], want[clear], rtol=1e-7,
                                   atol=1e-3 * lr0, err_msg=key)
        n_clear += int(clear.sum())
        n_all += clear.size
    assert names == set(case["tnew"])
    assert n_clear > 0.85 * n_all
