"""The port's context parallelism (`..._torch/parallel/cp.py` and the
encoder's and the Solver's `cp_mode` paths) against the JAX package on the
CPU, with the tolerances of tests/test_cp.py (outputs rtol 2e-4, atol
2e-5; gradients rtol 5e-4, atol 5e-5).

The JAX side runs in this process, on a sub-mesh of the port's world
(`make_mesh(1, n, devices=jax.devices()[:n])`); the port's ranks are gloo
processes (`tests/torch_parallel_case.py`), one launch of two ranks and
one of four, each running every case of its world. Without a mesh the
port's `cp_mode` encoder is held to the JAX encoder in process."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from pytorch_end2end_speech_recognition_tpu.models.asr import (
    AsrModel as JAsrModel,
)
from pytorch_end2end_speech_recognition_tpu.models.encoders import (
    build_encoder as jbuild_encoder,
)
from pytorch_end2end_speech_recognition_tpu.parallel.cp import (
    sharded_self_attention as jsharded,
)
from pytorch_end2end_speech_recognition_tpu.parallel.mesh import (
    make_mesh as jmake_mesh,
)
from pytorch_end2end_speech_recognition_tpu.training.losses import (
    hybrid_loss as jhybrid_loss,
)
from pytorch_end2end_speech_recognition_tpu.training.solver import (
    Solver as JSolver,
)
from pytorch_end2end_speech_recognition_tpu.utils.config import (
    ModelConfig as JModelConfig,
)
from pytorch_end2end_speech_recognition_tpu_torch import bridge
from tests.test_torch_parallel import jax_cfg, make_batch, run_ranks
from tests.torch_train_case import flat

OUT_RTOL, OUT_ATOL = 2e-4, 2e-5
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5
LOSS_RTOL = 1e-4
MODES = ("ring", "ulysses")
# (world, mode, with the diagonals, T): T 62 pads to 64 at world 4
ATTN_CASES = [(2, m, b, 64) for m in MODES for b in (False, True)] + [
    (4, m, True, 62) for m in MODES]
# (world, mode, pos_encoding) of the CP encoder
ENC_CASES = [(2, m, pe) for m in MODES for pe in ("absolute", "relative")] + [
    (4, m, "relative") for m in MODES]


def sub_mesh(n: int):
    return jmake_mesh(dp=1, tp=n, devices=jax.devices()[:n])


def attn_inputs(T: int) -> dict:
    """tests/test_cp.py's q, k, v (B 2, H 8, D 16), lens and diagonals,
    cut to T frames."""
    rng = np.random.default_rng(0)
    B, H, D = 2, 8, 16
    q, k, v = (rng.standard_normal((B, 64, H, D)).astype(np.float32)[:, :T]
               for _ in range(3))
    diag = np.random.default_rng(5).standard_normal(
        (H, 2 * T - 1)).astype(np.float32)
    return {"q": q, "k": k, "v": v, "diag": diag,
            "lens": np.asarray([T, 37], np.int32)}


def jax_attention(a: dict, n: int, mode: str, bias: bool) -> dict:
    mesh = sub_mesh(n)
    q, k, v, diag, lens = (jnp.asarray(a[x]) for x in
                           ("q", "k", "v", "diag", "lens"))
    diag = diag if bias else None

    def run(q, k, v, d):
        return jsharded(mesh, q, k, v, lens, mode=mode, axis="model",
                        bias_diag=d)

    argnums = (0, 1, 2, 3) if bias else (0, 1, 2)
    grads = jax.jit(jax.grad(lambda *xs: jnp.sum(run(*xs) ** 2),
                             argnums=argnums))(q, k, v, diag)
    out = {"out": np.asarray(jax.jit(run)(q, k, v, diag))}
    out.update({n: np.asarray(g) for n, g in
                zip(("dq", "dk", "dv", "ddiag"), grads)})
    return out


def enc_cfg(mode: str, pe: str) -> dict:
    """tests/test_cp.py's CP encoder: a 2-layer Transformer, d32, H8."""
    return {"encoder": "transformer", "encoder_layers": 2, "encoder_dim": 32,
            "encoder_ffn_dim": 64, "encoder_heads": 8, "dtype": "float32",
            "pos_encoding": pe, "cp_mode": mode}


def jax_solver_grads(batch: dict, n: int, **extra) -> dict:
    """The JAX Solver on n devices (its model built on the mesh, its state
    sharded by the Solver): the bridged weights, and the hybrid loss and
    bridged gradients of its train step's loss function on `batch`."""
    cfg = jax_cfg(**extra)
    cfg.train.prng_impl = "threefry2x32"  # JAX's default: no global change
    cfg.train.metrics_path = ""
    mesh = sub_mesh(n)

    class _Tok:
        vocab_size = cfg.model.vocab_size

    solver = JSolver(cfg, _Tok(), model=JAsrModel(cfg, nnx.Rngs(0),
                                                  mesh=mesh), mesh=mesh)
    arrays = [jnp.asarray(batch[k]) for k in
              ("audio", "audio_lens", "tokens", "token_lens")]

    def loss_fn(params):
        m = nnx.merge(solver.graphdef, params, solver.rest)
        enc, enc_lens = m.encode(arrays[0], arrays[1], train=True)
        att = m.decoder(enc, enc_lens, arrays[2], arrays[3], train=True)
        return jhybrid_loss(m.ctc_logits(enc), enc_lens, att, arrays[2],
                            arrays[3], cfg.model.ctc_weight)[0]

    with mesh:
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(solver.params)
    return {"sd": bridge.state_dict_from_jax(flat(solver.params)),
            "loss": float(loss),
            "grads": bridge.state_dict_from_jax(flat(grads))}


@pytest.fixture(scope="module")
def refs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 130, 80)).astype(np.float32)
    lens = np.asarray([130, 77], np.int32)
    out = {"attn": {T: attn_inputs(T) for T in (62, 64)}, "x": x,
           "lens": lens, "enc_sd": {}, "enc": {}}
    out["attn_ref"] = {c: jax_attention(out["attn"][c[3]], *c[:3])
                       for c in ATTN_CASES}
    for pe in ("absolute", "relative"):
        plain = jbuild_encoder(80, JModelConfig(**enc_cfg("", pe)),
                               nnx.Rngs(0))
        out["enc_sd"][pe] = bridge.state_dict_from_jax(flat(plain))
    for n, mode, pe in ENC_CASES:
        enc = jbuild_encoder(80, JModelConfig(**enc_cfg(mode, pe)),
                             nnx.Rngs(0), mesh=sub_mesh(n))
        assert bridge.state_dict_from_jax(flat(enc)).keys() == out[
            "enc_sd"][pe].keys()
        y, _ = nnx.jit(lambda e, x, l: e(x, l))(enc, jnp.asarray(x),
                                                 jnp.asarray(lens))
        out["enc"][(n, mode, pe)] = np.asarray(y)
    out["batch"] = make_batch()
    out["solver"] = jax_solver_grads(out["batch"], 2, model__cp_mode="ring")
    return out


def _data(refs):
    t = lambda d: {k: torch.as_tensor(v) for k, v in d.items()}  # noqa: E731
    return {**{f"attn{T}": t(a) for T, a in refs["attn"].items()},
            "feats": (torch.as_tensor(refs["x"]), torch.as_tensor(
                refs["lens"])),
            "sd": {**refs["enc_sd"], "solver": refs["solver"]["sd"]},
            "batch": refs["batch"]}


def _cases(world: int) -> list:
    cases = [{"name": f"attn_{mode}_{bias}_{T}", "kind": "cp_attention",
              "mesh": (1, world), "inputs": f"attn{T}", "mode": mode,
              "bias": bias}
             for n, mode, bias, T in ATTN_CASES if n == world]
    cases += [{"name": f"enc_{mode}_{pe}", "kind": "encoder",
               "mesh": (1, world), "cfg": enc_cfg(mode, pe), "model": pe,
               "feats": "feats"} for n, mode, pe in ENC_CASES if n == world]
    if world == 2:
        cases.append({"name": "solver_ring", "kind": "grads", "mesh": (1, 2),
                      "model": "solver", "batch": "batch",
                      "cfg": {"model__cp_mode": "ring"}})
    return cases


@pytest.fixture(scope="module")
def world2(refs, tmp_path_factory):
    out = run_ranks(tmp_path_factory.mktemp("cp2"), 2, _cases(2),
                    _data(refs))
    return torch.load(out / "results_0.pt", weights_only=False)


@pytest.fixture(scope="module")
def world4(refs, tmp_path_factory):
    out = run_ranks(tmp_path_factory.mktemp("cp4"), 4, _cases(4),
                    _data(refs))
    return torch.load(out / "results_0.pt", weights_only=False)


@pytest.mark.parametrize("world,mode,bias,T", ATTN_CASES)
def test_cp_attention_matches_jax(world2, world4, refs, world, mode, bias,
                                  T):
    """Ring and Ulysses on q, k, v (and the Toeplitz diagonals) against
    the JAX `sharded_self_attention` on the same sub-mesh: the output and
    the gradients of sum(out^2); at T 62 the time axis pads to 64."""
    got = (world2 if world == 2 else world4)[f"attn_{mode}_{bias}_{T}"]
    want = refs["attn_ref"][(world, mode, bias, T)]
    np.testing.assert_allclose(got["out"].numpy(), want["out"],
                               rtol=OUT_RTOL, atol=OUT_ATOL)
    for n in ("dq", "dk", "dv") + (("ddiag",) if bias else ()):
        np.testing.assert_allclose(got[n].numpy(), want[n], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=n)


@pytest.mark.parametrize("world,mode,pe", ENC_CASES)
def test_cp_encoder_matches_jax(world2, world4, refs, world, mode, pe):
    """The Transformer encoder with `cp_mode` on a dp 1 x tp n mesh (the
    projections head-split, the attention time-split) against the JAX CP
    encoder on the same sub-mesh, absolute and relative PE."""
    got = (world2 if world == 2 else world4)[f"enc_{mode}_{pe}"]
    np.testing.assert_allclose(got["enc"].numpy(),
                               refs["enc"][(world, mode, pe)],
                               rtol=OUT_RTOL, atol=3e-5)


def test_solver_step_under_cp_matches_jax(world2, refs):
    """`Solver.grads` (the train step's loss and gradients) at dp 1 x tp 2
    with cp_mode='ring' and the relative bias, against the JAX Solver's
    loss function on two devices: the loss and every gradient, whole."""
    got, want = world2["solver_ring"], refs["solver"]
    assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    assert set(got["grads"]) == set(want["grads"])
    for name, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][name].numpy(), g.numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("mode", MODES)
def test_no_mesh_cp_encoder_matches_jax(mode):
    """Without a mesh `cp_mode` is ordinary attention on the float32
    diagonals (JAX `models/encoders.py:389`, `:429`): a 2-layer relative
    Conformer's output and every parameter's gradient of sum(y^2) in
    training, against the JAX encoder with the same `cp_mode`."""
    from pytorch_end2end_speech_recognition_tpu_torch.models import encoders
    from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
        ModelConfig,
    )

    fields = {**enc_cfg(mode, "relative"), "encoder": "conformer",
              "encoder_heads": 4, "encoder_dropout": 0.0}
    jenc = jbuild_encoder(80, JModelConfig(**fields), nnx.Rngs(0))
    enc = encoders.build_encoder(80, ModelConfig(**fields))
    enc.load_state_dict(bridge.state_dict_from_jax(flat(jenc)))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 90, 80)).astype(np.float32)
    lens = np.asarray([90, 51], np.int32)
    gd, state = nnx.split(jenc)

    def loss(state):
        y, _ = nnx.merge(gd, state)(jnp.asarray(x), jnp.asarray(lens),
                                    train=True)
        return jnp.sum(y ** 2), y

    (_, jy), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(state)
    jg = bridge.state_dict_from_jax(flat(jg))
    _, diags = encoders._rel_bias_repr(enc.rel, enc.cfg, 23)
    assert diags is not None  # cp_mode takes the diagonals at any T
    y, _ = enc(torch.from_numpy(x), torch.from_numpy(lens), train=True)
    names, params = zip(*enc.named_parameters())
    grads = torch.autograd.grad((y ** 2).sum(), params)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=OUT_RTOL, atol=3e-5)
    assert set(names) == set(jg)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), jg[name].numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
