"""The port's pipeline parallelism (`..._torch/parallel/pp.py` and the
encoder's and the Solver's `pp_stages` paths) against the JAX package on
the CPU, with the tolerances of tests/test_pp.py (outputs rtol 2e-4, atol
2e-5; the linear pipeline 1e-5 / 1e-6, its gradients 1e-4 / 1e-5; the
encoder's gradients 3e-3 / 3e-4).

The JAX side runs in this process on a sub-mesh of the port's world
(`make_mesh(1, n, devices=jax.devices()[:n])`: the JAX tests' 'model' axis
of 4, without their 'data' axis); the port's ranks are gloo processes
(`tests/torch_parallel_case.py`), one launch of two ranks and one of four.
Without a mesh the port's `pp_stages` 2 encoder is held to the JAX
encoder in process."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from pytorch_end2end_speech_recognition_tpu.models.encoders import (
    RelPosBias as JRelPosBias,
)
from pytorch_end2end_speech_recognition_tpu.models.encoders import (
    TransformerBlock as JTransformerBlock,
)
from pytorch_end2end_speech_recognition_tpu.models.encoders import (
    build_encoder as jbuild_encoder,
)
from pytorch_end2end_speech_recognition_tpu.parallel.pp import (
    pipeline_apply as jpipeline_apply,
)
from pytorch_end2end_speech_recognition_tpu.parallel.pp import (
    pipeline_blocks as jpipeline_blocks,
)
from pytorch_end2end_speech_recognition_tpu.utils.config import (
    ModelConfig as JModelConfig,
)
from pytorch_end2end_speech_recognition_tpu_torch import bridge
from tests.test_torch_cp import jax_solver_grads, sub_mesh
from tests.test_torch_parallel import make_batch, run_ranks
from tests.torch_train_case import flat

OUT_RTOL, OUT_ATOL = 2e-4, 2e-5
ENC_GRAD_RTOL, ENC_GRAD_ATOL = 3e-3, 3e-4
LOSS_RTOL = 1e-4
# (world, layers, stages, relative) of tests/test_pp.py's block pipelines
# at world 4, and one at world 2
BLOCK_CASES = [(4, 4, 4, False), (4, 8, 4, False), (4, 4, 4, True),
               (2, 4, 2, True)]
BLOCK_CFG = {"encoder_dim": 32, "encoder_ffn_dim": 64, "encoder_heads": 4,
             "dtype": "float32", "encoder_dropout": 0.0}


def enc_cfg(pp: int, layers: int = 4, encoder: str = "conformer") -> dict:
    """tests/test_pp.py's pipelined encoder: a relative Conformer, d32."""
    return {"encoder": encoder, "encoder_layers": layers, "encoder_dim": 32,
            "encoder_ffn_dim": 64, "encoder_heads": 4, "dtype": "float32",
            "pos_encoding": "relative", "encoder_dropout": 0.0,
            "pp_stages": pp, "pp_microbatches": 4}


def jax_pipeline_apply(n: int) -> dict:
    """tests/test_pp.py's 4-stage tanh(h W) pipeline: values and the
    gradient of sum(out^2) with respect to the stacked W."""
    rng = np.random.default_rng(0)
    S, D, B = n, 16, 8
    Ws = (rng.standard_normal((S, D, D)) * 0.3).astype(np.float32)
    x = rng.standard_normal((B, D)).astype(np.float32)
    mesh = sub_mesh(n)

    def fn(W, h):
        return jnp.tanh(h @ W)

    def run(W):
        return jpipeline_apply(mesh, "model", fn, W, jnp.asarray(x),
                               n_micro=4)

    out = jax.jit(run)(jnp.asarray(Ws))
    dW = jax.jit(jax.grad(lambda W: jnp.sum(run(W) ** 2)))(jnp.asarray(Ws))
    return {"Ws": Ws, "x": x, "out": np.asarray(out), "dW": np.asarray(dW)}


def jax_pipeline_blocks(n: int, layers: int, stages: int,
                        relative: bool) -> dict:
    cfg = JModelConfig(**BLOCK_CFG,
                       pos_encoding="relative" if relative else "absolute")
    rngs = nnx.Rngs(0)
    blocks = [JTransformerBlock(cfg, rngs, relative=relative)
              for _ in range(layers)]
    rng = np.random.default_rng(0)
    B, T = 8, 24
    x = rng.standard_normal((B, T, 32)).astype(np.float32)
    mask = (np.arange(T)[None, :]
            < np.asarray([24, 20, 24, 10, 24, 24, 5, 24])[:, None])
    biases = (JRelPosBias(layers, cfg.encoder_heads, rngs)(T) if relative
              else None)
    mesh = sub_mesh(n)
    assert mesh.shape["model"] == stages
    out = jpipeline_blocks(mesh, "model", blocks, jnp.asarray(x),
                           jnp.asarray(mask), n_micro=4, biases=biases)
    d = {"sds": [bridge.state_dict_from_jax(flat(b)) for b in blocks],
         "x": torch.from_numpy(x), "mask": torch.from_numpy(mask),
         "out": np.asarray(out)}
    if relative:
        d["biases"] = torch.from_numpy(np.array(biases)[:, 0])
    return d


def jax_encoder(fields: dict, x, lens, mesh=None) -> dict:
    """The JAX encoder's weights, output and the gradients of sum(y^2) in
    training (jitted, as tests/test_pp.py runs the pipelined one)."""
    enc = jbuild_encoder(80, JModelConfig(**fields), nnx.Rngs(0), mesh=mesh)
    gd, state = nnx.split(enc)

    def loss(state):
        y, _ = nnx.merge(gd, state)(jnp.asarray(x), jnp.asarray(lens),
                                    train=True)
        return jnp.sum(y ** 2), y

    (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(state)
    return {"sd": bridge.state_dict_from_jax(flat(enc)), "enc": np.asarray(y),
            "grads": bridge.state_dict_from_jax(flat(g))}


@pytest.fixture(scope="module")
def refs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 180, 80)).astype(np.float32)
    lens = np.asarray([180, 100, 180, 60, 180, 180, 30, 180], np.int32)
    out = {"x": x, "lens": lens, "pipe": jax_pipeline_apply(4),
           "blocks": {c: jax_pipeline_blocks(*c) for c in BLOCK_CASES},
           "enc": jax_encoder(enc_cfg(4), x, lens, mesh=sub_mesh(4))}
    out["batch"] = make_batch()
    out["solver"] = jax_solver_grads(out["batch"], 2, model__pp_stages=2)
    return out


def _data(refs):
    return {"pipe": {k: torch.from_numpy(refs["pipe"][k])
                     for k in ("Ws", "x")},
            **{f"blocks_{'_'.join(map(str, c))}": refs["blocks"][c]
               for c in BLOCK_CASES},
            "feats": (torch.from_numpy(refs["x"]),
                      torch.from_numpy(refs["lens"])),
            "sd": {"enc": refs["enc"]["sd"], "solver": refs["solver"]["sd"]},
            "batch": refs["batch"]}


def _cases(world: int) -> list:
    cases = [{"name": f"blocks_{'_'.join(map(str, c))}",
              "kind": "pipeline_blocks", "mesh": (1, world),
              "inputs": f"blocks_{'_'.join(map(str, c))}",
              "cfg": {**BLOCK_CFG, "pos_encoding":
                      "relative" if c[3] else "absolute"}}
             for c in BLOCK_CASES if c[0] == world]
    if world == 4:
        cases += [
            {"name": "pipe", "kind": "pipeline_apply", "mesh": (1, 4)},
            {"name": "enc", "kind": "encoder", "mesh": (1, 4),
             "cfg": enc_cfg(4), "model": "enc", "feats": "feats",
             "grads": True},
            # pp_stages 2 on a 'model' axis of 4
            {"name": "mismatch", "kind": "raises", "mesh": (1, 4),
             "cfg": enc_cfg(2), "model": "enc", "feats": "feats"}]
    else:
        cases.append({"name": "solver_pp", "kind": "grads", "mesh": (1, 2),
                      "model": "solver", "batch": "batch",
                      "cfg": {"model__pp_stages": 2}})
    return cases


@pytest.fixture(scope="module")
def world2(refs, tmp_path_factory):
    out = run_ranks(tmp_path_factory.mktemp("pp2"), 2, _cases(2),
                    _data(refs))
    return torch.load(out / "results_0.pt", weights_only=False)


@pytest.fixture(scope="module")
def world4(refs, tmp_path_factory):
    out = run_ranks(tmp_path_factory.mktemp("pp4"), 4, _cases(4),
                    _data(refs))
    return [torch.load(out / f"results_{r}.pt", weights_only=False)
            for r in range(4)]


def test_pipeline_apply_matches_jax(world4, refs):
    """The 4-stage tanh(h W) pipeline: values, and the gradient with
    respect to the stacked W (each stage's row from its rank, summed):
    the sequential chain's, not 4 times it, as the JAX pipeline's."""
    got, want = world4[0]["pipe"], refs["pipe"]
    np.testing.assert_allclose(got["out"].numpy(), want["out"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got["dW"].numpy(), want["dW"], rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("world,layers,stages,relative", BLOCK_CASES)
def test_pipeline_blocks_matches_jax(world2, world4, refs, world, layers,
                                     stages, relative):
    key = f"blocks_{world}_{layers}_{stages}_{relative}"
    got = (world2 if world == 2 else world4[0])[key]["out"]
    np.testing.assert_allclose(
        got.numpy(), refs["blocks"][(world, layers, stages, relative)]["out"],
        rtol=OUT_RTOL, atol=OUT_ATOL)


def test_encoder_pp_from_config_matches_jax(world4, refs):
    """A relative Conformer with pp_stages 4 on a dp 1 x tp 4 mesh against
    the JAX pipelined encoder on the same sub-mesh: the output and every
    parameter's gradient in training, on every rank (the stages' block
    gradients summed over 'model')."""
    want = refs["enc"]
    for res in world4:
        got = res["enc"]
        np.testing.assert_allclose(got["enc"].numpy(), want["enc"],
                                   rtol=OUT_RTOL, atol=OUT_ATOL)
        assert set(got["grads"]) == set(want["grads"])
        for name, g in want["grads"].items():
            np.testing.assert_allclose(got["grads"][name].numpy(), g.numpy(),
                                       rtol=ENC_GRAD_RTOL,
                                       atol=ENC_GRAD_ATOL, err_msg=name)


def test_encoder_pp_stage_mismatch_raises(world4):
    """pp_stages 2 on a 'model' axis of 4 raises ValueError on every rank,
    as the JAX encoder does (tests/test_pp.py)."""
    from pytorch_end2end_speech_recognition_tpu.parallel.mesh import (
        make_mesh as jmake_mesh,
    )

    jenc = jbuild_encoder(80, JModelConfig(**{**enc_cfg(2),
                                             "encoder": "transformer"}),
                          nnx.Rngs(0), mesh=jmake_mesh(dp=2, tp=4))
    with pytest.raises(ValueError, match="pp_stages"):
        jenc(jnp.zeros((4, 40, 80), jnp.float32), jnp.asarray([40] * 4))
    for res in world4:
        msg = res["mismatch"]["raised"]
        assert msg and "pp_stages=2" in msg and "size 4" in msg


def test_solver_step_under_pp_matches_jax(world2, refs):
    """`Solver.grads` (the train step's loss and gradients) at dp 1 x tp 2
    with pp_stages 2 (every parameter replicated, the two blocks one a
    stage) against the JAX Solver's loss function on two devices."""
    got, want = world2["solver_pp"], refs["solver"]
    assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    assert set(got["grads"]) == set(want["grads"])
    for name, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][name].numpy(), g.numpy(),
                                   rtol=ENC_GRAD_RTOL, atol=ENC_GRAD_ATOL,
                                   err_msg=name)


def test_no_mesh_pp_encoder_matches_jax():
    """Without a mesh pp_stages 2 is the plain block loop (JAX
    `models/encoders.py:340`) and turns the fused FFN off (`:507`): a
    2-layer relative Conformer's output and gradients in training against
    the JAX encoder with the same config."""
    from pytorch_end2end_speech_recognition_tpu_torch.models.encoders import (
        build_encoder,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
        ModelConfig,
    )

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 90, 80)).astype(np.float32)
    lens = np.asarray([90, 51], np.int32)
    fields = enc_cfg(2, layers=2)
    want = jax_encoder(fields, x, lens)
    enc = build_encoder(80, ModelConfig(**{**fields, "ffn_impl": "cuda"}))
    assert not any(getattr(m, "fused", False) for m in enc.modules())
    enc.load_state_dict(want["sd"])
    y, _ = enc(torch.from_numpy(x), torch.from_numpy(lens), train=True)
    names, params = zip(*enc.named_parameters())
    grads = torch.autograd.grad((y ** 2).sum(), params)
    np.testing.assert_allclose(y.detach().numpy(), want["enc"],
                               rtol=OUT_RTOL, atol=OUT_ATOL)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want["grads"][name].numpy(),
                                   rtol=ENC_GRAD_RTOL, atol=ENC_GRAD_ATOL,
                                   err_msg=name)


def test_pipelined_model_is_replicated_and_decodes_off_the_mesh():
    """Under pp_stages > 1 `shard_model` splits nothing (the JAX Solver's
    `tp_rules=False`): every spec is (), no module gets a 'model' group,
    the encoder keeps the mesh for its pipeline; `gather_model` (the beam
    decoder's, which splits a batch by rows over the ranks) hands back an
    off-mesh copy with the same weights, whose encoder runs the plain
    loop."""
    from pytorch_end2end_speech_recognition_tpu_torch.models.asr import (
        AsrModel,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.parallel.mesh import (
        Mesh,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.parallel.sharding import (
        gather_model,
        shard_model,
    )
    from tests.torch_parallel_case import tiny_cfg

    model = AsrModel(tiny_cfg(model__pp_stages=2), device="cpu")
    mesh = Mesh(1, 2, 0, torch.device("cpu"))
    assert shard_model(model, mesh) == {}
    assert model.param_specs and all(s == () for _, s in model.param_specs)
    assert all(getattr(m, "tp_group", None) is None for m in model.modules())
    assert model.encoder.mesh is mesh
    whole = gather_model(model)
    assert whole is not model and whole.encoder.mesh is None
    for (n, p), (m, q) in zip(model.named_parameters(),
                              whole.named_parameters()):
        assert n == m and torch.equal(p, q)
