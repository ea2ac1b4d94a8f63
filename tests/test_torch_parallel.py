"""The port's data and tensor parallelism (`..._torch/parallel/`) against the
JAX package on the CPU, with the tolerances of the JAX package's
tests/test_parallel.py (loss rtol 1e-4; gradients rtol 1e-2, atol 5e-4;
attention and encoder outputs 2e-4).

The JAX side runs in this process (its meshes on the host devices that
conftest.py makes); the port's ranks are separate processes over gloo
(`tests/torch_parallel_case.py`), two or four of them, which run every case
of one world in one launch. A rank that fails or a rendezvous that times
out fails the test."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from pytorch_end2end_speech_recognition_tpu.models.asr import (
    AsrModel as JAsrModel,
)
from pytorch_end2end_speech_recognition_tpu.parallel.mesh import (
    make_mesh as jmake_mesh,
)
from pytorch_end2end_speech_recognition_tpu.training.losses import (
    hybrid_loss as jhybrid_loss,
)
from pytorch_end2end_speech_recognition_tpu.utils.config import (
    AsrConfig as JAsrConfig,
)
from pytorch_end2end_speech_recognition_tpu_torch import bridge
from tests.torch_parallel_case import TINY, apply
from tests.torch_train_case import flat

REPO = Path(__file__).resolve().parents[1]
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL, OUT_TOL = 1e-4, 1e-2, 5e-4, 2e-4
B, TS = 8, 5120   # 30 frames -> T' 8: a multiple of tp, so SP engages
RANK_TIMEOUT = 240


def run_ranks(tmp: Path, world: int, cases: list, data: dict,
              cli: bool = False) -> Path:
    """Run the cases (with `cli`, the CLI runs) on `world` port ranks; the
    directory of their results. Every rank gets RANK_TIMEOUT seconds; on a
    failure or a timeout all are killed and the test fails with their
    output."""
    tmp.mkdir(parents=True, exist_ok=True)
    spec = {"rdzv": str(tmp / "rdzv"), "out": str(tmp), "cases": cases,
            "runs": cases, "data": str(tmp / "data.pt")}
    if not cli:
        torch.save(data, tmp / "data.pt")
    (tmp / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_parallel_case",
         *(["--cli"] if cli else []), str(tmp / "spec.json"), str(r),
         str(world)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT)[0].decode())
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        outs = [p.communicate()[0].decode() for p in procs]
        pytest.fail("port ranks timed out:\n" + "\n".join(outs))
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not failed, f"ranks {failed} failed:\n" + "\n".join(
        f"--- rank {r}:\n{out}" for r, out in enumerate(outs))
    return tmp


def jax_cfg(**extra):
    cfg = apply(JAsrConfig(), TINY)
    return apply(cfg, {k.replace("__", "."): v for k, v in extra.items()})


def make_batch(pad_rows=()):
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((B, TS)) * 0.1).astype(np.float32)
    audio_lens = np.full(B, TS, np.int32)
    tokens = rng.integers(3, 15, (B, 4)).astype(np.int32)
    token_lens = np.full(B, 4, np.int32)
    for r in pad_rows:
        audio[r], audio_lens[r], tokens[r], token_lens[r] = 0.0, 0, 0, 0
    return {"audio": audio, "audio_lens": audio_lens, "tokens": tokens,
            "token_lens": token_lens}


def jax_reference(encoder: str, batch: dict):
    """The JAX model's weights (bridged), and its single-device hybrid loss
    and gradients (bridged) on `batch`, as test_parallel.py's loss_fn."""
    cfg = jax_cfg(model__encoder=encoder)
    model = JAsrModel(cfg, nnx.Rngs(0))
    graphdef, params, rest = nnx.split(model, nnx.Param, ...)
    audio, audio_lens, tokens, token_lens = (
        jnp.asarray(batch[k]) for k in ("audio", "audio_lens", "tokens",
                                        "token_lens"))

    def loss_fn(params):
        m = nnx.merge(graphdef, params, rest)
        enc, enc_lens = m.encode(audio, audio_lens, train=False)
        att = m.decoder(enc, enc_lens, tokens, token_lens, train=False)
        return jhybrid_loss(m.ctc_logits(enc), enc_lens, att, tokens,
                            token_lens, cfg.model.ctc_weight)[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)

    @jax.jit
    def encode(params):
        return nnx.merge(graphdef, params, rest).encode(audio, audio_lens,
                                                        train=False)

    enc, _ = encode(params)
    return {"sd": bridge.state_dict_from_jax(flat(params)),
            "loss": float(loss),
            "grads": bridge.state_dict_from_jax(flat(grads)),
            "enc": np.asarray(enc)}


def attn_inputs():
    rng = np.random.default_rng(1)
    Bq, T, H, Dh = 8, 40, 4, 8
    D = H * Dh
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    lens = np.asarray([40, 23, 7, 40, 12, 40, 3, 31], np.int32)
    g = f(Bq, T, D) * (np.arange(T)[None, :, None] < lens[:, None, None])
    return {"q": f(Bq, T, D), "k": f(Bq, T, D), "v": f(Bq, T, D),
            "bias": f(H, T, T) * 0.3, "lens": lens, "g": g, "heads": H}


def jax_attention(a: dict, dp: int, tp: int, with_bias: bool) -> dict:
    from pytorch_end2end_speech_recognition_tpu.ops.attention_pallas import (
        sharded_fused_attention as jsharded,
    )

    mesh = jmake_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])
    q, k, v, bias, lens, g = (jnp.asarray(a[n]) for n in
                              ("q", "k", "v", "bias", "lens", "g"))
    bias = bias if with_bias else None
    H = a["heads"]

    def loss(q, k, v, b):
        return jnp.sum(jsharded(mesh, q, k, v, b, lens, H) * g)

    argnums = (0, 1, 2, 3) if with_bias else (0, 1, 2)
    with mesh:
        out = jax.jit(lambda q, k, v: jsharded(mesh, q, k, v, bias, lens,
                                               H))(q, k, v)
        grads = jax.jit(jax.grad(loss, argnums=argnums))(q, k, v, bias)
    names = ("dq", "dk", "dv", "dbias")
    return {"out": np.asarray(out),
            **{n: np.asarray(x) for n, x in zip(names, grads)}}


ATTN_CASES = [(2, 1, True), (1, 2, True), (1, 2, False)]
SP_DROPOUT = {"model__encoder": "conformer", "model__sp": True,
              "model__encoder_dropout": 0.1}
ATTN_CASES_4 = [(2, 2, True)]


@pytest.fixture(scope="module")
def refs():
    batch, pad = make_batch(), make_batch(pad_rows=(5, 6, 7))
    out = {"batch": batch, "pad": pad,
           "transformer": jax_reference("transformer", batch),
           "conformer": jax_reference("conformer", batch),
           "transformer_pad": jax_reference("transformer", pad),
           "attn": attn_inputs()}
    out["attn_ref"] = {c: jax_attention(out["attn"], *c)
                       for c in ATTN_CASES + ATTN_CASES_4}
    return out


def _data(refs):
    return {"sd": {k: refs[k]["sd"] for k in ("transformer", "conformer")},
            "batch": refs["batch"], "pad": refs["pad"],
            "attn": {k: torch.as_tensor(v) if isinstance(v, np.ndarray)
                     else v for k, v in refs["attn"].items()}}


@pytest.fixture(scope="module")
def world2(refs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world2")
    cases = [
        {"name": "grads_2_1", "kind": "grads", "mesh": (2, 1),
         "model": "transformer", "batch": "batch"},
        {"name": "grads_1_2", "kind": "grads", "mesh": (1, 2),
         "model": "transformer", "batch": "batch"},
        {"name": "pad_2_1", "kind": "grads", "mesh": (2, 1),
         "model": "transformer", "batch": "pad"},
        {"name": "sp_grads_conformer", "kind": "grads", "mesh": (1, 2),
         "model": "conformer", "batch": "batch",
         "cfg": {"model__encoder": "conformer", "model__sp": True}},
        {"name": "sp_dropout_conformer", "kind": "grads", "mesh": (1, 2),
         "model": "conformer", "batch": "batch", "cfg": SP_DROPOUT},
        {"name": "grads_conformer_1_2", "kind": "grads", "mesh": (1, 2),
         "model": "conformer", "batch": "batch",
         "cfg": {"model__encoder": "conformer"}},
        *({"name": f"sp_encode_{e}", "kind": "encode", "mesh": (1, 2),
           "model": e, "batch": "batch",
           "cfg": {"model__encoder": e, "model__sp": True}}
          for e in ("transformer", "conformer")),
        *({"name": f"attn_{dp}_{tp}_{b}", "kind": "attention",
           "mesh": (dp, tp), "bias": b} for dp, tp, b in ATTN_CASES),
        {"name": "clip", "kind": "clip", "mesh": (1, 2),
         "model": "transformer", "batch": "batch",
         "cfg": {"train__grad_clip": 1e-3, "train__optimizer": "adadelta",
                 "train__lr": 1.0}},
        {"name": "checkpoint", "kind": "checkpoint", "save": (2, 1),
         "load": (1, 2), "batch": "batch",
         "dir": str(tmp / "ckpt")},
        {"name": "consistency", "kind": "consistency", "mesh": (1, 2)},
    ]
    out = run_ranks(tmp, 2, cases, _data(refs))
    return tuple(torch.load(out / f"results_{r}.pt", weights_only=False)
                 for r in range(2))


@pytest.fixture(scope="module")
def world4(refs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world4")
    cases = [
        {"name": "grads_2_2", "kind": "grads", "mesh": (2, 2),
         "model": "transformer", "batch": "batch"},
        *({"name": f"attn_{dp}_{tp}_{b}", "kind": "attention",
           "mesh": (dp, tp), "bias": b} for dp, tp, b in ATTN_CASES_4),
    ]
    return torch.load(run_ranks(tmp, 4, cases, _data(refs))
                      / "results_0.pt", weights_only=False)


def _hold_grads(got: dict, want: dict):
    assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"]), (
        got["loss"], want["loss"])
    assert set(got["grads"]) == set(want["grads"])
    for name, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][name].numpy(), g.numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


# ------------------------------------------------------------ in process
@pytest.mark.parametrize("encoder", ["blstm", "transformer", "conformer"])
def test_param_specs_match_jax(encoder):
    """The port's (path, spec) table is the JAX package's for the same
    model, except the LSTM weights, which the port keeps whole."""
    from pytorch_end2end_speech_recognition_tpu.parallel.sharding import (
        param_specs as jparam_specs,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.models.asr import (
        AsrModel,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.parallel.mesh import (
        Mesh,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.parallel.sharding import (
        jax_specs,
        param_specs,
    )
    from tests.torch_parallel_case import tiny_cfg

    jmodel = JAsrModel(jax_cfg(model__encoder=encoder), nnx.Rngs(0))
    _, jparams, _ = nnx.split(jmodel, nnx.Param, ...)
    want = {p: tuple(s) for p, s in jparam_specs(jmake_mesh(4, 2), jparams)}
    model = AsrModel(tiny_cfg(model__encoder=encoder), device="cpu")
    mesh = Mesh(4, 2, 0, torch.device("cpu"))
    assert dict(jax_specs(mesh, model)) == want
    got = dict(param_specs(mesh, model))
    lstm = {p for p in want if p.endswith(("w_ih", "w_hh"))}
    assert bool(lstm) == (encoder == "blstm")
    for p in lstm:
        assert want[p] == (None, "model") and got[p] == ()
    assert {p: s for p, s in got.items() if p not in lstm} == {
        p: s for p, s in want.items() if p not in lstm}
    if encoder == "conformer":
        assert got["encoder/blocks/0/conv/pw1/kernel"] == (None, "model")


def test_ffn_gate_matches_jax():
    """The fused FFN's gate over (mesh, sp, pp_stages, impl) is the JAX
    package's (`models/encoders.py:503-507`): no fused FFN on a mesh with
    an axis > 1."""
    from pytorch_end2end_speech_recognition_tpu.models.encoders import (
        FfnBlock as JFfn,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.models.encoders import (
        ffn_fused,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.parallel.mesh import (
        Mesh,
    )
    from tests.torch_parallel_case import tiny_cfg

    cpu = torch.device("cpu")
    rows = 0
    for shape in (None, (1, 1), (2, 1), (1, 2), (2, 2)):
        jmesh = (None if shape is None else jmake_mesh(
            *shape, devices=jax.devices()[:shape[0] * shape[1]]))
        mesh = None if shape is None else Mesh(*shape, 0, cpu)
        for sp in (False, True):
            for pp in (1, 2):
                for fused in (False, True):
                    for D, Fd in ((256, 1024), (512, 2048)):
                        over = {"model__sp": sp, "model__pp_stages": pp,
                                "model__encoder_dim": D,
                                "model__encoder_ffn_dim": Fd}
                        jc = jax_cfg(model__ffn_impl="pallas" if fused
                                     else "xla", **over)
                        tc = tiny_cfg(model__ffn_impl="cuda" if fused
                                      else "torch", **over)
                        want = JFfn(jc.model, nnx.Rngs(0),
                                    mesh=jmesh).use_pallas
                        assert ffn_fused(tc.model, mesh) == want, (
                            shape, sp, pp, fused, D)
                        rows += want
    assert rows == 2  # D 256 off any sharded mesh, no sp, no pp: 2 meshes


# ------------------------------------------------------ two and four ranks
@pytest.mark.parametrize("dp,tp", [(2, 1), (1, 2)])
def test_loss_and_grads_match_jax(world2, refs, dp, tp):
    _hold_grads(world2[0][f"grads_{dp}_{tp}"], refs["transformer"])


def test_loss_and_grads_match_jax_2x2(world4, refs):
    _hold_grads(world4["grads_2_2"], refs["transformer"])


def test_conformer_tp_loss_and_grads_match_jax(world2, refs):
    """The conformer at tp 2: pw1 in GLU halves, the depthwise conv and the
    channel LayerNorm on split channels."""
    _hold_grads(world2[0]["grads_conformer_1_2"], refs["conformer"])


def test_pad_rows_all_on_one_rank(world2, refs):
    """Rows 5-7 are pad rows, all on data rank 1: the loss divides by the
    global count of valid rows and the gradients are summed."""
    got, want = world2[0]["pad_2_1"], refs["transformer_pad"]
    _hold_grads(got, want)
    assert abs(want["loss"] - refs["transformer"]["loss"]) > 1e-3


def test_sp_loss_and_grads_match_jax(world2, refs):
    """Sequence parallelism at dp 1 x tp 2 (the conformer, T' 8): the
    layer norms and row-parallel biases that see time slices get their
    gradients summed over 'model'."""
    _hold_grads(world2[0]["sp_grads_conformer"], refs["conformer"])


def test_sp_dropout_matches_unsharded_port(world2, refs):
    """Training dropout under sequence parallelism at tp 2: each rank draws
    the whole (B, T, D) mask of a residual site and keeps its time slice,
    so the loss and gradients are the unsharded port's with the same
    generator (a mask drawn per slice would repeat every T/tp frames)."""
    from pytorch_end2end_speech_recognition_tpu_torch.data.dataset import (
        Batch,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.training.solver import (
        Solver,
    )
    from tests.torch_parallel_case import VOCAB, tiny_cfg, tokenizer_of

    cfg = tiny_cfg(**SP_DROPOUT)
    solver = Solver(cfg, tokenizer_of(VOCAB), device="cpu")
    solver.model.load_state_dict(refs["conformer"]["sd"], strict=False)
    b = refs["batch"]
    metrics, grads = solver.grads(Batch(b["audio"], b["audio_lens"],
                                        b["tokens"], b["token_lens"]))
    want = {"loss": float(metrics["loss"]),
            "grads": {n: g.detach() for n, g in zip(solver.names, grads)}}
    _hold_grads(world2[0]["sp_dropout_conformer"], want)
    assert abs(want["loss"] - refs["conformer"]["loss"]) > 1e-3


@pytest.mark.parametrize("encoder", ["transformer", "conformer"])
def test_sp_encoder_matches_unsharded(world2, refs, encoder):
    got = world2[0][f"sp_encode_{encoder}"]["enc"].numpy()
    np.testing.assert_allclose(got, refs[encoder]["enc"], rtol=OUT_TOL,
                               atol=OUT_TOL)


@pytest.mark.parametrize("dp,tp,with_bias", ATTN_CASES + ATTN_CASES_4)
def test_sharded_fused_attention_matches_jax(world2, world4, refs, dp, tp,
                                             with_bias):
    got = (world4 if dp * tp == 4 else world2[0])[
        f"attn_{dp}_{tp}_{with_bias}"]
    want = refs["attn_ref"][(dp, tp, with_bias)]
    lens = refs["attn"]["lens"]
    valid = np.arange(40)[None, :, None] < lens[:, None, None]
    np.testing.assert_allclose(np.where(valid, got["out"].numpy(), 0.0),
                               np.where(valid, want["out"], 0.0),
                               rtol=OUT_TOL, atol=OUT_TOL)
    for n in ("dq", "dk", "dv") + (("dbias",) if with_bias else ()):
        np.testing.assert_allclose(got[n].numpy(), want[n], rtol=OUT_TOL,
                                   atol=OUT_TOL, err_msg=n)


def test_global_norm_clip_under_tp(world2, refs):
    """One clipped adadelta step at tp 2: the grad norm counts every
    sharded square once and every replicated one once (JAX's norm of the
    reference gradients), and the parameters move as one process's
    Solver moves them."""
    from pytorch_end2end_speech_recognition_tpu_torch.data.dataset import (
        Batch,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.training.solver import (
        Solver,
    )
    from tests.torch_parallel_case import VOCAB, tiny_cfg, tokenizer_of

    got = world2[0]["clip"]
    ref_norm = float(np.sqrt(sum(float((g.double() ** 2).sum())
                                 for g in refs["transformer"]["grads"]
                                 .values())))
    assert abs(got["grad_norm"] - ref_norm) <= 1e-4 * ref_norm
    cfg = tiny_cfg(train__grad_clip=1e-3, train__optimizer="adadelta",
                   train__lr=1.0)
    solver = Solver(cfg, tokenizer_of(VOCAB), device="cpu")
    solver.model.load_state_dict(refs["transformer"]["sd"], strict=False)
    b = refs["batch"]
    solver.train_step(Batch(b["audio"], b["audio_lens"], b["tokens"],
                            b["token_lens"]))
    moved = 0
    for name, p in solver._params().items():
        p = p.detach()
        np.testing.assert_allclose(got["params"][name].numpy(), p.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
        moved += bool((p != refs["transformer"]["sd"][name]).any())
    assert moved > len(got["params"]) // 2


def test_checkpoint_restore_across_mesh_shapes(world2):
    """Saved under (2, 1), restored under (1, 2) by a Solver of another
    seed: every parameter and Adam moment bit for bit, and the step."""
    ck = world2[0]["checkpoint"]
    a, b = ck["a"], ck["b"]
    assert b["step"] == 7
    assert set(a["params"]) == set(b["params"])
    for name in a["params"]:
        assert torch.equal(a["params"][name], b["params"][name]), name
    for key in ("m1", "m2"):
        assert len(a[key]) == len(b[key])
        assert all(torch.equal(x, y) for x, y in zip(a[key], b[key]))
    assert any(bool(x.abs().sum() > 0) for x in a["m1"])


def test_collective_consistency_raises_on_every_rank(world2):
    """Rank 1 shards by other rules: the Solver's check raises on both
    ranks instead of a collective hanging."""
    for res in world2:
        msg = res["consistency"]["raised"]
        assert msg and "fingerprints differ" in msg
