"""The ranks of the port's parallelism tests (`test_torch_parallel.py`,
`test_torch_multiproc.py`, `test_torch_cp.py`, `test_torch_pp.py`),
spawned as

    python -m tests.torch_parallel_case SPEC RANK WORLD

SPEC is a JSON file: {"rdzv": file rendezvous path, "out": directory,
"data": a torch.save file of the parent's inputs, "cases": [...]}. Each rank
joins a gloo process group of WORLD ranks and runs every case in order (a
case builds the meshes it needs), and saves every case's result to
`out/results_RANK.pt`; a case that must raise on every rank records the
error. With `--cli` first, SPEC holds {"out", "runs": [{"name", "module",
"argv"}]}: each run calls that CLI's `main` in this process, with a
rendezvous file of its own passed as `--coordinator file://...` and the
rank's `--num-processes/--process-id`, its stdout and stderr kept in
`out/NAME_RANK.out` and `.err`. This module imports neither JAX nor the
tests' conftest: the parent holds the JAX references.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

PKG = "pytorch_end2end_speech_recognition_tpu_torch"

# the tiny model of the JAX package's tests/test_parallel.py (`_tiny_cfg`),
# with a transformer decoder; label smoothing 0 as that test's loss
TINY = {
    "model.encoder": "transformer", "model.encoder_layers": 2,
    "model.encoder_dim": 32, "model.encoder_ffn_dim": 64,
    "model.encoder_heads": 4, "model.vocab_size": 16,
    "model.decoder": "transformer", "model.decoder_heads": 2,
    "model.decoder_layers": 2, "model.decoder_dim": 32,
    "model.embed_dim": 16, "model.attention_dim": 16,
    "model.ctc_weight": 0.3, "model.dtype": "float32",
    "model.encoder_dropout": 0.0, "model.decoder_dropout": 0.0,
    "model.label_smoothing": 0.0, "frontend.spec_augment": False,
}
VOCAB = 16


def apply(cfg, overrides: dict):
    """Set dotted fields on an AsrConfig of either package."""
    for key, val in overrides.items():
        obj = cfg
        *path, leaf = key.split(".")
        for p in path:
            obj = getattr(obj, p)
        if not hasattr(obj, leaf):
            raise KeyError(key)
        setattr(obj, leaf, val)
    return cfg


def tiny_cfg(**extra):
    from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
        AsrConfig,
    )

    cfg = apply(AsrConfig(), TINY)
    cfg.train.metrics_path = ""
    return apply(cfg, {k.replace("__", "."): v for k, v in extra.items()})


def tokenizer_of(vocab_size: int):
    from pytorch_end2end_speech_recognition_tpu_torch.data.tokenizer import (
        N_SPECIAL,
        CharTokenizer,
    )

    return CharTokenizer(charset="".join(
        chr(0x100 + i) for i in range(vocab_size - N_SPECIAL - 1)))


def _batch(arrays: dict):
    from pytorch_end2end_speech_recognition_tpu_torch.data.dataset import Batch

    return Batch(*(np.asarray(arrays[k]) for k in
                   ("audio", "audio_lens", "tokens", "token_lens")))


def _model(cfg, sd):
    from pytorch_end2end_speech_recognition_tpu_torch.models.asr import (
        AsrModel,
    )

    model = AsrModel(cfg, device="cpu", seed=0)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected and all(k.startswith("frontend.") for k in missing)
    return model


def _solver(cfg, sd, mesh):
    from pytorch_end2end_speech_recognition_tpu_torch.training.solver import (
        Solver,
    )

    return Solver(cfg, tokenizer_of(VOCAB), model=_model(cfg, sd), mesh=mesh)


def rows_of(mesh, n: int) -> slice:
    """This rank's rows of a global batch of n: n // dp contiguous rows of
    its data rank (a rank's loader shard, when every rank holds the whole
    batch)."""
    assert n % mesh.dp == 0, (n, mesh.dp)
    k = n // mesh.dp
    return slice(mesh.data_rank * k, (mesh.data_rank + 1) * k)


def _local(mesh, batch):
    """This rank's rows of a global batch."""
    from pytorch_end2end_speech_recognition_tpu_torch.data.dataset import Batch

    rows = rows_of(mesh, len(batch.audio))
    return Batch(batch.audio[rows], batch.audio_lens[rows],
                 batch.tokens[rows], batch.token_lens[rows])


def _full_grads(solver, grads) -> dict:
    from pytorch_end2end_speech_recognition_tpu_torch.parallel.sharding import (
        full_tensor,
    )

    return {n: full_tensor(solver.mesh, g, solver.dims.get(n))
            for n, g in zip(solver.names, grads)}


def case_grads(case, data, mesh):
    """The hybrid loss and every gradient (whole) of one batch."""
    cfg = tiny_cfg(**case.get("cfg", {}))
    solver = _solver(cfg, data["sd"][case["model"]], mesh)
    metrics, grads = solver.grads(_local(mesh, _batch(data[case["batch"]])))
    return {"loss": float(metrics["loss"]),
            "grads": _full_grads(solver, grads)}


def case_encode(case, data, mesh):
    """The encoder's output (eval mode) of the batch's audio."""
    cfg = tiny_cfg(**case.get("cfg", {}))
    from pytorch_end2end_speech_recognition_tpu_torch.parallel.sharding import (
        shard_model,
    )

    model = _model(cfg, data["sd"][case["model"]]).eval()
    shard_model(model, mesh)
    b = data[case["batch"]]
    with torch.no_grad():
        enc, lens = model.encode(torch.as_tensor(np.asarray(b["audio"])),
                                 torch.as_tensor(np.asarray(b["audio_lens"])))
    return {"enc": enc, "lens": lens}


def _assemble(mesh, block: torch.Tensor) -> torch.Tensor:
    """A (B, T, D) tensor from every rank's (B/dp, T, D/tp) block."""
    import torch.distributed as dist

    from pytorch_end2end_speech_recognition_tpu_torch.parallel.collectives import (  # noqa: E501
        all_gather_host,
    )

    parts = all_gather_host(block, dist.group.WORLD)
    rows = [torch.cat(parts[i * mesh.tp:(i + 1) * mesh.tp], dim=2)
            for i in range(mesh.dp)]
    return torch.cat(rows, dim=0)


def case_attention(case, data, mesh):
    """`sharded_fused_attention` on this rank's rows and heads (and bias
    rows): the output, dq, dk, dv assembled whole, dbias summed over the
    ranks."""
    import torch.distributed as dist

    from pytorch_end2end_speech_recognition_tpu_torch.ops.attention_kernel import (  # noqa: E501
        sharded_fused_attention,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.parallel.collectives import (  # noqa: E501
        all_reduce_,
    )
    a = data["attn"]
    H = int(a["heads"])
    B, T, D = a["q"].shape
    rows = rows_of(mesh, B)
    w = D // mesh.tp
    cols = slice(mesh.model_rank * w, (mesh.model_rank + 1) * w)
    q, k, v = (a[n][rows, :, cols].clone().requires_grad_()
               for n in ("q", "k", "v"))
    bias = (a["bias"].clone().requires_grad_() if case["bias"] else None)
    hd = H // mesh.tp
    mine = (None if bias is None
            else bias[mesh.model_rank * hd:(mesh.model_rank + 1) * hd])
    out = sharded_fused_attention(mesh.tp, q, k, v, mine, a["lens"][rows], H)
    (out * a["g"][rows, :, cols]).sum().backward()
    res = {"out": _assemble(mesh, out.detach())}
    for n, t in (("dq", q), ("dk", k), ("dv", v)):
        res[n] = _assemble(mesh, t.grad)
    if bias is not None:
        res["dbias"] = all_reduce_(bias.grad.clone(), dist.group.WORLD)
    return res


def case_clip(case, data, mesh):
    """One `Solver.train_step` under global-norm clipping: the step's
    grad_norm and every parameter after it, whole."""
    cfg = tiny_cfg(**case.get("cfg", {}))
    solver = _solver(cfg, data["sd"][case["model"]], mesh)
    metrics = solver.train_step(_local(mesh, _batch(data[case["batch"]])))
    return {"grad_norm": float(metrics["grad_norm"]),
            "params": solver._params()}


def case_checkpoint(case, data, mesh_a_b):
    """Train a step under mesh (2, 1), save; restore into a Solver of
    another seed under (1, 2): every parameter and moment, whole."""
    from pytorch_end2end_speech_recognition_tpu_torch.parallel.mesh import (
        make_mesh,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.training.solver import (
        Solver,
    )

    del mesh_a_b
    out = {}
    for tag, (dp, tp), seed in (("a", case["save"], 0),
                                ("b", case["load"], 1)):
        mesh = make_mesh(dp, tp, device="cpu")
        cfg = tiny_cfg(train__seed=seed,
                       train__checkpoint_dir=case["dir"])
        solver = Solver(cfg, tokenizer_of(VOCAB), mesh=mesh)
        if tag == "a":
            solver.train_step(_local(mesh, _batch(data[case["batch"]])))
            solver.step = 7
            solver.save_checkpoint("m")
        else:
            solver.load_checkpoint("m")
        params, opt, _ = solver.full_state()
        out[tag] = {"params": params, "m1": opt["m1"], "m2": opt["m2"],
                    "step": solver.step}
    return out


def case_consistency(case, data, mesh):
    """Rank 1 shards by other rules (the decoder's embedding split too):
    Solver's consistency check must raise on every rank."""
    from pytorch_end2end_speech_recognition_tpu_torch.parallel import sharding

    rules = sharding.RULES
    if mesh.rank == 1:
        sharding.RULES = [(r".*/embed/embedding$", ("model", None))] + rules
    try:
        _solver(tiny_cfg(), data["sd"]["transformer"], mesh)
    except RuntimeError as e:
        return {"raised": str(e)}
    finally:
        sharding.RULES = rules
    return {"raised": None}


def fit_cfg(corpus_dir: str, **extra):
    """A tiny conformer for `Solver.fit` on the digits corpus: one length
    bucket (every batch one shape), 4 rows a rank, dropout and SpecAugment
    off, so that ranks and one process take the same steps."""
    cfg = tiny_cfg(model__encoder="conformer", model__encoder_layers=1,
                   model__decoder_layers=1, model__label_smoothing=0.1,
                   data__train_manifest=f"{corpus_dir}/train.jsonl",
                   data__dev_manifest=f"{corpus_dir}/dev.jsonl",
                   data__batch_size=4, data__n_length_buckets=1,
                   train__lr=1e-3, train__schedule="constant",
                   train__log_every=1, train__eval_every=10**9)
    return apply(cfg, {k.replace("__", "."): v for k, v in extra.items()})


def loaders(cfg, shard: int = 0, n: int = 1):
    from pytorch_end2end_speech_recognition_tpu_torch.data.dataset import (
        BucketedLoader,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.data.manifest import (
        read_manifest,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.data.tokenizer import (
        CharTokenizer,
    )

    utts = read_manifest(cfg.data.train_manifest)
    tok = CharTokenizer([u.text for u in utts])
    train = BucketedLoader(utts, tok, cfg.data, shard_index=shard,
                           num_shards=n)
    dev = BucketedLoader(read_manifest(cfg.data.dev_manifest), tok, cfg.data,
                         train=False, shard_index=shard, num_shards=n)
    return tok, train, dev


def case_fit(case, data, mesh):
    """`Solver.fit` over the data rank's loader shard, then the dev WER."""
    from pytorch_end2end_speech_recognition_tpu_torch.training.solver import (
        Solver,
    )

    cfg = fit_cfg(case["corpus"])
    tok, train, dev = loaders(cfg, mesh.data_rank, mesh.dp)
    solver = Solver(cfg, tok, mesh=mesh)
    hist = solver.fit(train, steps=case["steps"])
    return {"losses": hist["loss"], "wer": solver.evaluate(dev),
            "params": solver._params()}


def case_cp_attention(case, data, mesh):
    """`sharded_self_attention` over the 'model' group on inputs alike on
    every rank: the output and the gradients of sum(out^2) with respect
    to q, k, v (and the diagonals)."""
    from pytorch_end2end_speech_recognition_tpu_torch.parallel.cp import (
        sharded_self_attention,
    )

    a = data[case["inputs"]]
    q, k, v = (a[n].clone().requires_grad_() for n in ("q", "k", "v"))
    diag = a["diag"].clone().requires_grad_() if case["bias"] else None
    out = sharded_self_attention(mesh.model_group, q, k, v, a["lens"],
                                 case["mode"], diag)
    (out ** 2).sum().backward()
    res = {"out": out.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}
    if diag is not None:
        res["ddiag"] = diag.grad
    return res


def _encoder(case, data, mesh):
    """An encoder of `case['cfg']` (ModelConfig fields) with the weights
    `data['sd'][case['model']]`, sharded over the mesh."""
    from pytorch_end2end_speech_recognition_tpu_torch.models.encoders import (
        build_encoder,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.parallel.sharding import (
        shard_model,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
        ModelConfig,
    )

    enc = build_encoder(80, ModelConfig(**case["cfg"]))
    enc.load_state_dict(data["sd"][case["model"]])
    shard_model(enc, mesh)
    return enc


def case_encoder(case, data, mesh):
    """The encoder's output on the case's features; with `grads`, also
    every parameter's gradient of sum(y^2) in training (the pipelined
    blocks' summed over the 'model' group, as the Solver sums them)."""
    from pytorch_end2end_speech_recognition_tpu_torch.parallel.pp import (
        sum_stage_grads,
    )

    enc = _encoder(case, data, mesh)
    x, lens = data[case["feats"]]
    if not case.get("grads"):
        with torch.no_grad():
            y, out_lens = enc(x, lens)
        return {"enc": y, "lens": out_lens}
    y, out_lens = enc(x, lens, train=True)
    names, params = zip(*enc.named_parameters())
    grads = torch.autograd.grad((y ** 2).sum(), params, allow_unused=True)
    grads = sum_stage_grads(grads, params,
                            [n.startswith("blocks.") for n in names],
                            mesh.model_group)
    return {"enc": y.detach(), "lens": out_lens,
            "grads": {n: g for n, g in zip(names, grads)}}


def case_raises(case, data, mesh):
    """The encoder's forward must raise ValueError on this rank: its
    message, or None."""
    enc = _encoder(case, data, mesh)
    x, lens = data[case["feats"]]
    try:
        enc(x, lens)
    except ValueError as e:
        return {"raised": str(e)}
    return {"raised": None}


def case_pipeline_apply(case, data, mesh):
    """`pipeline_apply` of tanh(h W_s) over the 'model' group: the output
    and the gradient of sum(out^2) with respect to the stacked W, summed
    over the group (each stage holds its own W's)."""
    from pytorch_end2end_speech_recognition_tpu_torch.parallel.collectives import (  # noqa: E501
        all_reduce_,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.parallel.pp import (
        pipeline_apply,
    )

    Ws = data["pipe"]["Ws"].clone().requires_grad_()
    out = pipeline_apply(mesh.model_group, lambda W, h: torch.tanh(h @ W),
                         Ws, data["pipe"]["x"], n_micro=4)
    (out ** 2).sum().backward()
    return {"out": out.detach(),
            "dW": all_reduce_(Ws.grad.clone(), mesh.model_group)}


def case_pipeline_blocks(case, data, mesh):
    """`pipeline_blocks` of TransformerBlocks with the JAX blocks' weights
    (and dense relative biases) over the 'model' group: the output."""
    from pytorch_end2end_speech_recognition_tpu_torch.models.encoders import (
        TransformerBlock,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.parallel.pp import (
        pipeline_blocks,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
        ModelConfig,
    )

    d = data[case["inputs"]]
    cfg = ModelConfig(**case["cfg"])
    blocks = []
    for sd in d["sds"]:
        blk = TransformerBlock(cfg)
        blk.load_state_dict(sd)
        blocks.append(blk)
    with torch.no_grad():
        out = pipeline_blocks(mesh.model_group, blocks, d["x"], d["mask"],
                              n_micro=4, biases=d.get("biases"))
    return {"out": out}


CASES = {"fit": case_fit, "grads": case_grads, "encode": case_encode,
         "attention": case_attention, "clip": case_clip,
         "checkpoint": case_checkpoint, "consistency": case_consistency,
         "cp_attention": case_cp_attention, "encoder": case_encoder,
         "raises": case_raises, "pipeline_apply": case_pipeline_apply,
         "pipeline_blocks": case_pipeline_blocks}


def main(spec_path: str, rank: int, world: int) -> int:
    torch.set_num_threads(1)
    from pytorch_end2end_speech_recognition_tpu_torch.parallel.mesh import (
        initialize_multihost,
        make_mesh,
    )

    spec = json.loads(Path(spec_path).read_text())
    initialize_multihost(f"file://{spec['rdzv']}",
                         num_processes=world, process_id=rank,
                         backend="gloo", timeout_s=spec.get("timeout", 60))
    data = torch.load(spec["data"], weights_only=False)
    results = {}
    for case in spec["cases"]:
        dp, tp = case.get("mesh", (world, 1))
        mesh = make_mesh(dp, tp, device="cpu")
        results[case["name"]] = CASES[case["kind"]](case, data, mesh)
        print(f"rank {rank}: {case['name']} done", flush=True)
    torch.save(results, Path(spec["out"]) / f"results_{rank}.pt")
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def cli_main(spec_path: str, rank: int, world: int) -> int:
    torch.set_num_threads(1)
    spec = json.loads(Path(spec_path).read_text())
    out = Path(spec["out"])
    for i, run in enumerate(spec["runs"]):
        mod = importlib.import_module(f"{PKG}.cli.{run['module']}")
        argv = run["argv"] + [
            "--coordinator", f"file://{out / f'rdzv_{i}'}",
            "--num-processes", str(world), "--process-id", str(rank)]
        name = f"{run['name']}_{rank}"
        with open(out / f"{name}.out", "w") as fo, \
                open(out / f"{name}.err", "w") as fe, \
                contextlib.redirect_stdout(fo), contextlib.redirect_stderr(fe):
            mod.main(argv)
        print(f"rank {rank}: {run['name']} done", flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1] == "--cli":
        sys.exit(cli_main(sys.argv[2], int(sys.argv[3]), int(sys.argv[4])))
    sys.exit(main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3])))
