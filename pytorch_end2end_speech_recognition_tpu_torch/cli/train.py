"""Training entry point (the port of the JAX package's `cli/train.py`).

    python -m pytorch_end2end_speech_recognition_tpu_torch.cli.train \
        --config flagship_conformer --set data.train_manifest=train.jsonl \
        --set data.dev_manifest=dev.jsonl [--set train.lr=1e-3 ...] \
        [--resume] [--device cpu]

Trains on CUDA unless `--device cpu` is given (and raises without a card).
The tokenizer comes from `data.tokenizer_path`, else from the copy saved
beside the checkpoints by an earlier run of the experiment, else it is
built from the train manifest (and that copy is written, by rank 0 alone,
as a temporary file renamed into place). `--resume` continues from
`<checkpoint_dir>/last` (or the newest step checkpoint); the `last`
checkpoint is written however a single process's training ends.

Several processes (data and tensor parallelism over `torch.distributed`,
`parallel/`): run the same command once a rank, under `torchrun` with
`--distributed` (`env://`), or with `--coordinator host:port
--num-processes N --process-id R` (or ASR_COORDINATOR_ADDRESS,
ASR_NUM_PROCESSES, ASR_PROCESS_ID):

    torchrun --nproc-per-node 8 -m ..._torch.cli.train --distributed \
        --config libri960_multihost ...

The mesh is train.dp x train.tp; where that is not the world size, dp
becomes world // tp (a line on stderr says so), as in the JAX CLI. Each
rank reads its data rank's shard of the train and dev manifests, rank r
trains on cuda:LOCAL_RANK (`--device cuda:0` puts every rank on one card),
and rank 0 writes the metrics and checkpoints. `--dist-backend` picks the
process group's backend ('cpu:gloo,cuda:nccl' with a card, 'gloo' on the
CPU). A rank that raises tears the group down, so that the others fail
too instead of waiting on it; no `last` checkpoint is written then.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True,
                    help="config JSON path or preset name")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="dotted config override, e.g. train.lr=1e-3")
    ap.add_argument("--resume", action="store_true",
                    help="resume from <checkpoint_dir>/last")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    add_distributed_args(ap)
    return ap


def add_distributed_args(ap: argparse.ArgumentParser) -> None:
    """The multi-process flags of cli.train, cli.decode and cli.export."""
    ap.add_argument("--distributed", action="store_true",
                    help="join a process group from the environment "
                         "(env://, as torchrun sets it)")
    ap.add_argument("--coordinator",
                    default=os.environ.get("ASR_COORDINATOR_ADDRESS"),
                    help="host:port of process 0 (tcp:// rendezvous), or a "
                         "rendezvous URL such as file:///shared/path")
    ap.add_argument("--num-processes", type=int,
                    default=int(os.environ.get("ASR_NUM_PROCESSES", 0)) or None,
                    help="processes in the job")
    ap.add_argument("--process-id", type=int,
                    default=int(os.environ["ASR_PROCESS_ID"])
                    if os.environ.get("ASR_PROCESS_ID") else None,
                    help="this process's rank")
    ap.add_argument("--dist-backend", default=None,
                    help="the process group's backend (default "
                         "'cpu:gloo,cuda:nccl' with a card, else 'gloo')")


def init_distributed(args, cfg, device, tag: str = "train",
                     rows_only: bool = False):
    """Join the process group that the flags name (none: a single
    process) and build the mesh: train.dp x train.tp, or dp = world // tp
    where that differs from the world size (the JAX CLI's default, said on
    stderr); with `rows_only`, dp = world and tp = 1 (a decode, whose ranks
    each hold the whole model). Returns the mesh, or None for one process
    with dp * tp = 1. A process group that the caller has joined already
    is used as it is."""
    import torch.distributed as dist

    from pytorch_end2end_speech_recognition_tpu_torch.parallel.mesh import (
        initialize_multihost,
        make_mesh,
        world,
    )

    if dist.is_initialized():
        pass
    elif args.distributed or args.coordinator:
        initialize_multihost(args.coordinator, args.num_processes,
                             args.process_id, backend=args.dist_backend)
    elif args.num_processes not in (None, 1) or args.process_id is not None:
        raise SystemExit("--num-processes/--process-id need --coordinator "
                         "or --distributed")
    n = world()[1]
    dp, tp = (n, 1) if rows_only else (cfg.train.dp, cfg.train.tp)
    if n == 1 and dp * tp == 1:
        return None
    if dp * tp != n:
        dp = n // tp
        print(f"[{tag}] mesh defaulted to dp={dp} tp={tp} over {n} "
              "processes", file=sys.stderr)
    return make_mesh(dp, tp, device=device)


def end_distributed(args) -> None:
    """Leave the process group that `init_distributed` joined for these
    flags (so that a later call in the process may join another)."""
    from pytorch_end2end_speech_recognition_tpu_torch.parallel.mesh import (
        abort,
    )

    if args.distributed or args.coordinator:
        abort()


def load_config(spec: str):
    from pytorch_end2end_speech_recognition_tpu_torch.configs import presets
    from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
        AsrConfig,
    )

    if Path(spec).exists():
        return AsrConfig.from_json(Path(spec).read_text())
    if spec in presets.PRESETS:
        return presets.PRESETS[spec]()
    raise SystemExit(f"config '{spec}' is neither a file nor a preset "
                     f"(presets: {sorted(presets.PRESETS)})")


def resolve_tokenizer(cfg, train_utts, write: bool = True):
    """data.tokenizer_path, else the copy beside the checkpoints (so that
    --resume never swaps the vocabulary), else built from the train
    manifest; the copy beside the checkpoints is written when missing (with
    `write`: by one rank only)."""
    from pytorch_end2end_speech_recognition_tpu_torch.data.tokenizer import (
        Tokenizer,
        build_tokenizer,
    )

    ckpt_dir = Path(cfg.train.checkpoint_dir)
    ckpt_tok = ckpt_dir / "tokenizer.json"
    if cfg.data.tokenizer_path and Path(cfg.data.tokenizer_path).exists():
        tok = Tokenizer.load(cfg.data.tokenizer_path)
    elif ckpt_tok.exists():
        tok = Tokenizer.load(ckpt_tok)
    else:
        tok = build_tokenizer(cfg.data.tokenizer,
                              [u.text for u in train_utts],
                              vocab_size=cfg.data.bpe_vocab_size)
        if cfg.data.tokenizer_path and write:
            tok.save(cfg.data.tokenizer_path)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    if write and not ckpt_tok.exists():
        tmp_tok = ckpt_tok.with_name("tokenizer.json.tmp")
        tok.save(tmp_tok)
        tmp_tok.replace(ckpt_tok)
    return tok


def main(argv=None):
    args = build_argparser().parse_args(argv)
    from pytorch_end2end_speech_recognition_tpu_torch.data.dataset import (
        BucketedLoader,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.data.manifest import (
        read_manifest,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.parallel.mesh import (
        abort,
        host_shard_info,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.training.checkpoint import (  # noqa: E501
        latest_step_checkpoint,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.training.solver import (
        Solver,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
        parse_overrides,
    )

    cfg = parse_overrides(load_config(args.config), args.set)
    mesh = init_distributed(args, cfg, args.device)
    shard, n_shards = host_shard_info(mesh)
    train_utts = read_manifest(cfg.data.train_manifest)
    tok = resolve_tokenizer(cfg, train_utts,
                            write=mesh is None or mesh.rank == 0)
    sr = cfg.frontend.sample_rate
    loader = BucketedLoader(train_utts, tok, cfg.data, sample_rate=sr,
                            shard_index=shard, num_shards=n_shards)
    dev_loader = None
    if cfg.data.dev_manifest:
        dev_loader = BucketedLoader(read_manifest(cfg.data.dev_manifest), tok,
                                    cfg.data, sample_rate=sr, train=False,
                                    shard_index=shard, num_shards=n_shards)
    solver = Solver(cfg, tok, device=args.device, mesh=mesh)
    if args.resume:
        tag = "last"
        if not Path(cfg.train.checkpoint_dir, "last").exists():
            tag = latest_step_checkpoint(cfg.train.checkpoint_dir)
        if tag:
            print(f"resuming from {tag}", file=sys.stderr)
            solver.load_checkpoint(tag)
        else:
            print("no checkpoint found; starting fresh", file=sys.stderr)
    if mesh is None:
        try:
            solver.fit(loader, dev_loader, steps=args.steps)
        finally:
            solver.save_checkpoint("last")
            solver.logger.close()
    else:
        try:
            solver.fit(loader, dev_loader, steps=args.steps)
            solver.save_checkpoint("last")
        except BaseException:
            abort()
            raise
        finally:
            solver.logger.close()
    end_distributed(args)
    print(f"done at step {solver.step}; best dev WER {solver.best_wer:.4f}",
          file=sys.stderr)
    return solver


if __name__ == "__main__":
    main()
