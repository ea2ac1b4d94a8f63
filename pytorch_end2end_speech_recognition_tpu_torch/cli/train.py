"""Training entry point (the port of the JAX package's `cli/train.py`).

    python -m pytorch_end2end_speech_recognition_tpu_torch.cli.train \
        --config flagship_conformer --set data.train_manifest=train.jsonl \
        --set data.dev_manifest=dev.jsonl [--set train.lr=1e-3 ...] \
        [--resume] [--device cpu]

Trains on CUDA unless `--device cpu` is given (and raises without a card).
The tokenizer comes from `data.tokenizer_path`, else from the copy saved
beside the checkpoints by an earlier run of the experiment, else it is
built from the train manifest (and that copy is written). `--resume`
continues from `<checkpoint_dir>/last` (or the newest step checkpoint);
the `last` checkpoint is written however training ends. Data and tensor
parallelism (`train.dp * train.tp > 1`) and the multi-host flags raise
NotImplementedError: they come with the parallelism slice.
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
    ap.add_argument("--distributed", action="store_true",
                    help="multi-host training (not ported yet)")
    ap.add_argument("--coordinator",
                    default=os.environ.get("ASR_COORDINATOR_ADDRESS"),
                    help="host:port of process 0 (not ported yet)")
    ap.add_argument("--num-processes", type=int,
                    default=int(os.environ.get("ASR_NUM_PROCESSES", 0)) or None,
                    help="processes in the job (not ported yet)")
    ap.add_argument("--process-id", type=int,
                    default=int(os.environ["ASR_PROCESS_ID"])
                    if os.environ.get("ASR_PROCESS_ID") else None,
                    help="this process's rank (not ported yet)")
    return ap


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


def resolve_tokenizer(cfg, train_utts):
    """data.tokenizer_path, else the copy beside the checkpoints (so that
    --resume never swaps the vocabulary), else built from the train
    manifest; the copy beside the checkpoints is written when missing."""
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
        if cfg.data.tokenizer_path:
            tok.save(cfg.data.tokenizer_path)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    if not ckpt_tok.exists():
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
    if (args.distributed or args.coordinator or (args.num_processes or 1) > 1
            or args.process_id is not None
            or cfg.train.dp * cfg.train.tp > 1):
        raise NotImplementedError(
            "multi-host and data/tensor-parallel training (train.dp * "
            "train.tp > 1) come with the parallelism slice")
    train_utts = read_manifest(cfg.data.train_manifest)
    tok = resolve_tokenizer(cfg, train_utts)
    sr = cfg.frontend.sample_rate
    loader = BucketedLoader(train_utts, tok, cfg.data, sample_rate=sr)
    dev_loader = None
    if cfg.data.dev_manifest:
        dev_loader = BucketedLoader(read_manifest(cfg.data.dev_manifest), tok,
                                    cfg.data, sample_rate=sr, train=False)
    solver = Solver(cfg, tok, device=args.device)
    if args.resume:
        tag = "last"
        if not Path(cfg.train.checkpoint_dir, "last").exists():
            tag = latest_step_checkpoint(cfg.train.checkpoint_dir)
        if tag:
            print(f"resuming from {tag}", file=sys.stderr)
            solver.load_checkpoint(tag)
        else:
            print("no checkpoint found; starting fresh", file=sys.stderr)
    try:
        solver.fit(loader, dev_loader, steps=args.steps)
    finally:
        solver.save_checkpoint("last")
        solver.logger.close()
    print(f"done at step {solver.step}; best dev WER {solver.best_wer:.4f}",
          file=sys.stderr)
    return solver


if __name__ == "__main__":
    main()
