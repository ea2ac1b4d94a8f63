"""Checkpoint averaging: write an `avg` checkpoint from N snapshots (the
port of the JAX package's `cli/average_ckpts.py`, on the port's
checkpoints). The floating parameters of several step checkpoints are
averaged in float32; integer ones, the optimizer state and the meta come
from the newest, so `--resume` off an averaged tag still works.

    python -m pytorch_end2end_speech_recognition_tpu_torch.cli.average_ckpts \
        --ckpt-dir exp/ckpt --last-n 3 --out-tag avg
"""

from __future__ import annotations

import argparse
import shutil
import sys
from pathlib import Path

import torch

from pytorch_end2end_speech_recognition_tpu_torch.training.checkpoint import (
    STATE_FILE,
)


def _avg_leaves(leaves: list[torch.Tensor]) -> torch.Tensor:
    first = leaves[0]
    if not first.is_floating_point():
        return first  # counters/int leaves: keep the newest-listed
    acc = torch.zeros(first.shape, dtype=torch.float32)
    for x in leaves:
        acc += x.float()
    return (acc / len(leaves)).to(first.dtype)


def average_checkpoints(ckpt_dir: str, tags: list[str],
                        out_tag: str = "avg") -> Path:
    """Average `params` across tags (newest first); save under out_tag."""
    if len(tags) < 1:
        raise ValueError("need at least one checkpoint tag to average")
    if out_tag in ("last", "best") or out_tag.startswith("step_"):
        raise ValueError(
            f"--out-tag {out_tag!r} collides with a source checkpoint tag "
            "(last/best/step_*); averaging would remove a real checkpoint. "
            "Pick a distinct name like 'avg'.")
    base = Path(ckpt_dir)
    trees = [torch.load(base / t / STATE_FILE, map_location="cpu",
                        weights_only=True) for t in tags]
    params = [t["params"] for t in trees]
    if any(set(p) != set(params[0]) for p in params):
        raise ValueError(f"checkpoints {tags} hold different parameters")
    out = dict(trees[0])  # newest: opt_state + meta (step, rng, cursor...)
    out["params"] = {k: _avg_leaves([p[k] for p in params])
                     for k in params[0]}
    out_path = base / out_tag
    if out_path.exists():
        shutil.rmtree(out_path)
    out_path.mkdir(parents=True)
    torch.save(out, out_path / STATE_FILE)
    # carry config provenance from the newest source tag if present
    src_cfg = base / f"{tags[0]}.config.json"
    if src_cfg.exists():
        shutil.copyfile(src_cfg, base / f"{out_tag}.config.json")
    return out_path


def pick_last_n(ckpt_dir: str, n: int) -> list[str]:
    steps = sorted(p.name for p in Path(ckpt_dir).glob("step_*")
                   if p.is_dir())
    if not steps:
        raise FileNotFoundError(
            f"no step_* checkpoints under {ckpt_dir}; train with "
            "train.eval_every set, or pass --tags explicitly")
    if len(steps) < n:
        print(f"[average_ckpts] WARNING: only {len(steps)} step_* "
              f"checkpoints under {ckpt_dir}, averaging fewer than the "
              f"requested {n}", file=sys.stderr)
    return list(reversed(steps[-n:]))  # newest first


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--out-tag", default="avg")
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--tags", nargs="+",
                   help="explicit tags, newest first (meta comes from the "
                        "first)")
    g.add_argument("--last-n", type=int,
                   help="average the newest N step_* checkpoints")
    args = ap.parse_args(argv)
    tags = args.tags or pick_last_n(args.ckpt_dir, args.last_n)
    path = average_checkpoints(args.ckpt_dir, tags, args.out_tag)
    print(f"averaged {len(tags)} checkpoints ({', '.join(tags)}) "
          f"-> {path}", file=sys.stderr)


if __name__ == "__main__":
    main()
