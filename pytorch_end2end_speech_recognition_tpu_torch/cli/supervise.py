"""Failure-detection supervisor: run training under watch, restart on
crash or hang from the latest checkpoint (the port of the JAX package's
`cli/supervise.py`).

    python -m pytorch_end2end_speech_recognition_tpu_torch.cli.supervise \
        --config cfg.json --hang-timeout 1800 --max-restarts 5 [train args...]

The child is the port's `cli.train` with the remaining arguments
(`--device`, `--steps`, `--set` ...). Liveness = the metrics JSONL
advancing; a stalled file past --hang-timeout kills the process group and
restarts with --resume.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from pathlib import Path


def metrics_path_of(config: str, overrides: list[str]) -> Path:
    from pytorch_end2end_speech_recognition_tpu_torch.cli.train import (
        load_config,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
        parse_overrides,
    )

    cfg = parse_overrides(load_config(config), overrides)
    return Path(cfg.train.metrics_path)


def run_supervised(argv: list[str], metrics: Path, hang_timeout: float,
                   max_restarts: int, poll_s: float = 10.0,
                   launcher: list[str] | None = None) -> int:
    """Supervision loop. `launcher` defaults to the train CLI; tests inject
    a stand-in child so the kill/restart paths run in seconds."""
    restarts = 0
    resume = False
    if launcher is None:
        launcher = [sys.executable, "-m",
                    "pytorch_end2end_speech_recognition_tpu_torch.cli.train"]
    while True:
        cmd = list(launcher) + argv
        if resume and "--resume" not in cmd:
            cmd.append("--resume")
        print(f"[supervise] launching (restart {restarts}): {' '.join(cmd)}",
              file=sys.stderr)
        proc = subprocess.Popen(cmd, start_new_session=True)
        last_mtime = metrics.stat().st_mtime if metrics.exists() else 0.0
        last_progress = time.time()
        while True:
            rc = proc.poll()
            if rc is not None:
                break
            time.sleep(poll_s)
            mtime = metrics.stat().st_mtime if metrics.exists() else 0.0
            if mtime > last_mtime:
                last_mtime = mtime
                last_progress = time.time()
            elif time.time() - last_progress > hang_timeout:
                print(f"[supervise] hang: no metrics progress in "
                      f"{hang_timeout}s, killing process group",
                      file=sys.stderr)
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
                rc = -9
                break
        if rc == 0:
            print("[supervise] training finished cleanly", file=sys.stderr)
            return 0
        restarts += 1
        resume = True
        if restarts > max_restarts:
            print(f"[supervise] giving up after {restarts - 1} restarts",
                  file=sys.stderr)
            return 1
        print(f"[supervise] exit code {rc}; restarting from latest "
              "checkpoint", file=sys.stderr)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--hang-timeout", type=float, default=1800.0)
    ap.add_argument("--max-restarts", type=int, default=5)
    ap.add_argument("--config", required=True)
    ap.add_argument("--set", action="append", default=[], metavar="K=V")
    args, passthrough = ap.parse_known_args(argv)
    train_args = ["--config", args.config]
    for s in args.set:
        train_args += ["--set", s]
    train_args += passthrough
    metrics = metrics_path_of(args.config, args.set)
    sys.exit(run_supervised(train_args, metrics, args.hang_timeout,
                            args.max_restarts))


if __name__ == "__main__":
    main()
