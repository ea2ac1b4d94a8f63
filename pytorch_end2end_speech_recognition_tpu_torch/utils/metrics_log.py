"""Metrics logging: JSONL file + console, optional tensorboard (the port's
copy of the JAX package's `utils/metrics_log.py`). JSONL is the source of
truth (one row per event, machine-parsable).
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path


class MetricsLogger:
    def __init__(self, path: str | None = None, echo: bool = True,
                 tensorboard_dir: str | None = None):
        self.path = Path(path) if path else None
        self.echo = echo
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._f = open(self.path, "a")
        else:
            self._f = None
        self._tb = None
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(tensorboard_dir)
            except Exception as e:  # noqa: BLE001
                print(f"[metrics] tensorboard unavailable: {e}",
                      file=sys.stderr)

    def log(self, tag: str, metrics: dict) -> None:
        row = {"tag": tag, "time": time.time(), **metrics}
        if self._f:
            self._f.write(json.dumps(row) + "\n")
            self._f.flush()
        if self._tb is not None:
            step = int(metrics.get("step", 0))
            for k, v in metrics.items():
                if isinstance(v, (int, float)) and k != "step":
                    self._tb.add_scalar(f"{tag}/{k}", v, step)
        if self.echo:
            parts = " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in metrics.items()
            )
            print(f"[{tag}] {parts}", file=sys.stderr)

    def log_image(self, tag: str, array, step: int = 0) -> None:
        """Log a 2-D array (e.g. attention heatmap) to tensorboard."""
        if self._tb is None:
            return
        import numpy as np

        a = np.asarray(array, dtype=np.float32)
        a = (a - a.min()) / (a.max() - a.min() + 1e-9)
        self._tb.add_image(tag, a[None], step)

    def close(self):
        if self._f:
            self._f.close()
        if self._tb is not None:
            self._tb.close()
