"""Tracing and profiling helpers (the port of the JAX package's
`utils/profiling.py`):

- `trace()`: a Chrome trace of the enclosed block by `torch.profiler`;
- `StepTimer`: wall-clock step times that wait for the device, with
  percentile stats;
- `throughput_gauge`: audio-seconds per second (per card), the headline
  metric;
- `roofline`: achieved against peak FLOP/s and bytes/s for a measured
  kernel.

The peaks are the card's published ones (`utils/device.py:H100_PEAKS`:
dense bf16 tensor-core FLOP/s and HBM bytes/s), and the JAX package's
`cpu` entry for the CPU; a card without an entry raises.
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

from pytorch_end2end_speech_recognition_tpu_torch.utils.device import (
    H100_PEAKS,
)

# device kind (a substring of its name) -> (bf16 TFLOP/s, memory GB/s)
PEAKS = {
    "h100": (H100_PEAKS["bf16_flops"] / 1e12,
             H100_PEAKS["hbm_bytes_per_s"] / 1e9),
    "cpu": (0.5, 50.0),
}


def device_peaks(device=None) -> tuple[float, float]:
    """(bf16 TFLOP/s, memory GB/s) of `device` (None: the current card)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return PEAKS["cpu"]
    name = torch.cuda.get_device_name(dev)
    for kind, peaks in PEAKS.items():
        if kind in name.lower():
            return peaks
    raise ValueError(f"no published peaks for {name!r}: add them to "
                     "utils/profiling.py:PEAKS")


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


def throughput_gauge(audio_seconds: float, wall_seconds: float,
                     n_chips: int = 1) -> dict:
    v = audio_seconds / max(wall_seconds, 1e-9)
    return {
        "audio_s_per_s": v,
        "audio_s_per_s_per_chip": v / max(n_chips, 1),
        "rtf_inv": v,  # >1 means faster than real time
    }


def roofline(flops: float, bytes_moved: float, wall_s: float,
             device=None) -> dict:
    """Achieved fraction of peak compute and bandwidth for a measured
    kernel on `device` (None: the current card)."""
    peak_tflops, peak_gbs = device_peaks(device)
    achieved_tflops = flops / wall_s / 1e12
    achieved_gbs = bytes_moved / wall_s / 1e9
    return {
        "achieved_tflops": achieved_tflops,
        "peak_tflops": peak_tflops,
        "compute_frac": achieved_tflops / peak_tflops,
        "achieved_gbs": achieved_gbs,
        "peak_gbs": peak_gbs,
        "bandwidth_frac": achieved_gbs / peak_gbs,
        "bound": "compute" if achieved_tflops / peak_tflops
                 > achieved_gbs / peak_gbs else "memory",
    }
