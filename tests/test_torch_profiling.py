"""The port's `utils/profiling.py` against the JAX package's on the CPU:
the peaks, `throughput_gauge`, `roofline` and `StepTimer.stats` give the
JAX functions' numbers, `StepTimer.tick` takes a result to wait for, and
`trace` writes a Chrome trace that names the profiled operators."""

import json

import numpy as np
import pytest
import torch

from pytorch_end2end_speech_recognition_tpu.utils import profiling as jprof
from pytorch_end2end_speech_recognition_tpu_torch.utils import device as dv
from pytorch_end2end_speech_recognition_tpu_torch.utils import (
    profiling as tprof,
)


def test_peaks_cpu_as_jax_and_h100_from_the_device_table(monkeypatch):
    assert tprof.device_peaks("cpu") == jprof.device_peaks()
    assert tprof.PEAKS["h100"] == (dv.H100_PEAKS["bf16_flops"] / 1e12,
                                   dv.H100_PEAKS["hbm_bytes_per_s"] / 1e9)
    assert tprof.PEAKS["h100"] == (989.0, 3350.0)
    assert not any("tpu" in k for k in tprof.PEAKS)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert tprof.device_peaks("cuda") == (989.0, 3350.0)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError, match="A100"):
        tprof.device_peaks("cuda")


@pytest.mark.parametrize("audio_s,wall_s,chips", [
    (960.0, 1.5, 1), (30.0, 0.0, 4), (1e4, 2.25, 0)])
def test_throughput_gauge_matches_jax(audio_s, wall_s, chips):
    assert tprof.throughput_gauge(audio_s, wall_s, chips) == (
        jprof.throughput_gauge(audio_s, wall_s, chips))


@pytest.mark.parametrize("flops,nbytes,wall_s", [
    (2.5e9, 1e6, 0.01), (1e6, 4e9, 0.2)])
def test_roofline_matches_jax(flops, nbytes, wall_s):
    got = tprof.roofline(flops, nbytes, wall_s, device="cpu")
    assert got == jprof.roofline(flops, nbytes, wall_s)
    assert got["bound"] == ("compute" if flops > 1e8 else "memory")


def test_step_timer_stats_match_jax():
    times = [0.5, 0.013, 0.011, 0.012, 0.02, 0.0105, 0.3]
    t, j = tprof.StepTimer(), jprof.StepTimer()
    t.times, j.times = list(times), list(times)
    for skip in (0, 2, 10):
        assert t.stats(skip) == j.stats(skip)
    t.start()
    x = torch.ones(4)
    assert t.tick({"loss": x, "rest": [x, (x,)]}) >= 0.0
    assert t.tick() >= 0.0 and len(t.times) == len(times) + 2


def test_trace_writes_a_chrome_trace(tmp_path):
    a = torch.randn(64, 64)
    with tprof.trace(str(tmp_path)) as prof:
        (a @ a).sum()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
    assert any("aten::mm" in k.key for k in prof.key_averages())
    assert np.isfinite(float((a @ a).sum()))
