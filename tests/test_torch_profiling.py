"""The port's `utils/profiling.py` against the JAX package's on the CPU:
`StepTimer.stats` gives the JAX function's numbers, `StepTimer.tick` takes
a result to wait for, and `trace` writes a Chrome trace that names the
profiled operators (`span` is tested in `test_torch_spans.py`)."""

import json

import numpy as np
import torch

from pytorch_end2end_speech_recognition_tpu.utils import profiling as jprof
from pytorch_end2end_speech_recognition_tpu_torch.utils import (
    profiling as tprof,
)


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
