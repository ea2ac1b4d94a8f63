"""The traced run's reading of the device: `torch.profiler` over a few
cycles of requests or steps spread over the window, each cycle's trace
written under TMPDIR, read and deleted at once.

A cycle's span runs from the host's start of its first profiled step to
the end of its last step or of its last device operation, whichever is
later. Busy time is the union of the device's operations (kernels, copies,
fills) inside the span, so overlapping kernels count once. The idle gaps
are labelled by what the host was doing: the host operation that started
last before the gap's middle.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile

import torch
from torch.profiler import ProfilerAction, ProfilerActivity

# kernel classes, first match wins (by substring of the lower-cased name)
GROUPS = (
    ("ffn", ("ffn_",)),
    ("lstm", ("lstm_",)),
    ("flash", ("attention_fwd_kernel<2>", "attn_bwd_delta_kernel<2>",
               "attn_bwd_main_kernel<2>", "attn_bwd_dq_sum_kernel<2>",
               "ddiag_sum")),
    ("logmel", ("logmel_",)),
    ("toeplitz", ("toeplitz_",)),
    ("attention_bwd", ("attn_bwd_",)),
    ("attention", ("attention_fwd_kernel",)),
    ("ctc", ("ctc_",)),
    ("optimizer", ("foreach", "multi_tensor")),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "sm90_")),
    ("conv", ("conv", "cudnn", "implicit")),
    ("layer_norm", ("layer_norm", "layernorm", "gammabeta")),
    ("memcpy", ("memcpy",)),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)
GLUE = ("layer_norm", "memcpy", "reduce", "elementwise")


def short(name: str) -> str:
    """A kernel's name without 'void ' and its trailing argument list, with
    template arguments written as numbers (`attention_fwd_kernel<(BiasMode)1>`
    -> `attention_fwd_kernel<1>`)."""
    if name.startswith("void "):
        name = name[5:]
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                if i > 0:
                    name = name[:i]
                break
    return re.sub(r"\((?:enum )?[A-Za-z_:]+\)(-?\d)", r"\1", name)


def group(name: str) -> str:
    low = short(name).lower()
    return next((g for g, pats in GROUPS if any(p in low for p in pats)),
                "other")


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Tracer:
    """Profiles `cycles` cycles of `active` steps, each after `wait` steps
    and one warm-up step. The caller calls `before(i)` and `after(i)`
    around step i. With `sync_edges`, the device is drained before a
    cycle's first profiled step and after its last, so that a cycle holds
    its own steps' work and no other (for steps that do not wait for the
    device themselves). `profiled` lists the steps profiled, `finished`
    those of the cycles that ran to their end (a window can close inside
    its last cycle)."""

    def __init__(self, wait: int, active: int, cycles: int,
                 sync_edges: bool):
        self.sched = torch.profiler.schedule(wait=wait, warmup=1,
                                             active=active, repeat=cycles)
        self.sync_edges = sync_edges
        self.profiled: list[int] = []
        self.finished: set[int] = set()
        self.cycles: list[dict] = []
        self.prof = torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=self.sched, on_trace_ready=self._ready)
        self._action = ProfilerAction.NONE

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)

    def before(self, i: int) -> None:
        act = self.sched(self.prof.step_num)
        recording = (ProfilerAction.RECORD, ProfilerAction.RECORD_AND_SAVE)
        if act in recording:
            self.profiled.append(i)
            if self.sync_edges and self._action not in recording:
                torch.cuda.synchronize()
        self._action = act

    def after(self, i: int) -> None:
        if self._action == ProfilerAction.RECORD_AND_SAVE:
            if self.sync_edges:
                torch.cuda.synchronize()
            self.finished = set(self.profiled)
        self.prof.step()

    def _ready(self, prof) -> None:
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        kernels, device, steps, host = [], [], [], []
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat, name = ev.get("cat", ""), ev.get("name", "")
            ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
            if cat == "kernel":
                kernels.append((name, ts, dur))
                device.append((ts, ts + dur))
            elif cat in ("gpu_memcpy", "gpu_memset"):
                device.append((ts, ts + dur))
                kernels.append((name, ts, dur))
            elif name.startswith("ProfilerStep#") and not cat.startswith(
                    "gpu"):
                steps.append((ts, ts + dur))
            elif cat == "cpu_op":
                host.append((ts, name))
        if not steps:
            return
        start = min(s for s, _ in steps)
        end = max([e for _, e in steps] + [e for _, e in device])
        busy = _union((max(s, start), min(e, end)) for s, e in device
                      if e > start and s < end)
        gaps, prev = [], start
        for s, e in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = e
        if end > prev:
            gaps.append((prev, end))
        host.sort()
        starts = [t for t, _ in host]
        labelled = []
        for s, e in gaps:
            k = bisect.bisect_right(starts, (s + e) / 2) - 1
            labelled.append((host[k][1] if k >= 0 else "(none)", e - s))
        self.cycles.append({
            "span_us": end - start,
            "busy_us": sum(e - s for s, e in busy),
            "steps": len(steps),
            "kernels": [(n, d) for n, _, d in kernels],
            "n_kernels": sum(1 for ev_cat in kernels
                             if not ev_cat[0].startswith("Memcpy")
                             and not ev_cat[0].startswith("Memset")),
            "gaps": labelled,
        })

    # ---- summaries of every cycle ---------------------------------------
    @property
    def steps(self) -> int:
        return sum(c["steps"] for c in self.cycles)

    def busy_s(self) -> float:
        return sum(c["busy_us"] for c in self.cycles) / 1e6

    def window_s(self) -> float:
        return sum(c["span_us"] for c in self.cycles) / 1e6

    def kernel_seconds(self, pred) -> float:
        """Device seconds of the operations whose short name satisfies
        `pred`."""
        return sum(d for c in self.cycles for n, d in c["kernels"]
                   if pred(short(n))) / 1e6

    def group_seconds(self, groups) -> float:
        return sum(d for c in self.cycles for n, d in c["kernels"]
                   if group(n) in groups) / 1e6

    def launches(self) -> int:
        return sum(c["n_kernels"] for c in self.cycles)

    def breakdown(self) -> dict:
        ops, gaps = {}, {}
        for c in self.cycles:
            for n, d in c["kernels"]:
                k = short(n)[:120]
                ops[k] = ops.get(k, 0.0) + d / 1e6
            for n, d in c["gaps"]:
                gaps[n[:120]] = gaps.get(n[:120], 0.0) + d / 1e6
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [list(kv) for kv in top],
                "idle_gaps": [list(kv) for kv in idle]}
