"""Device time by the program's own spans.

The port marks its layers and phases with `record_function` ranges
(`utils/profiling.py:span`: `asr.<layer>`, `train.<phase>`,
`fit.<phase>`), which exist only while a profiler records. `attribute`
reads one traced cycle's Chrome trace events and gives each device
operation (kernel, memcpy, memset) to the span whose code launched it:

1. the operation to its launch: the `cuda_runtime` or `cuda_driver` event
   with the same `correlation`, or where the trace has none (a launch API
   the profiler does not record) the operator it was launched from, by
   `External id`;
2. the launch to the innermost program span open on the launch's own
   thread at its host time; never by overlap on the device's timeline (the
   host runs ahead of the card, so a span has usually closed before its
   kernels run);
3. a launch inside an `autograd::engine::evaluate_function` opened after
   that span (the backward) to the span of the forward operation that made
   the autograd node: the last to start of the forward operations with the
   node's `Sequence number` on the forward thread, which is the thread whose
   forward operations hold the most of the sequence numbers of that
   `Fwd thread id` (the trace numbers threads there its own way);
4. a phase: the outermost `train.*` span open, on any thread, at the
   launch's host time (the main thread waits inside `train.backward` while
   the autograd engine's thread launches);
5. what was launched outside every span: `(outside)`; an operation with
   neither a launch nor an operator in the trace: `(no launch)` (in a
   training cycle, the tail of the step before it, which ran on past the
   host's start of the cycle's first step).

A span's self time is the device time given to it and not to a span
inside it. `attribute` reads events in the Chrome trace's form; the
benchmark's `Tracer` keeps none, and a trace can be saved only once, so
`cycle_of` reads the profiler's last cycle (the one it still holds after a
schedule) from its kineto events (`events_of`), once a run. A trace
without a program span (a program without spans) reads as None.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

OUTSIDE = "(outside)"
NO_LAUNCH = "(no launch)"
PREFIXES = ("asr.", "train.", "fit.")
EVALUATE = "autograd::engine::evaluate_function"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class Cycle:
    """One traced cycle, in microseconds of device time."""

    steps: list = field(default_factory=list)   # ProfilerStep numbers
    window_us: float = 0.0
    busy_us: float = 0.0
    n_spans: int = 0
    self_us: dict = field(default_factory=dict)   # innermost span's name
    total_us: dict = field(default_factory=dict)  # a span and its children
    launches: dict = field(default_factory=dict)  # device ops by self name
    phase_us: dict = field(default_factory=dict)  # outermost train.* span
    by_seq_us: float = 0.0   # reached through the backward's sequence numbers
    idle: list = field(default_factory=list)      # (main-thread span, us)


@dataclass
class _Span:
    name: str
    tid: object
    start: float
    end: float
    parent: "_Span | None" = None


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _sweep(tid, spans, evals, points):
    """For each point (time, key) on one thread: (innermost program span,
    innermost evaluate_function event) open there, None where there is
    none. Sets each span's parent on the way."""
    marks = []
    for sp in spans:
        marks.append((sp.start, 0, -sp.end, "open", sp))
        marks.append((sp.end, 2, -sp.start, "close", sp))
    for ev in evals:
        marks.append((ev[0], 0, -ev[1], "eopen", ev))
        marks.append((ev[1], 2, -ev[0], "eclose", ev))
    for t, key in points:
        marks.append((t, 1, 0.0, "point", key))
    marks.sort(key=lambda m: m[:3])
    open_spans, open_evals, out = [], [], {}
    for _, _, _, kind, obj in marks:
        if kind == "open":
            obj.parent = open_spans[-1] if open_spans else None
            open_spans.append(obj)
        elif kind == "close":
            open_spans.remove(obj)
        elif kind == "eopen":
            open_evals.append(obj)
        elif kind == "eclose":
            open_evals.remove(obj)
        else:
            out[obj] = (open_spans[-1] if open_spans else None,
                        open_evals[-1] if open_evals else None)
    return out


def attribute(events: list) -> Cycle | None:
    """The cycle's device time by span; None without a profiler step."""
    steps, device, launch_at, op_at = [], [], {}, {}
    spans, evals, fwd_ops = {}, {}, {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        args, tid = ev.get("args") or {}, ev.get("tid")
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, (args.get("correlation"),
                                          args.get("External id"))))
            continue
        if cat in LAUNCH_CATS and "correlation" in args:
            launch_at.setdefault(args["correlation"], (tid, ts))
        elif cat in ("cpu_op", "user_annotation") and args.get("External id"):
            op_at.setdefault(args["External id"], (tid, ts))
        if cat == "user_annotation" and name.startswith(PREFIXES):
            spans.setdefault(tid, []).append(_Span(name, tid, ts, ts + dur))
        elif name.startswith("ProfilerStep#") and not cat.startswith("gpu"):
            steps.append((ts, ts + dur, int(name.split("#")[1]), tid))
        elif cat == "cpu_op" and "Sequence number" in args:
            seq = args["Sequence number"]
            if name.startswith(EVALUATE):
                evals.setdefault(tid, []).append(
                    (ts, ts + dur, seq, args.get("Fwd thread id")))
            elif not args.get("Fwd thread id"):
                fwd_ops.setdefault(tid, []).append((ts, seq))
    if not steps:
        return None
    cyc = Cycle(steps=sorted(s[2] for s in steps),
                n_spans=sum(len(v) for v in spans.values()))
    start = min(s[0] for s in steps)
    end = max([s[1] for s in steps] + [e for _, e, _ in device])
    cyc.window_us = end - start
    clipped = [(max(s, start), min(e, end), c) for s, e, c in device
               if e > start and s < end]
    busy = _union((s, e) for s, e, _ in clipped)
    cyc.busy_us = sum(e - s for s, e in busy)

    # host side: each launch's and each forward op's place among the spans
    def launch(ids):
        corr, ext = ids
        if corr in launch_at:
            return ("launch", corr), launch_at[corr]
        if ext in op_at:
            return ("op", ext), op_at[ext]
        return None, (None, None)

    points, launched = {}, {}
    for _, _, ids in clipped:
        key, (tid, ts) = launch(ids)
        if key is not None and key not in launched:
            launched[key] = ts
            points.setdefault(tid, []).append((ts, key))
    for tid, ops in fwd_ops.items():
        for ts, seq in ops:
            points.setdefault(tid, []).append((ts, ("fwd", tid, ts, seq)))
    found = {}
    for tid in set(points) | set(spans):
        found.update(_sweep(tid, spans.get(tid, []), evals.get(tid, []),
                            points.get(tid, [])))
    # sequence number -> span of the last forward op to start with it, by
    # the forward thread that best matches each Fwd thread id
    seq_span = {}
    for key, (sp, _) in found.items():
        if key[0] == "fwd":
            _, tid, ts, seq = key
            have = seq_span.setdefault(tid, {})
            if seq not in have or have[seq][0] <= ts:
                have[seq] = (ts, sp)
    fwd_thread = {}
    for tid, evs in evals.items():
        for ev in evs:
            fwd_thread.setdefault(ev[3], set()).add(ev[2])
    for fid, seqs in fwd_thread.items():
        fwd_thread[fid] = max(seq_span, default=None, key=lambda t: len(
            seqs & set(seq_span[t])))

    def owner(key):
        """(span or None, reached by sequence number)."""
        if key is None:
            return None, False
        sp, ev = found[key]
        if ev is not None and (sp is None or ev[0] > sp.start):
            hit = seq_span.get(fwd_thread.get(ev[3]), {}).get(ev[2])
            return (hit[1] if hit else None), True
        return sp, False

    tops = sorted((sp.start, sp.end, sp.name) for v in spans.values()
                  for sp in v if sp.name.startswith("train.")
                  and not _inside_train(sp))
    top_starts = [t[0] for t in tops]
    for s, e, ids in clipped:
        d = e - s
        key = launch(ids)[0]
        sp, via_seq = owner(key)
        unseen = NO_LAUNCH if key is None else OUTSIDE
        name = sp.name if sp is not None else unseen
        cyc.self_us[name] = cyc.self_us.get(name, 0.0) + d
        cyc.launches[name] = cyc.launches.get(name, 0) + 1
        if via_seq and sp is not None:
            cyc.by_seq_us += d
        chain = set()
        while sp is not None:
            chain.add(sp.name)
            sp = sp.parent
        for n in chain or (unseen,):
            cyc.total_us[n] = cyc.total_us.get(n, 0.0) + d
        t = launched.get(key)
        k = bisect.bisect_right(top_starts, t) - 1 if t is not None else -1
        phase = tops[k][2] if k >= 0 and t <= tops[k][1] else unseen
        cyc.phase_us[phase] = cyc.phase_us.get(phase, 0.0) + d

    # idle gaps, by the innermost span open on the profiled steps' thread
    main = spans.get(steps[0][3], [])
    prev = start
    for s, e in busy + [[end, end]]:
        if s > prev:
            mid = (prev + s) / 2
            inner = [sp for sp in main if sp.start <= mid <= sp.end]
            label = max(inner, key=lambda sp: sp.start).name if inner \
                else OUTSIDE
            cyc.idle.append((label, s - prev))
        prev = max(prev, e)
    return cyc


def _inside_train(sp: _Span) -> bool:
    p = sp.parent
    while p is not None:
        if p.name.startswith("train."):
            return True
        p = p.parent
    return False


def breakdown(cyc: Cycle) -> dict:
    """The ten spans with the most self time ([name, device s, device
    ops]) and the ten labels with the most idle time ([span, s])."""
    top = sorted(cyc.self_us.items(), key=lambda kv: -kv[1])[:10]
    idle = {}
    for n, d in cyc.idle:
        idle[n] = idle.get(n, 0.0) + d / 1e6
    return {"spans": [[n, d / 1e6, cyc.launches[n]] for n, d in top],
            "idle_spans": [list(kv) for kv in
                           sorted(idle.items(), key=lambda kv: -kv[1])[:10]]}


# ---------------------------------------------------------------- readers
def events_of(prof) -> list:
    """The last cycle of a `torch.profiler.profile` as Chrome trace events
    (only the categories and arguments `attribute` reads), from its kineto
    events: device operations, the runtime calls that launched them, ranges
    and operators (threads numbered as the profiler numbers them, which the
    `Fwd thread id` of a backward operator uses too). Host and device times
    are on one clock, in microseconds from the cycle's first event."""
    raw = prof.profiler.kineto_results.events()
    base = min((e.start_ns() for e in raw), default=0)
    out = []
    for e in raw:
        ts, dur = (e.start_ns() - base) / 1e3, e.duration_ns() / 1e3
        tid, ann = e.start_thread_id(), e.is_user_annotation()
        if e.device_type().name != "CPU":
            if not ann:
                out.append({"ph": "X", "cat": "kernel", "name": e.name(),
                            "ts": ts, "dur": dur, "args": {
                                "correlation": e.correlation_id(),
                                "External id": e.linked_correlation_id()}})
        elif ann:
            out.append({"ph": "X", "cat": "user_annotation",
                        "name": e.name(), "tid": tid, "ts": ts, "dur": dur,
                        "args": {"External id": e.correlation_id()}})
        elif e.linked_correlation_id() > 0:
            out.append({"ph": "X", "cat": "cuda_runtime", "name": e.name(),
                        "tid": tid, "ts": ts, "dur": dur,
                        "args": {"correlation": e.correlation_id()}})
        else:
            seq, args = e.sequence_nr(), {"External id": e.correlation_id()}
            if seq >= 0:
                args.update({"Sequence number": seq,
                             "Fwd thread id": e.fwd_thread_id()})
            out.append({"ph": "X", "cat": "cpu_op", "name": e.name(),
                        "tid": tid, "ts": ts, "dur": dur, "args": args})
    return out


_CACHE: dict = {}


def cycle_of(ctx) -> Cycle | None:
    """The attribution of the traced run's last cycle (once a run); None
    without a trace, where the window closed before any cycle, or without a
    program span in it."""
    t = ctx.tracer
    if t is None or t.prof.profiler is None:
        return None
    if _CACHE.get("tracer") is not t:
        cyc = attribute(events_of(t.prof))
        _CACHE.clear()
        _CACHE.update(tracer=t, cycle=cyc if cyc is not None
                      and cyc.n_spans else None)
    return _CACHE["cycle"]


def ms_per_step(ctx, mode: str, names, by: str = "self"):
    """Device milliseconds a traced request or step given to `names` (self
    time, or with `by='phase'` the outermost train.* span), in cells of
    `mode`; None elsewhere or without spans."""
    if ctx.mix["mode"] != mode:
        return None
    cyc = cycle_of(ctx)
    if cyc is None:
        return None
    table = cyc.phase_us if by == "phase" else cyc.self_us
    return sum(table.get(n, 0.0) for n in names) / 1e3 / len(cyc.steps)
