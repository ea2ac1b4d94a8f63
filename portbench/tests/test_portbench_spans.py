"""`portbench/spans.py`: device operations given to the program's spans by
their launches, on hand-made event lists (correlation to launch to the
innermost span, the backward on a second thread by sequence number, the
phase by the main thread's time, self time, `(outside)`, idle labels),
the readers on a hand-made serve cycle (their sum is the busy time) and on
a trace without spans (all None), the FFN count and roofline (nothing of
a cycle the window cut), the Tracer's finished cycles on a real CPU
profile, and one real CPU profile of the small model with a device
operation made for each of its operators."""

from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import harness, spans, traffic
from portbench.tests import small

MAIN, ENGINE, STREAM = 1, 2, 7
SERVE_READERS = ("frontend_ms.serve", "subsample_ms.serve", "mhsa_ms.serve",
                 "ffn_ms.serve", "conv_module_ms.serve",
                 "block_self_ms.serve", "head_ms.serve",
                 "unspanned_ms.serve")
TRAIN_READERS = ("put_ms.train", "forward_ms.train", "backward_ms.train",
                 "optimizer_ms.train", "subsample_ms.train", "mhsa_ms.train",
                 "ffn_ms.train", "conv_module_ms.train", "decoder_ms.train")


class Events:
    """A Chrome trace built by hand: host ranges, launches and the device
    operations they launch."""

    def __init__(self):
        self.ev, self.corr = [], 0

    def host(self, cat, name, tid, ts, dur, **args):
        self.ev.append({"ph": "X", "cat": cat, "name": name, "tid": tid,
                        "pid": 0, "ts": ts, "dur": dur, "args": args})

    def span(self, name, ts, dur, tid=MAIN):
        self.host("user_annotation", name, tid, ts, dur)

    def step(self, k, ts, dur):
        self.span(f"ProfilerStep#{k}", ts, dur)

    def launch(self, tid, ts, at, dur, cat="kernel"):
        """A launch on `tid` at host time `ts` of an operation that runs
        on the device from `at` for `dur`."""
        self.corr += 1
        self.host("cuda_runtime", "cudaLaunchKernel", tid, ts, 1.0,
                  correlation=self.corr)
        self.ev.append({"ph": "X", "cat": cat, "name": "k", "tid": STREAM,
                        "pid": 0, "ts": at, "dur": dur,
                        "args": {"correlation": self.corr}})


def test_a_kernel_goes_to_the_innermost_span_of_its_launch():
    e = Events()
    e.step(0, 0, 100)
    e.span("asr.block", 10, 50)
    e.span("asr.ffn", 12, 20)
    e.launch(MAIN, 15, 70, 5)    # inside asr.ffn; runs after it closed
    e.launch(MAIN, 40, 75, 3)    # in asr.block, after asr.ffn
    e.launch(MAIN, 80, 90, 2)    # outside every span
    e.ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy", "tid": 7,
                 "pid": 0, "ts": 95, "dur": 1, "args": {"correlation": 99}})
    c = spans.attribute(e.ev)
    assert c.steps == [0] and c.n_spans == 2
    assert c.self_us == {"asr.ffn": 5, "asr.block": 3, spans.OUTSIDE: 2,
                         spans.NO_LAUNCH: 1}
    assert c.total_us == {"asr.ffn": 5, "asr.block": 8, spans.OUTSIDE: 2,
                          spans.NO_LAUNCH: 1}
    assert c.launches == {"asr.ffn": 1, "asr.block": 1, spans.OUTSIDE: 1,
                          spans.NO_LAUNCH: 1}
    assert c.busy_us == 11 and c.window_us == 100
    assert c.phase_us == {spans.OUTSIDE: 10, spans.NO_LAUNCH: 1}


def test_a_kernel_without_a_launch_goes_to_its_operator():
    """A launch API the profiler does not record: the device operation
    names the operator it was launched from by External id."""
    e = Events()
    e.step(0, 0, 100)
    e.span("asr.subsample", 10, 30)
    e.host("cpu_op", "aten::cudnn_convolution", MAIN, 12, 10,
           **{"External id": 41})
    e.ev.append({"ph": "X", "cat": "kernel", "name": "cudnn", "tid": STREAM,
                 "pid": 0, "ts": 50, "dur": 9,
                 "args": {"correlation": 77, "External id": 41}})
    c = spans.attribute(e.ev)
    assert c.self_us == {"asr.subsample": 9}


def test_the_backward_goes_to_the_forward_ops_span_by_sequence_number():
    """The engine's thread launches inside evaluate_function; the trace
    numbers the forward thread 1 there, its own id is the system's."""
    e = Events()
    e.step(3, 0, 200)
    e.span("train.forward", 0, 50)
    e.span("asr.conv", 5, 20)
    e.host("cpu_op", "aten::mul", MAIN, 6, 2, **{"Sequence number": 7,
                                                 "Fwd thread id": 0})
    e.host("cpu_op", "aten::add", MAIN, 9, 2, **{"Sequence number": 8,
                                                 "Fwd thread id": 0})
    e.span("asr.mhsa", 30, 10)
    e.host("cpu_op", "aten::mm", MAIN, 31, 2, **{"Sequence number": 9,
                                                 "Fwd thread id": 0})
    e.launch(MAIN, 7, 60, 4)
    e.span("train.backward", 60, 100)
    for seq, ts in ((9, 70), (7, 90)):
        e.host("cpu_op", f"{spans.EVALUATE}: XBackward0", ENGINE, ts, 10,
               **{"Sequence number": seq, "Fwd thread id": 1})
        e.launch(ENGINE, ts + 1, ts + 30, 6)
    e.launch(ENGINE, 150, 170, 2)    # the engine, outside evaluate_function
    c = spans.attribute(e.ev)
    assert c.self_us == {"asr.conv": 10, "asr.mhsa": 6, spans.OUTSIDE: 2}
    assert c.by_seq_us == 12
    assert c.phase_us == {"train.forward": 4, "train.backward": 14}


def test_a_phase_is_the_outermost_train_span_and_self_time_excludes_children():
    e = Events()
    e.step(0, 0, 100)
    e.span("train.forward", 0, 40)
    e.span("asr.block", 5, 30)
    e.span("asr.mhsa", 6, 10)
    e.launch(MAIN, 7, 50, 4)     # mhsa
    e.launch(MAIN, 20, 55, 2)    # block's own
    e.launch(MAIN, 38, 60, 1)    # train.forward's own
    e.span("train.optimizer", 60, 20)
    e.launch(MAIN, 65, 70, 3)
    c = spans.attribute(e.ev)
    assert c.phase_us == {"train.forward": 7, "train.optimizer": 3}
    assert c.self_us == {"asr.mhsa": 4, "asr.block": 2, "train.forward": 1,
                         "train.optimizer": 3}
    assert c.total_us["asr.block"] == 6 and c.total_us["train.forward"] == 7
    assert spans.breakdown(c)["spans"][0] == ["asr.mhsa", 4e-6, 1]


def test_idle_gaps_take_the_main_threads_innermost_span():
    e = Events()
    e.step(0, 0, 100)
    e.span("asr.block", 0, 70)
    e.span("asr.mhsa", 10, 40)
    e.launch(MAIN, 1, 0, 20)
    e.launch(MAIN, 12, 40, 10)   # gap 20..40, middle 30: in asr.mhsa
    e.launch(MAIN, 60, 55, 5)    # gap 50..55, middle 52.5: in asr.block
    c = spans.attribute(e.ev)
    assert c.idle == [("asr.mhsa", 20), ("asr.block", 5),
                      (spans.OUTSIDE, 40)]
    assert spans.breakdown(c)["idle_spans"][0] == [spans.OUTSIDE, 40e-6]


class Kineto:
    """A kineto event of the profiler's results, made from a Chrome trace
    event (what `spans.events_of` reads)."""

    def __init__(self, ev):
        self.ev, self.args = ev, ev.get("args") or {}

    def name(self):
        return self.ev["name"]

    def start_ns(self):
        return int(round(self.ev["ts"] * 1e3))

    def duration_ns(self):
        return int(round(self.ev["dur"] * 1e3))

    def start_thread_id(self):
        return self.ev.get("tid", 0)

    def is_user_annotation(self):
        return self.ev["cat"] == "user_annotation"

    def device_type(self):
        return SimpleNamespace(name="CUDA" if self.ev["cat"] in
                               spans.DEVICE_CATS else "CPU")

    def linked_correlation_id(self):
        return 5 if self.ev["cat"] == "cuda_runtime" else 0

    def correlation_id(self):
        return self.args.get("correlation", 0)

    def sequence_nr(self):
        return self.args.get("Sequence number", -1)

    def fwd_thread_id(self):
        return self.args.get("Fwd thread id", 0)


class FakeTracer:
    """A `Tracer` whose profiler holds `events` as its last cycle, which
    ran to its end unless `finished` says which steps did."""

    def __init__(self, events, finished=None):
        raw = [Kineto(e) for e in events]
        self.prof = SimpleNamespace(profiler=SimpleNamespace(
            kineto_results=SimpleNamespace(events=lambda: raw)))
        if finished is None:
            finished = {int(e["name"].split("#")[1]) for e in events
                        if e["name"].startswith("ProfilerStep#")}
        self.finished = finished


def ctx_of(events, mode, batches=None):
    doc = small.config_doc()
    mix = small.SERVE_MIX if mode == "serve" else small.TRAIN_MIX
    return harness.Context(doc, mix, {}, FakeTracer(events), batches)


def serve_cycle():
    """Two requests (steps 4 and 5) through every serving span."""
    e = Events()
    t = 0.0
    for k in (4, 5):
        e.step(k, t, 1000)
        names = ["asr.frontend", "asr.subsample", "asr.rel_bias",
                 "asr.block", "asr.ffn", "asr.mhsa", "asr.conv", "asr.ffn",
                 "asr.ctc_head", "asr.greedy"]
        for i, name in enumerate(names):
            at = t + 10 + 60 * i
            inner = name in ("asr.ffn", "asr.mhsa", "asr.conv")
            if name == "asr.block":
                e.span(name, at, 295)
                e.launch(MAIN, at + 285, t + 600, 7)   # the block's own
                continue
            e.span(name, at, 40 if inner else 50)
            e.launch(MAIN, at + 1, at + 5, 3 + i)
        e.launch(MAIN, t + 700, t + 900, 11)           # the ids' copy
        t += 1000
    e.ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy", "tid": 7,
                 "pid": 0, "ts": 1950, "dur": 4, "args": {}})  # no launch
    return e.ev


def load(name):
    return harness.load_module("metrics", name)


def test_serve_readers_add_up_to_the_busy_time():
    ev = serve_cycle()
    c = spans.attribute(ev)
    ctx = ctx_of(ev, "serve")
    got = {n: load(n).read(ctx) for n in SERVE_READERS}
    assert sum(got.values()) == pytest.approx(c.busy_us / 1e3 / 2)
    assert got["ffn_ms.serve"] == pytest.approx((7 + 10) / 1e3)
    assert got["mhsa_ms.serve"] == pytest.approx((5 + 8) / 1e3)
    assert got["block_self_ms.serve"] == pytest.approx(7 / 1e3)
    assert got["unspanned_ms.serve"] == pytest.approx((11 + 2) / 1e3)
    for n in TRAIN_READERS:
        assert load(n).read(ctx) is None


def test_readers_read_nothing_without_program_spans():
    """The parent program: a trace with steps and kernels but no span."""
    e = Events()
    e.step(0, 0, 100)
    e.launch(MAIN, 1, 10, 30)
    for mode, names in (("serve", SERVE_READERS + ("ffn_roofline",)),
                        ("train", TRAIN_READERS)):
        ctx = ctx_of(e.ev, mode)
        for n in names:
            assert load(n).read(ctx) is None, n
    assert load("ffn_ms.serve").read(harness.Context(
        small.config_doc(), small.SERVE_MIX, {}, None)) is None


def test_ffn_count_and_roofline():
    cfg = {"frontend": small.config_doc()["config"]["frontend"],
           "model": {"encoder_layers": 2, "encoder_dim": 8,
                     "encoder_ffn_dim": 32}}
    # encoder frames 25 and 10 (test_portbench_counts.BATCH)
    batch = {"B": 2, "grid": 400 + 160 * 119,
             "audio_lens": [400 + 160 * 98, 400 + 160 * 39],
             "enc_lens": [25, 10], "enc_grid": 30}
    w = harness.count("ffn", cfg, batch)
    assert w["flops"] == 2 * 8 * 35 * 8 * 32 == 143360
    half = 2 * (2 * 8 * 32 + 32 + 8) + 4 * 2 * 8 + 2 * 2 * 35 * 8
    assert w["bytes"] == 2 * 2 * half and w["precision"] == "bf16"
    ev = serve_cycle()
    doc = small.config_doc()
    batches = [dict(batch)] * 6
    ctx = harness.Context(doc, small.SERVE_MIX, {}, FakeTracer(ev), batches)
    from portbench.roofline import least_seconds

    want = 2 * least_seconds(harness.count("ffn", doc["config"], batch))
    got = load("ffn_roofline").read(ctx)
    assert got == pytest.approx(100 * want / 34e-6)


def test_ffn_roofline_reads_nothing_of_a_cycle_the_window_cut():
    """The window closed inside the last cycle: the profiler's step after
    the last request (5) is in the cycle, and no batch stands for it."""
    batch = {"B": 2, "grid": 400 + 160 * 119,
             "audio_lens": [400 + 160 * 98, 400 + 160 * 39],
             "enc_lens": [25, 10], "enc_grid": 30}
    ctx = harness.Context(small.config_doc(), small.SERVE_MIX, {},
                          FakeTracer(serve_cycle(), finished=set()),
                          [dict(batch)] * 5)
    assert load("ffn_roofline").read(ctx) is None


@pytest.mark.parametrize("steps,finished", [
    (12, [3, 4, 5, 9, 10, 11]),   # both cycles ran to their end
    (11, [3, 4, 5]),              # the window closed inside the second
    (10, [3, 4, 5])])
def test_the_tracer_knows_which_cycles_finished(steps, finished):
    from portbench.trace import Tracer

    t = Tracer(wait=2, active=3, cycles=2, sync_edges=False)
    with t:
        for i in range(steps):
            t.before(i)
            torch.ones(8).sum()
            t.after(i)
    assert sorted(t.finished) == finished
    assert t.profiled[:len(finished)] == finished


def test_readers_read_nothing_where_the_window_closed_before_any_cycle():
    from portbench.trace import Tracer

    t = Tracer(wait=5, active=1, cycles=1, sync_edges=False)
    with t:
        for i in range(2):
            t.before(i)
            t.after(i)
    ctx = harness.Context(small.config_doc(), small.SERVE_MIX, {}, t,
                          [{}] * 2)
    assert spans.cycle_of(ctx) is None
    for n in SERVE_READERS + ("ffn_roofline",):
        assert load(n).read(ctx) is None, n


def device_ops_for_each_operator(events):
    """A launch in the middle of each host operator and a device operation
    for it, and one profiler step around the whole: the CPU trace made to
    look like a card's."""
    out, corr = list(events), 0
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") ==
           "cpu_op"]
    for e in ops:
        corr += 1
        t = float(e["ts"]) + float(e["dur"]) / 2
        out.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunch",
                    "tid": e["tid"], "pid": 0, "ts": t, "dur": 0.0,
                    "args": {"correlation": corr}})
        out.append({"ph": "X", "cat": "kernel", "name": "k", "tid": STREAM,
                    "pid": 0, "ts": t, "dur": 0.001,
                    "args": {"correlation": corr}})
    t0 = min(float(e["ts"]) for e in ops) - 1
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in ops) + 1
    out.append({"ph": "X", "cat": "user_annotation", "name": "ProfilerStep#0",
                "tid": ops[0]["tid"], "pid": 0, "ts": t0, "dur": t1 - t0,
                "args": {}})
    return out


def profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return spans.attribute(device_ops_for_each_operator(
        spans.events_of(prof)))


def test_a_real_profile_of_the_small_model():
    doc = small.config_doc()
    path = harness.load_family(doc["family"]).path
    cfg, model = path.build(doc["config"], "cpu")
    pool = traffic.make_pool(small.TRAIN_MIX, doc["config"], 5, "cpu")
    with torch.inference_mode():
        c = profiled(lambda: path.serve_request(model, pool[0]))
    assert {"asr.frontend", "asr.subsample", "asr.rel_bias", "asr.block",
            "asr.ffn", "asr.mhsa", "asr.conv", "asr.ctc_head",
            "asr.greedy"} <= set(c.self_us)
    assert sum(c.self_us.values()) == pytest.approx(c.busy_us, rel=1e-3)
    assert c.self_us[spans.OUTSIDE] < 0.2 * c.busy_us
    solver = harness.build_solver(cfg, model, 3, "cpu")
    batch = harness.host_batches(pool, pin=False)[0]
    c = profiled(lambda: solver.train_step(
        batch, spec_mask=pool[0]["spec_mask"]))
    assert set(c.phase_us) == {"train.put", "train.forward", "train.loss",
                               "train.backward", "train.optimizer"}
    assert sum(c.phase_us.values()) == pytest.approx(c.busy_us, rel=1e-3)
    # the backward reaches the module spans through sequence numbers
    assert c.by_seq_us > 0.8 * c.phase_us["train.backward"]
    modules = sum(v for k, v in c.self_us.items() if k.startswith("asr."))
    assert modules > c.phase_us["train.forward"] - c.self_us.get(
        "train.forward", 0.0)
