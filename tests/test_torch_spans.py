"""The port's spans (`utils/profiling.py:span`) on the CPU: under
`torch.profiler` the serving path and `Solver.train_step` name every layer
and phase, nested as the model nests them and once a call; with no
profiler `record_function` is never entered; `Solver.fit` logs the
loader's wait; an exported serving program holds no profiler node."""

import json
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pytorch_end2end_speech_recognition_tpu_torch.configs.presets import (
    flagship_conformer,
)
from pytorch_end2end_speech_recognition_tpu_torch.data.dataset import Batch
from pytorch_end2end_speech_recognition_tpu_torch.data.tokenizer import (
    CharTokenizer,
)
from pytorch_end2end_speech_recognition_tpu_torch.models.asr import AsrModel
from pytorch_end2end_speech_recognition_tpu_torch.ops.ctc import (
    ctc_greedy_decode,
)
from pytorch_end2end_speech_recognition_tpu_torch.serving.export import (
    GreedyProgram,
)
from pytorch_end2end_speech_recognition_tpu_torch.training.solver import (
    Solver,
)
from pytorch_end2end_speech_recognition_tpu_torch.utils import profiling

LAYERS = 2
TRAIN = ("train.put", "train.forward", "train.loss", "train.backward",
         "train.optimizer")


def tiny_cfg(encoder="conformer", remat=False):
    cfg = flagship_conformer()
    m = cfg.model
    m.encoder, m.remat = encoder, remat
    m.encoder_layers, m.encoder_dim, m.encoder_ffn_dim = LAYERS, 32, 64
    m.encoder_heads, m.decoder_layers, m.decoder_dim = 2, 1, 32
    m.subsample_channels = 8
    cfg.train.schedule, cfg.train.log_every = "constant", 1
    cfg.train.metrics_path = ""
    return cfg


def batch():
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((2, 8000)) * 0.1).astype(np.float32)
    return Batch(audio, np.asarray([8000, 5000], np.int32),
                 np.asarray([[3, 4, 5], [6, 2, 0]], np.int32),
                 np.asarray([3, 2], np.int32))


def serve(model, b):
    audio = torch.from_numpy(b.audio)
    lens = torch.from_numpy(b.audio_lens)
    with torch.inference_mode():
        enc, enc_lens = model.encode(audio, lens)
        return ctc_greedy_decode(model.ctc_logits(enc), enc_lens)


def spans_of(fn, tmp_path):
    """(the program's spans as (name, start, end), sorted by start) of one
    call of `fn` under the profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
                   for e in events if e.get("cat") == "user_annotation"
                   and e["name"].startswith(("asr.", "train.", "fit."))),
                  key=lambda s: s[1])


def inside(span, outer) -> bool:
    return outer[1] <= span[1] and span[2] <= outer[2]


def parents(spans, name):
    """For each span called `name`, the names of the spans around it."""
    return [sorted(o[0] for o in spans if o is not s and inside(s, o))
            for s in spans if s[0] == name]


def test_span_is_a_shared_null_context_without_a_profiler(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    a, b = profiling.span("asr.ffn"), profiling.span("train.loss")
    assert a is b
    with a:
        pass


def test_span_is_a_range_of_the_trace_under_a_profiler(tmp_path):
    def fn():
        with profiling.span("asr.ffn"):
            torch.ones(8).sum()

    got = spans_of(fn, tmp_path)
    assert [s[0] for s in got] == ["asr.ffn"]
    assert profiling.span("asr.ffn") is profiling.span("asr.conv")


@pytest.mark.parametrize("encoder", ["conformer", "transformer"])
def test_serving_path_spans_nest_as_the_model(encoder, tmp_path):
    model = AsrModel(tiny_cfg(encoder), device="cpu", seed=0).eval()
    b = batch()
    got = spans_of(lambda: serve(model, b), tmp_path)
    blocks = {"conformer": {"asr.ffn": 2, "asr.mhsa": 1, "asr.conv": 1},
              "transformer": {"asr.ffn": 1, "asr.mhsa": 1}}[encoder]
    want = {"asr.frontend": 1, "asr.subsample": 1, "asr.rel_bias": 1,
            "asr.block": LAYERS, "asr.ctc_head": 1, "asr.greedy": 1,
            **{k: v * LAYERS for k, v in blocks.items()}}
    assert Counter(s[0] for s in got) == want
    for name in blocks:
        assert parents(got, name) == [["asr.block"]] * want[name]
    for name in ("asr.frontend", "asr.subsample", "asr.rel_bias",
                 "asr.block", "asr.ctc_head", "asr.greedy"):
        assert parents(got, name) == [[]] * want[name], name
    order = [s[0] for s in got if s[0] != "asr.block"
             and not any(inside(s, o) for o in got if o[0] == "asr.block")]
    assert order == ["asr.frontend", "asr.subsample", "asr.rel_bias",
                     "asr.ctc_head", "asr.greedy"]


def test_train_step_spans_the_five_phases(tmp_path):
    solver = Solver(tiny_cfg(), CharTokenizer(charset="ABCDEFGH"),
                    device="cpu")
    b = batch()
    got = spans_of(lambda: solver.train_step(b), tmp_path)
    phases = [s for s in got if s[0].startswith("train.")]
    assert [s[0] for s in phases] == list(TRAIN)
    assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))
    forward = phases[1]
    for name in ("asr.frontend", "asr.specaugment", "asr.subsample",
                 "asr.rel_bias", "asr.block", "asr.ffn", "asr.mhsa",
                 "asr.conv", "asr.ctc_head", "asr.decoder"):
        found = [s for s in got if s[0] == name]
        assert found and all(inside(s, forward) for s in found), name
    assert not any(s[0].startswith("asr.") and not inside(s, forward)
                   for s in got)


def test_remat_recompute_opens_the_module_spans_again(tmp_path):
    solver = Solver(tiny_cfg(remat=True), CharTokenizer(charset="ABCDEFGH"),
                    device="cpu")
    b = batch()
    got = spans_of(lambda: solver.train_step(b), tmp_path)
    backward = next(s for s in got if s[0] == "train.backward")
    again = Counter(s[0] for s in got if s is not backward
                    and inside(s, backward))
    assert again == {"asr.block": LAYERS, "asr.ffn": 2 * LAYERS,
                     "asr.mhsa": LAYERS, "asr.conv": LAYERS}


@pytest.mark.parametrize("path", ["serve", "train"])
def test_unprofiled_runs_never_enter_record_function(path, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    b = batch()
    if path == "serve":
        model = AsrModel(tiny_cfg(), device="cpu", seed=0).eval()
        hyp, lens = serve(model, b)
        assert hyp.shape[0] == 2 and lens.shape == (2,)
    else:
        solver = Solver(tiny_cfg(), CharTokenizer(charset="ABCDEFGH"),
                        device="cpu")
        assert torch.isfinite(solver.train_step(b)["loss"])


class OneBatch:
    """A loader that yields the same batch at every cursor."""

    def __init__(self, batch):
        self.batch = batch

    def repeat(self, epoch=0, batch=0, with_cursor=False):
        while True:
            yield (epoch, batch, self.batch) if with_cursor else self.batch
            batch += 1


def test_fit_logs_the_loaders_wait(tmp_path):
    solver = Solver(tiny_cfg(), CharTokenizer(charset="ABCDEFGH"),
                    device="cpu")
    got = spans_of(lambda: solver.fit(OneBatch(batch()), steps=3), tmp_path)
    assert [r["step"] for r in solver.log] == [1, 2, 3]
    waits = [r["data_wait_s"] for r in solver.log]
    assert all(0.0 <= w <= r["wall_s"] for w, r in zip(waits, solver.log))
    assert waits == sorted(waits)
    assert Counter(s[0] for s in got)["fit.data_wait"] == 4
    assert Counter(s[0] for s in got)["train.optimizer"] == 3


def test_exported_serving_program_has_no_profiler_node():
    model = AsrModel(tiny_cfg(), device="cpu", seed=0).eval()
    with torch.no_grad():
        ep = torch.export.export(GreedyProgram(model).eval(), (
            torch.zeros((2, 8000)), torch.full((2,), 8000, dtype=torch.int32)))
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert any("conv2d" in t for t in targets), targets
    assert not any("profiler" in t or "record_function" in t
                   for t in targets)
