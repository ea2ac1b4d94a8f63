"""The harness on the CPU: the files it finds by name (the family's
reference and path among them), the traffic and a mix's own trace
schedule, the names and units of BENCHMARK.json, a run without a card,
and the check that decides `correct`, which has to pass the program and
fail it with the timed path broken underneath (a step that leaves the
state unchanged, half of the batch left out, a served token altered)."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import harness, traffic
from portbench.tests import small

REPO = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = small.bench()
SERVE = "conformer_m.serve.30s"
TRAIN = "conformer_l.train.30s"


def test_every_cell_finds_its_files():
    root = harness.ROOT
    for w in BENCH["workloads"]:
        cfg, mix, lim = harness.load_cell(w["name"], BENCH)
        assert cfg["name"] == w["config"]
        assert mix["mode"] in ("serve", "train")
        assert lim
        for mode in ("serve", "train"):
            assert (root / "counts" / f"{cfg['counts'][mode]}.py").exists()
    for c in BENCH["configs"]:
        doc = json.loads((REPO / c["file"]).read_text())
        assert doc["name"] == c["name"] and doc["reduced"] == c["reduced"]
        assert (root / "reference" / f"{doc['family']}.py").exists()
        assert (root / "paths" / f"{doc['family']}.py").exists()
        fam = harness.load_family(doc["family"])
        for fn in ("param_spec", "enc_len", "serve_reference",
                   "train_steps"):
            assert callable(getattr(fam.ref, fn)), (doc["family"], fn)
        for fn in ("build", "serve_request", "serve_readings",
                   "control_readings"):
            assert callable(getattr(fam.path, fn)), (doc["family"], fn)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (root / "metrics" / f"{m['name']}.py").exists(), m["name"]


def test_traffic_follows_the_seed():
    cfg = small.config_doc()["config"]
    a = traffic.make_pool(small.TRAIN_MIX, cfg, 2**33 + 5, "cpu")
    b = traffic.make_pool(small.TRAIN_MIX, cfg, 2**33 + 5, "cpu")
    c = traffic.make_pool(small.TRAIN_MIX, cfg, 2**33 + 6, "cpu")
    for x, y in zip(a, b):
        for k in x:
            assert torch.equal(x[k], y[k])
    assert not torch.equal(a[0]["audio"], c[0]["audio"])
    # every seed gets the same lengths, in its own order
    lens = sorted(int(n) for p in a for n in p["audio_lens"])
    assert lens == sorted(int(n) for p in c for n in p["audio_lens"])
    assert [int(n) for n in a[0]["audio_lens"]] != [
        int(n) for n in c[0]["audio_lens"]]


@pytest.mark.parametrize("trace,want", [
    (None, harness.TRACE["serve"]),
    ({"wait": 1, "active": 2, "cycles": 1},
     dict(wait=1, active=2, cycles=1, sync_edges=False))])
def test_a_mix_may_set_its_trace_schedule(monkeypatch, trace, want):
    from portbench import trace as tracing

    seen = []
    real = tracing.Tracer.__init__

    def init(self, **kw):
        seen.append(kw)
        real(self, **kw)

    monkeypatch.setattr(tracing.Tracer, "__init__", init)
    mix = dict(small.SERVE_MIX, **({"trace": trace} if trace else {}))
    r = harness.run(SERVE, 11, 0.3, True, torch.device("cpu"), BENCH,
                    files=(small.config_doc(), mix, small.limits(SERVE)))
    assert seen == [want]
    assert r["correct"] and r["device"]["window_s"] >= 0


def test_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 0 < len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_every_layer_metric_moves_what_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell]), (m["name"], cell)
    for w in BENCH["workloads"]:
        reported = harness.cell_metrics(BENCH, w["name"], False)
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert harness.cell_metrics(BENCH, w["name"], True)


def _run(args, cwd):
    return subprocess.run([sys.executable, "-m", "portbench.run", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env={"PATH": "/usr/bin:/bin",
                                            "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    out = _run(["--workload", SERVE, "--seed", "5", "--seconds", "1",
                "--trace", "0"], REPO)
    assert out.returncode != 0
    assert "metrics" not in out.stdout


def test_without_the_program_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(["--workload", SERVE, "--seed", "5", "--seconds", "1",
                "--trace", "0"], tmp_path)
    assert out.returncode != 0
    assert "metrics" not in out.stdout


# ---------------------------------------------------------------- correct
def run_small(cell, mix, seed=11, name="conformer_m"):
    """A run of `cell`'s check at a small size on the CPU (the program's
    plain path), held to the cell's own limits."""
    return harness.run(cell, seed, 0.3, False, torch.device("cpu"), BENCH,
                       files=(small.config_doc(name), mix,
                              small.limits(cell)))


@pytest.mark.parametrize("cell,mix", [(SERVE, small.SERVE_MIX),
                                      (TRAIN, small.TRAIN_MIX)])
def test_sound_runs_are_correct(cell, mix):
    r = run_small(cell, mix)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"


def _altered_greedy(real):
    def greedy(logits, lens):
        hyp, hyp_lens = real(logits, lens)
        hyp = hyp.clone()
        hyp[:, 0] = 1 + hyp[:, 0] % (logits.shape[-1] - 1)
        return hyp, torch.clamp(hyp_lens, min=1)
    return greedy


def test_a_served_token_altered_is_not_correct(monkeypatch):
    from pytorch_end2end_speech_recognition_tpu_torch.ops import ctc

    monkeypatch.setattr(ctc, "ctc_greedy_decode",
                        _altered_greedy(ctc.ctc_greedy_decode))
    assert not run_small(SERVE, small.SERVE_MIX)["correct"]


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(monkeypatch):
    from pytorch_end2end_speech_recognition_tpu_torch.training import (
        schedules,
    )

    monkeypatch.setattr(schedules.Optimizer, "step",
                        lambda self, grads, lr_scale=1.0: torch.zeros(()))
    r = run_small(TRAIN, small.TRAIN_MIX)
    assert not r["correct"]
    assert r["checks"]["grad_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    from pytorch_end2end_speech_recognition_tpu_torch.training import solver

    real = solver.hybrid_loss

    def half(logits, enc_lens, att, tokens, token_lens, *a, **k):
        keep = torch.arange(len(token_lens)) < len(token_lens) // 2
        return real(logits, enc_lens, att, tokens, token_lens * keep, *a,
                    **k)

    monkeypatch.setattr(solver, "hybrid_loss", half)
    assert not run_small(TRAIN, small.TRAIN_MIX)["correct"]


# ---------------------------------------------------------------- controls
def test_the_float8_control_in_the_programs_place_is_not_correct(
        monkeypatch):
    """Serving: the reference with its products in float8 serves the
    tokens in the program's place."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops.ctc import (
        ctc_greedy_decode,
    )

    from portbench.reference.common import Prec

    cfg = small.config_doc()["config"]
    fam = harness.load_family("conformer_ctc")

    def control(model, batch):
        w = {n: p.detach() for n, p in model.named_parameters()}
        logits, lens = fam.ref.serve_reference(w, batch, None, cfg,
                                               Prec("fp8"), 8)
        hyp, hyp_lens = ctc_greedy_decode(logits, lens)
        return torch.cat([hyp_lens[:, None], hyp], dim=1).cpu(), logits

    monkeypatch.setattr(fam.path, "serve_request", control)
    assert not run_small(SERVE, small.SERVE_MIX)["correct"]


def test_the_float8_control_in_the_solvers_place_is_not_correct(
        monkeypatch):
    """Training: the reference's steps with their products in float8 stand
    for the Solver's first steps."""
    from portbench.reference import conformer_ctc as ref
    from portbench.reference.common import Prec

    cfg = small.config_doc()["config"]

    def control(solver, batches, masks, weights, n):
        bs = [tuple(torch.as_tensor(a) for a in (
            b.audio, b.audio_lens, b.tokens, b.token_lens)) + (masks[k],)
            for k, b in enumerate(batches[:n])]
        return ref.train_steps(weights, bs, cfg, Prec("fp8"),
                               solver.cfg.train.seed, 8)

    monkeypatch.setattr(harness, "first_steps", control)
    assert not run_small(TRAIN, small.TRAIN_MIX)["correct"]
