"""One run of one cell: set-up, the measured window, the check of what the
window produced, and the result line.

A cell of `BENCHMARK.json` names a configuration (`configs/<name>.json`)
and a traffic mix (`traffic/<name>.json`). The configuration names its
model family (`family`), whose plain reference is `reference/<family>.py`
and whose serving path through the program is `paths/<family>.py`. The
mix's `mode` says which path the window drives:

- serve: one closed-loop client sends requests of one padded batch each,
  in a seeded order over a pool of distinct batches staged on the card;
  a request is the family path's `serve_request`, which ends with the
  served ids on the host. Set-up warms the path on two requests. After the
  window, a seeded sample of the finished requests is judged against the
  family reference's `serve_reference` by the path's `serve_readings`.
- train: `Solver.train_step` on pinned host batches from a pool, each with
  a SpecAugment mask drawn from the seed. Set-up drives the Solver through
  its first `compared_steps` steps; their losses, the first gradient (from
  Adam's state) and each leaf's change are kept, and the window goes on
  with the same Solver. After the window, the family reference's
  `train_steps` takes the same steps from the same weights.

A traced run profiles the mix's `trace` schedule ({wait, active, cycles}),
or where it gives none its mode's (`TRACE`). Metric values come from
readers found by name in `metrics/<name>.py`, work counts from
`counts/<name>.py`.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import random
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import NamedTuple

import torch

from portbench import judge, shapes, traffic
from portbench.reference.common import Prec, no_tf32
from portbench.weights import make_weights

ROOT = Path(__file__).resolve().parent
BENCH = ROOT.parent / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "pytorch_end2end_speech_recognition_tpu")
REF_BLOCK_ROWS = 8
SERVE_WARMUP = 2
TRACE = {"serve": dict(wait=20, active=3, cycles=4, sync_edges=False),
         "train": dict(wait=12, active=2, cycles=3, sync_edges=True)}


def since_process_start() -> float:
    """Seconds since this process started (the kernel's clock ticks)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def load_module(kind: str, name: str):
    path = ROOT / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Family(NamedTuple):
    """A model family's two modules: its plain reference and the path that
    drives the program."""

    ref: ModuleType
    path: ModuleType


def load_family(name: str) -> Family:
    """`reference/<name>.py` and `paths/<name>.py`."""
    return Family(importlib.import_module(f"portbench.reference.{name}"),
                  importlib.import_module(f"portbench.paths.{name}"))


def count(name: str, cfg: dict, batch: dict) -> dict:
    """The work count `counts/<name>.py` of one batch: {flops, bytes,
    precision}."""
    return load_module("counts", name).work(cfg, batch)


def cell_entry(bench: dict, cell: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"no cell {cell!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of `cell` reports: its end-to-end metrics, or with
    `trace` its per-layer ones."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m["workloads"] or (
                "workloads" not in m and m["moves"] in names)]


class Context:
    """What a metric reader reads: the window's record, the trace, the
    configuration and the work counts."""

    def __init__(self, cfg_doc: dict, mix: dict, window: dict, tracer=None,
                 batches=None, setup_s: float = 0.0):
        self.cfg_doc = cfg_doc
        self.cfg = cfg_doc["config"]
        self.mix = mix
        self.window = window
        self.tracer = tracer
        self.batches = batches or []
        self.setup_s = setup_s

    def count(self, name: str, batch: dict) -> dict:
        return count(name, self.cfg, batch)

    def model_count(self, batch: dict) -> dict:
        return self.count(self.cfg_doc["counts"][self.mix["mode"]], batch)

    def profiled(self) -> list[dict]:
        """Descriptors of the batches of the profiled steps."""
        return [self.batches[i] for i in self.tracer.profiled]


# ---------------------------------------------------------------- program
@torch.no_grad()
def load_weights(model, weights: dict) -> None:
    params = dict(model.named_parameters())
    if set(params) != set(weights) or any(
            params[n].shape != weights[n].shape for n in params):
        raise RuntimeError("the program's parameters differ from the "
                           "reference's names or shapes")
    for n, p in params.items():
        p.copy_(weights[n])


def serve_window(request, model, pool, order, seconds, tracer=None,
                 keep=()) -> dict:
    """Requests (`request(model, batch)`) of the closed-loop client until
    `seconds` have passed: records (batch, latency, host ids), and what is
    judged of the requests in `keep`."""
    recs, kept = [], {}
    with torch.inference_mode():
        t0 = time.perf_counter()
        t1 = t0
        i = 0
        while t1 - t0 < seconds:
            b = order[i % len(order)]
            if tracer:
                tracer.before(i)
            sent = time.perf_counter()
            out, lg = request(model, pool[b])
            t1 = time.perf_counter()
            if tracer:
                tracer.after(i)
            recs.append((b, t1 - sent, out))
            if i in keep:
                kept[i] = lg
            i += 1
    return {"records": recs, "judged": kept, "seconds": t1 - t0}


class _Vocab:
    """The tokenizer's part the Solver reads."""

    def __init__(self, n: int):
        self.vocab_size = n


def build_solver(cfg, model, seed: int, dev):
    from pytorch_end2end_speech_recognition_tpu_torch.training.solver import (
        Solver,
    )

    cfg.train.seed = seed
    return Solver(cfg, _Vocab(cfg.model.vocab_size), device=dev, model=model)


def host_batches(pool: list[dict], pin: bool) -> list:
    from pytorch_end2end_speech_recognition_tpu_torch.data.dataset import (
        Batch,
        pin_batch,
    )

    out = []
    for b in pool:
        hb = Batch(*(b[k].cpu().numpy() for k in
                     ("audio", "audio_lens", "tokens", "token_lens")))
        out.append(pin_batch(hb) if pin else hb)
    return out


def first_steps(solver, batches, masks, weights: dict, n: int) -> dict:
    """Drive the Solver through its first n steps on batches 0..n-1 and
    read what the comparison needs."""
    losses = []
    for k in range(n):
        losses.append(float(solver.train_step(batches[k],
                                              spec_mask=masks[k])["loss"]))
        if k == 0:
            g = [float(x) / (1 - solver.opt.B1)
                 for x in torch._foreach_norm(solver.opt.m1)]
            grads = dict(zip(solver.names, g))
    with torch.no_grad():
        change = {name: float(torch.linalg.vector_norm(p - weights[name]))
                  for name, p in zip(solver.names, solver.params)}
    return {"loss": losses, "grad_norms": grads, "change_norms": change}


def train_window(solver, batches, masks, start, seconds, tracer=None) -> dict:
    steps, losses = [], []
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        k = (start + i) % len(batches)
        if tracer:
            tracer.before(i)
        losses.append(solver.train_step(batches[k],
                                        spec_mask=masks[k])["loss"])
        if tracer:
            tracer.after(i)
        steps.append(k)
        i += 1
    if solver.device.type == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    bad = int((~torch.isfinite(torch.stack(losses))).sum()) if losses else 0
    return {"steps": steps, "seconds": t1 - t0, "failed": bad}


# ---------------------------------------------------------------- checks
def judged(mix, seed, pool, order) -> set[int]:
    """The requests to judge, drawn from the seed before the window: the
    first of the longest batch, and others among the first four rounds of
    the pool (`judged_requests` in all)."""
    rng = random.Random(traffic.sub_seed(seed, "judge"))
    audio = [int(b["audio_lens"].sum()) for b in pool]
    first = order.index(max(range(len(pool)), key=audio.__getitem__))
    rest = [i for i in range(4 * len(order)) if i != first]
    return {first, *rng.sample(rest, mix["judged_requests"] - 1)}


def judge_serve(fam: Family, cfg_doc, seed, pool, win, dev) -> dict:
    """The judged requests' readings (the path's `serve_readings`) against
    the reference's `serve_reference` of their batches and served ids (once
    a batch while its served ids repeat)."""
    weights = make_weights(fam.ref, cfg_doc["config"], cfg_doc["init"],
                           traffic.sub_seed(seed, "weights"), dev)
    want, pairs = {}, []
    with no_tf32():
        for i, got in sorted(win["judged"].items()):
            b, _, out = win["records"][i]
            if b not in want or not torch.equal(want[b][0], out):
                want[b] = out, fam.ref.serve_reference(
                    weights, pool[b], out, cfg_doc["config"], Prec("fp32"),
                    REF_BLOCK_ROWS)
            pairs.append((out, got, *want[b][1]))
        return fam.path.serve_readings(pairs)


def judge_train(fam: Family, cfg_doc, seed, pool, prog: dict, n: int, dev,
                detail: bool = False) -> dict:
    weights = make_weights(fam.ref, cfg_doc["config"], cfg_doc["init"],
                           traffic.sub_seed(seed, "weights"), dev)
    batches = [tuple(pool[k][f] for f in ("audio", "audio_lens", "tokens",
                                          "token_lens", "spec_mask"))
               for k in range(n)]
    with no_tf32():
        want = fam.ref.train_steps(weights, batches, cfg_doc["config"],
                                   Prec("fp32"),
                                   traffic.sub_seed(seed, "dropout"),
                                   REF_BLOCK_ROWS)
    out = judge.train_readings(prog, want)
    if detail:
        out["worst_grad_leaves"] = judge.leaf_table(
            prog["grad_norms"], want["grad_norms"], list(want["grad_norms"]))[:6]
        out["losses"] = [prog["loss"], want["loss"]]
    return out


def quiet_collector() -> None:
    """Collect what set-up left and move it out of the collector's sight,
    so that the window's collections scan only the window's objects."""
    gc.collect()
    gc.freeze()


def forbidden_modules() -> list[str]:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


# ---------------------------------------------------------------- one run
def load_cell(cell: str, bench: dict) -> tuple[dict, dict, dict]:
    """(configuration file, traffic mix, limits) of a cell, by name."""
    entry = cell_entry(bench, cell)
    cfg_doc = json.loads((ROOT / "configs" / f"{entry['config']}.json")
                         .read_text())
    return cfg_doc, traffic.load_mix(entry["traffic"]), judge.load_limits(cell)


def run(cell: str, seed: int, seconds: float, trace: bool, dev,
        bench: dict | None = None, files: tuple | None = None,
        family: Family | None = None) -> dict:
    """One run of `cell`; returns the result (without printing it).
    `files` replaces what `load_cell` would read, and `family` the family
    that the configuration names (the tests' small configurations and
    families)."""
    bench = bench or json.loads(BENCH.read_text())
    cfg_doc, mix, limits = files or load_cell(cell, bench)
    fam = family or load_family(cfg_doc["family"])
    # one thread of host work: the program's work on the host is Python
    # dispatch, and idle intra-op threads only take cores from it
    torch.set_num_threads(1)
    cfg, model = fam.path.build(cfg_doc["config"], dev)
    weights = make_weights(fam.ref, cfg_doc["config"], cfg_doc["init"],
                           traffic.sub_seed(seed, "weights"), dev)
    load_weights(model, weights)
    pool = traffic.make_pool(mix, cfg_doc["config"], seed, dev)
    descs = [shapes.describe(b, cfg_doc["config"], fam.ref) for b in pool]
    cuda = torch.device(dev).type == "cuda"
    tracer = None
    if trace:
        from portbench.trace import Tracer

        tracer = Tracer(**{**TRACE[mix["mode"]], **mix.get("trace", {})})
    if mix["mode"] == "serve":
        del weights
        order = torch.randperm(len(pool), generator=torch.Generator()
                               .manual_seed(traffic.sub_seed(seed, "order2")))
        order = order.tolist()
        keep = judged(mix, seed, pool, order)
        request = fam.path.serve_request
        with torch.inference_mode():
            for k in range(SERVE_WARMUP):
                request(model, pool[order[k % len(order)]])
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = since_process_start()
        quiet_collector()
        if tracer:
            with tracer:
                win = serve_window(request, model, pool, order, seconds,
                                   tracer, keep)
        else:
            win = serve_window(request, model, pool, order, seconds,
                               keep=keep)
        recs = win["records"]
        win.update(attempted=len(recs), failed=0,
                   latencies=[lat for _, lat, _ in recs],
                   audio_s=sum(sum(descs[b]["audio_lens"])
                               for b, _, _ in recs)
                   / cfg_doc["config"]["frontend"]["sample_rate"])
        step_descs = [descs[b] for b, _, _ in recs]
    else:
        n = mix["compared_steps"]
        solver = build_solver(cfg, model, traffic.sub_seed(seed, "dropout"),
                              dev)
        batches = host_batches(pool, pin=cuda)
        masks = [b["spec_mask"] for b in pool]
        prog = first_steps(solver, batches, masks, weights, n)
        del weights
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = since_process_start()
        quiet_collector()
        if tracer:
            with tracer:
                win = train_window(solver, batches, masks, n, seconds, tracer)
        else:
            win = train_window(solver, batches, masks, n, seconds)
        win.update(attempted=len(win["steps"]),
                   audio_s=sum(sum(descs[k]["audio_lens"])
                               for k in win["steps"])
                   / cfg_doc["config"]["frontend"]["sample_rate"])
        step_descs = [descs[k] for k in win["steps"]]
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    ctx = Context(cfg_doc, mix, win, tracer, step_descs, setup_s)
    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        v = load_module("metrics", m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    # free the program's state before the reference runs
    del model
    if mix["mode"] == "train":
        del solver, batches
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if mix["mode"] == "serve":
        readings = judge_serve(fam, cfg_doc, seed, pool, win, dev)
    else:
        readings = judge_train(fam, cfg_doc, seed, pool, prog, n, dev)
    ok, checks = judge.verdict(readings, limits)
    result = {"correct": ok, "attempted": win["attempted"],
              "failed": win["failed"], "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": (torch.cuda.get_device_name(0) if cuda
                                  else "cpu"),
                         "count": 1, "memory_peak_bytes": peak}}
    if tracer:
        result["device"].update(busy_s=tracer.busy_s(),
                                window_s=tracer.window_s())
        result["breakdown"] = tracer.breakdown()
    result["checks"] = checks
    return result
