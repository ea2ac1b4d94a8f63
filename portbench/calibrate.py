"""Readings from which a cell's correctness limits are set, in one process.

    python -m portbench.calibrate --workload <cell> --seeds 1,2,3 \\
        [--seconds 2] [--controls 1]

For each seed: the program's readings, as a run takes them (a short window
at the cell's own load, the same judged requests or compared steps), and
with --controls the lower-precision control's: the configuration's family
reference computed with its products in float8
(`reference.common.Prec('fp8')`) in the program's place, read by the
family path's `control_readings`; for training also the fault of half the
batch left out (the loss's mean over the other half). One JSON line a
seed. Needs the card.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import harness, judge, traffic
from portbench.reference.common import Prec, no_tf32
from portbench.weights import make_weights


def serve_controls(fam, cfg_doc, seed, pool, win, dev) -> dict:
    """The float8 reference's readings on the batches of the requests a run
    judges (`control_readings` of the float32 and float8 references, each
    given the first judged request's served ids of the batch)."""
    w = make_weights(fam.ref, cfg_doc["config"], cfg_doc["init"],
                     traffic.sub_seed(seed, "weights"), dev)
    served = {}
    for i in sorted(win["judged"]):
        b, _, out = win["records"][i]
        served.setdefault(b, out)
    pairs = []
    with no_tf32():
        for b, out in served.items():
            pairs.append(tuple(fam.ref.serve_reference(
                w, pool[b], out, cfg_doc["config"], Prec(p),
                harness.REF_BLOCK_ROWS) for p in ("fp32", "fp8")))
    return fam.path.control_readings(pairs)


def train_controls(fam, cfg_doc, seed, pool, n, dev) -> dict:
    w = make_weights(fam.ref, cfg_doc["config"], cfg_doc["init"],
                     traffic.sub_seed(seed, "weights"), dev)
    batches = [tuple(pool[k][f] for f in ("audio", "audio_lens", "tokens",
                                          "token_lens", "spec_mask"))
               for k in range(n)]
    half = [(a, al, t, tl * (torch.arange(len(tl), device=tl.device)
                             < len(tl) // 2), s)
            for a, al, t, tl, s in batches]
    dseed = traffic.sub_seed(seed, "dropout")
    out = {}
    with no_tf32():
        want = fam.ref.train_steps(w, batches, cfg_doc["config"],
                                   Prec("fp32"), dseed,
                                   harness.REF_BLOCK_ROWS)
        for tag, prec, bs in (("fp8", "fp8", batches),
                              ("half_batch", "fp32", half)):
            got = fam.ref.train_steps(w, bs, cfg_doc["config"], Prec(prec),
                                      dseed, harness.REF_BLOCK_ROWS)
            out[tag] = judge.train_readings(got, want)
            out[tag]["worst_grad_leaves"] = judge.leaf_table(
                got["grad_norms"], want["grad_norms"], list(want["grad_norms"]))[:4]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--controls", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    bench = json.loads(harness.BENCH.read_text())
    cfg_doc, mix, _ = harness.load_cell(args.workload, bench)
    fam = harness.load_family(cfg_doc["family"])
    cfg, model = fam.path.build(cfg_doc["config"], dev)
    for seed in (int(s) for s in args.seeds.split(",")):
        w = make_weights(fam.ref, cfg_doc["config"], cfg_doc["init"],
                         traffic.sub_seed(seed, "weights"), dev)
        harness.load_weights(model, w)
        pool = traffic.make_pool(mix, cfg_doc["config"], seed, dev)
        row = {"seed": seed}
        if mix["mode"] == "serve":
            del w
            order = torch.randperm(len(pool), generator=torch.Generator()
                                   .manual_seed(traffic.sub_seed(
                                       seed, "order2"))).tolist()
            keep = harness.judged(mix, seed, pool, order)
            win = harness.serve_window(fam.path.serve_request, model, pool,
                                       order, args.seconds, keep=keep)
            row["program"] = harness.judge_serve(fam, cfg_doc, seed, pool,
                                                 win, dev)
            if args.controls:
                row["fp8"] = serve_controls(fam, cfg_doc, seed, pool, win,
                                            dev)
        else:
            n = mix["compared_steps"]
            solver = harness.build_solver(cfg, model,
                                          traffic.sub_seed(seed, "dropout"),
                                          dev)
            batches = harness.host_batches(pool[:n], pin=True)
            masks = [b["spec_mask"] for b in pool]
            prog = harness.first_steps(solver, batches, masks, w, n)
            del solver, batches, w
            torch.cuda.empty_cache()
            row["program"] = harness.judge_train(fam, cfg_doc, seed, pool,
                                                 prog, n, dev, detail=True)
            if args.controls:
                row.update(train_controls(fam, cfg_doc, seed, pool, n, dev))
        print(json.dumps(row), flush=True)
        del pool
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
