"""Readings from which a cell's correctness limits are set, in one process.

    python -m portbench.calibrate --workload <cell> --seeds 1,2,3 \\
        [--seconds 2] [--controls 1]

For each seed: the program's readings, as a run takes them (a short window
at the cell's own load, the same judged requests or compared steps), and
with --controls the lower-precision control's: the reference computed with
its products in float8 (`reference.model.Prec('fp8')`) in the program's
place; for training also the fault of half the batch left out (the loss's
mean over the other half). One JSON line a seed. Needs the card.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import harness, judge, traffic
from portbench.reference import model as ref
from portbench.weights import make_weights


def serve_controls(cfg_doc, seed, pool, win, dev) -> dict:
    """The float8 reference's readings on the requests a run judges: its
    logits' relative error, and the gap of the label it puts first at each
    frame."""
    w = make_weights(cfg_doc["config"], cfg_doc["init"],
                     traffic.sub_seed(seed, "weights"), dev)
    gaps, d2, r2 = [], 0.0, 0.0
    with ref.no_tf32():
        for b in {win["records"][i][0] for i in win["logits"]}:
            args = (w, pool[b]["audio"], pool[b]["audio_lens"],
                    cfg_doc["config"])
            want, lens = ref.serve_logits(*args, ref.Prec("fp32"),
                                          harness.REF_BLOCK_ROWS)
            low, _ = ref.serve_logits(*args, ref.Prec("fp8"),
                                      harness.REF_BLOCK_ROWS)
            gaps.append(judge.argmax_gap(want, lens, low))
            valid = (torch.arange(want.shape[1], device=dev)[None, :]
                     < lens[:, None])
            d2 += float(((low - want)[valid] ** 2).sum())
            r2 += float((want[valid] ** 2).sum())
    return {"max_logit_gap": max(gaps), "logit_rel_err": (d2 / r2) ** 0.5}


def train_controls(cfg_doc, seed, pool, n, dev) -> dict:
    w = make_weights(cfg_doc["config"], cfg_doc["init"],
                     traffic.sub_seed(seed, "weights"), dev)
    batches = [tuple(pool[k][f] for f in ("audio", "audio_lens", "tokens",
                                          "token_lens", "spec_mask"))
               for k in range(n)]
    half = [(a, al, t, tl * (torch.arange(len(tl), device=tl.device)
                             < len(tl) // 2), s)
            for a, al, t, tl, s in batches]
    dseed = traffic.sub_seed(seed, "dropout")
    out = {}
    with ref.no_tf32():
        want = ref.train_steps(w, batches, cfg_doc["config"],
                               ref.Prec("fp32"), dseed,
                               harness.REF_BLOCK_ROWS)
        for tag, prec, bs in (("fp8", "fp8", batches),
                              ("half_batch", "fp32", half)):
            got = ref.train_steps(w, bs, cfg_doc["config"], ref.Prec(prec),
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
    cfg, model = harness.build_program(cfg_doc, dev)
    for seed in (int(s) for s in args.seeds.split(",")):
        w = make_weights(cfg_doc["config"], cfg_doc["init"],
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
            win = harness.serve_window(model, pool, order, args.seconds,
                                       keep=keep)
            row["program"] = harness.judge_serve(cfg_doc, seed, pool, win,
                                                 dev)
            if args.controls:
                row["fp8"] = serve_controls(cfg_doc, seed, pool, win, dev)
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
            row["program"] = harness.judge_train(cfg_doc, seed, pool, prog, n,
                                                 dev, detail=True)
            if args.controls:
                row.update(train_controls(cfg_doc, seed, pool, n, dev))
        print(json.dumps(row), flush=True)
        del pool
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
