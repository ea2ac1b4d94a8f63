"""Run one cell of the benchmark once on the card and print its result.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device (with --trace 1 also breakdown), and last the
numbers the correctness check compared, each beside its limit; the same
numbers end standard error. Exits 2 without a result when there is no CUDA
card, and 3 when a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    bench = json.loads(harness.BENCH.read_text())
    chips = harness.cell_entry(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), torch.device("cuda"), bench)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: modules loaded that the benchmark may not load: "
              f"{bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
