"""Export a trained checkpoint as a serving bundle (the port of the JAX
package's `cli/export.py`).

    python -m pytorch_end2end_speech_recognition_tpu_torch.cli.export \
        --config cfg.json --checkpoint-tag best --out-dir bundle/ \
        [--mode greedy|beam] [--batch-sizes 1,8] [--seconds 10,30] \
        [--device cpu]

One bucket for each pair of the cross product of `--batch-sizes` and
`--seconds`. `--device` (default cuda; raises without a card) takes the
place of the JAX CLI's `--platforms`: export on the device that will
serve. A greedy bundle is self-contained: a serving host needs only
`serving.load_bundle(dir).transcribe(...)`, not the model code or the
checkpoint; a beam bundle carries the weights and config and needs the
model code. See serving/export.py. Under several processes (cli.train's
`--distributed` / `--coordinator` flags) the checkpoint is restored
through the train.dp x train.tp mesh, gathered whole, and rank 0 writes
the bundle.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint-tag", default="best")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--mode", default="greedy", choices=["greedy", "beam"])
    ap.add_argument("--batch-sizes", default="1,8")
    ap.add_argument("--seconds", default="10,30")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu': the serving device")
    from pytorch_end2end_speech_recognition_tpu_torch.cli.train import (
        add_distributed_args,
        end_distributed,
        init_distributed,
        load_config,
    )

    add_distributed_args(ap)
    args = ap.parse_args(argv)

    from pytorch_end2end_speech_recognition_tpu_torch.data.tokenizer import (
        load_for_config,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.serving.export import (
        export_bundle,
    )

    cfg = load_config(args.config)
    tok = load_for_config(cfg)
    mesh = init_distributed(args, cfg, args.device, tag="export")
    out = export_bundle(
        cfg, tok, args.out_dir, checkpoint_tag=args.checkpoint_tag,
        mode=args.mode,
        batch_sizes=[int(x) for x in args.batch_sizes.split(",")],
        seconds=[float(x) if "." in x else int(x)
                 for x in args.seconds.split(",")],
        device=args.device, mesh=mesh,
    )
    end_distributed(args)
    print(f"exported serving bundle -> {out}", file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
