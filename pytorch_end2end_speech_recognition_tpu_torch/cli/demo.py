"""Self-contained demo: synthesize a digits corpus, train, decode, report
WER (the port of the JAX package's `cli/demo.py`).

    python -m pytorch_end2end_speech_recognition_tpu_torch.cli.demo \
        --workdir /tmp/demo [--steps 300] [--encoder conformer] [--device cpu]

The canonical smoke for this framework on a machine with no speech data:
a 2-layer d96 model in float32. Runs on CUDA unless `--device cpu` (or its
alias `--cpu`) is given, and raises without a card. On the card the
log-mel, LSTM and CTC kernels run; the attention kernels take bfloat16
with head dim 64, which the demo's float32 d96 model has not, so its
attention runs plain torch there.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--encoder", default="blstm",
                    choices=["blstm", "pblstm", "transformer", "conformer"])
    ap.add_argument("--ctc-weight", type=float, default=1.0)
    ap.add_argument("--decoder", default="lstm",
                    choices=["lstm", "transformer"])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--cpu", dest="device", action="store_const",
                    const="cpu", help="alias of --device cpu")
    args = ap.parse_args(argv)

    from pytorch_end2end_speech_recognition_tpu_torch.data.dataset import (
        BucketedLoader,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.data.manifest import (
        read_manifest,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.data.synthetic import (
        make_digits_corpus,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.data.tokenizer import (
        CharTokenizer,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.training.solver import (
        Solver,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
        AsrConfig,
    )

    work = Path(args.workdir)
    work.mkdir(parents=True, exist_ok=True)
    manifests = make_digits_corpus(work / "corpus", n_train=48, n_dev=12,
                                   n_test=12, max_digits=3)
    utts = read_manifest(manifests["train"])
    tok = CharTokenizer([u.text for u in utts])
    tok.save(work / "tokenizer.json")

    cfg = AsrConfig(name="demo")
    cfg.data.tokenizer_path = str(work / "tokenizer.json")
    cfg.model.encoder = args.encoder
    cfg.model.encoder_layers = 2
    cfg.model.encoder_dim = 96
    cfg.model.ctc_weight = args.ctc_weight
    cfg.model.decoder = args.decoder
    if args.decoder == "transformer":
        cfg.model.decoder_layers = 2
        cfg.model.decoder_dim = 96
        cfg.model.decoder_heads = 4
    cfg.model.dtype = "float32"
    if args.encoder in ("transformer", "conformer"):
        cfg.model.attn_impl = "torch"  # float32, head dim 24: see above
    cfg.frontend.spec_augment = False
    cfg.data.batch_size = 8
    cfg.data.n_length_buckets = 2
    cfg.train.lr = 1e-3
    cfg.train.schedule = "constant"
    cfg.train.log_every = 50
    cfg.train.metrics_path = str(work / "metrics.jsonl")
    cfg.train.checkpoint_dir = str(work / "ckpt")

    loader = BucketedLoader(utts, tok, cfg.data)
    dev = BucketedLoader(read_manifest(manifests["dev"]), tok, cfg.data,
                         train=False)
    solver = Solver(cfg, tok, device=args.device)
    try:
        solver.fit(loader, steps=args.steps)
        solver.save_checkpoint("last")
    finally:
        solver.logger.close()

    train_wer = solver.evaluate(loader)
    dev_wer = solver.evaluate(dev)
    b = next(iter(dev.epoch(0)))
    hyps = solver.decode_batch(b)
    for r, h in list(zip(b.texts, hyps))[:4]:
        print(f"  ref: {r}\n  hyp: {h}", file=sys.stderr)
    result = {"train_wer": train_wer, "dev_wer": dev_wer}
    if args.ctc_weight < 1.0:
        from pytorch_end2end_speech_recognition_tpu_torch.decode.beam import (
            BeamSearchDecoder,
        )
        from pytorch_end2end_speech_recognition_tpu_torch.metrics.wer import (
            ErrorStats,
        )

        beam = BeamSearchDecoder(solver.model.eval(), solver.cfg.decode)
        stats = ErrorStats()
        for batch in dev.epoch(0):
            for i, r in enumerate(beam.decode_batch(batch, tok)):
                if batch.audio_lens[i] == 0:
                    continue
                hyp = r[0]["text"] if r else ""
                stats.update(batch.texts[i].split(), hyp.split())
        result["beam_dev_wer"] = stats.rate
        print(f"beam dev WER {stats.rate:.3f}", file=sys.stderr)
    print(f"train WER {train_wer:.3f}  dev WER {dev_wer:.3f}", file=sys.stderr)
    print(result)
    return train_wer


if __name__ == "__main__":
    main()
