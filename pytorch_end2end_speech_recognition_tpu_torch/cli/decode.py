"""Decoding/scoring entry point: greedy CTC or joint beam search + WER/CER
(the port of the JAX package's `cli/decode.py`). Usage:

    python -m pytorch_end2end_speech_recognition_tpu_torch.cli.decode \
        --config cfg.json --checkpoint-tag best --manifest test.jsonl \
        [--mode beam --beam-size 10 --lm-weight 0.3 --lm-checkpoint lm_dir] \
        [--nbest-out nbest.jsonl] [--device cpu]

Prints one JSON line {"id", "ref", "hyp"} per utterance and the `WER ...
CER ... SER ...` line on stderr. `--mode attention` is the beam without the
CTC scorer (decode.ctc_weight 0). Decodes on CUDA unless `--device cpu` is
given (and raises without a card).

Several processes (cli.train's `--distributed` / `--coordinator`
flags): every rank reads the whole manifest and holds the whole model,
decodes its own contiguous rows of each batch (`decode/beam.py`'s row
split, greedy or beam), and the results are gathered to every rank in
input order; each rank counts the errors of its rows and the counts are
summed over the ranks, so rank 0 prints every utterance's line and the
WER line of one process's decode (and writes `--nbest-out`).
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint-tag", default="best")
    ap.add_argument("--manifest", required=True)
    ap.add_argument("--mode", default=None,
                    choices=[None, "greedy", "beam", "attention"])
    ap.add_argument("--beam-size", type=int, default=None)
    ap.add_argument("--lm-weight", type=float, default=None)
    ap.add_argument("--lm-checkpoint", default=None)
    ap.add_argument("--nbest-out", default=None, help="write N-best JSONL here")
    ap.add_argument("--set", action="append", default=[], metavar="K=V")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    from pytorch_end2end_speech_recognition_tpu_torch.cli.train import (
        add_distributed_args,
        end_distributed,
        init_distributed,
        load_config,
    )

    add_distributed_args(ap)
    args = ap.parse_args(argv)

    import torch

    from pytorch_end2end_speech_recognition_tpu_torch.data.dataset import (
        BucketedLoader,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.data.manifest import (
        read_manifest,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.data.tokenizer import (
        load_for_config,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.decode.beam import (
        by_rows,
        split_rows,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.metrics.wer import (
        ErrorStats,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.parallel.collectives import (  # noqa: E501
        all_reduce_,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.training.solver import (
        Solver,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
        parse_overrides,
    )

    cfg = parse_overrides(load_config(args.config), args.set)
    if args.mode == "attention":      # attention-only beam (no CTC scorer)
        cfg.decode.mode = "beam"
        cfg.decode.ctc_weight = 0.0
    elif args.mode:
        cfg.decode.mode = args.mode
    if args.beam_size is not None:
        cfg.decode.beam_size = args.beam_size
    if args.lm_weight is not None:
        cfg.decode.lm_weight = args.lm_weight

    tok = load_for_config(cfg)
    # the Solver only holds the checkpoint's weights here: no metrics file
    cfg.train.metrics_path = cfg.train.tensorboard_dir = ""
    mesh = init_distributed(args, cfg, args.device, rows_only=True)
    group = mesh.world_group if mesh is not None else None
    rank0 = mesh is None or mesh.rank == 0
    solver = Solver(cfg, tok, device=mesh.device if mesh else args.device)
    solver.load_checkpoint(args.checkpoint_tag)
    solver.model.eval()
    cfg = solver.cfg

    utts = read_manifest(args.manifest)
    loader = BucketedLoader(utts, tok, cfg.data,
                            sample_rate=cfg.frontend.sample_rate, train=False)

    beam = None
    if cfg.decode.mode == "beam":
        from pytorch_end2end_speech_recognition_tpu_torch.decode.beam import (
            BeamSearchDecoder,
        )

        lm = None
        if args.lm_checkpoint and cfg.decode.lm_weight > 0:
            from pytorch_end2end_speech_recognition_tpu_torch.cli.train_lm import (  # noqa: E501
                load_lm,
            )

            lm = load_lm(args.lm_checkpoint, cfg, tok, device=solver.device)
        beam = BeamSearchDecoder(solver.model, cfg.decode, lm=lm, mesh=mesh)

    wer_stats, cer_stats = ErrorStats(), ErrorStats()
    nbest_f = open(args.nbest_out, "w") if args.nbest_out and rank0 else None
    try:
        for batch in loader.epoch(0):
            mine = split_rows(len(batch.audio_lens), group)
            if beam is not None:
                results = beam.decode_batch(batch, tok)
                hyps = [r[0]["text"] if r else "" for r in results]
                if nbest_f:
                    for uid, r in zip(batch.ids, results):
                        nbest_f.write(json.dumps({"id": uid, "nbest": r})
                                      + "\n")
            else:
                hyps = by_rows(solver.decode_batch, batch, group)
            for i, (ref, hyp) in enumerate(zip(batch.texts, hyps)):
                if batch.audio_lens[i] == 0:
                    continue
                if i in mine:
                    wer_stats.update(ref.split(), hyp.split())
                    cer_stats.update(list(ref.replace(" ", "")),
                                     list(hyp.replace(" ", "")))
                if rank0:
                    print(json.dumps({"id": batch.ids[i], "ref": ref,
                                      "hyp": hyp}))
    finally:
        if nbest_f:
            nbest_f.close()
    for stats in (wer_stats, cer_stats):
        counts = all_reduce_(torch.tensor(
            [stats.errors, stats.tokens, stats.sentences,
             stats.wrong_sentences]), group).tolist()
        (stats.errors, stats.tokens, stats.sentences,
         stats.wrong_sentences) = counts
    end_distributed(args)
    if not rank0:
        return wer_stats
    print(
        f"WER {wer_stats.rate:.4f} ({wer_stats.errors}/{wer_stats.tokens})  "
        f"CER {cer_stats.rate:.4f}  SER {wer_stats.ser:.4f}",
        file=sys.stderr,
    )
    return wer_stats


if __name__ == "__main__":
    main()
