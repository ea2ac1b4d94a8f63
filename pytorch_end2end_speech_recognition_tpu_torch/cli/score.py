"""Standalone scoring: WER/CER/SER between ref and hyp files (the port of
the JAX package's `cli/score.py`). Accepts either a decode JSONL
({"id","ref","hyp"} rows) or two parallel text files (one utterance per
line, optionally 'UTT_ID text').

    python -m pytorch_end2end_speech_recognition_tpu_torch.cli.score \
        results.jsonl
    python -m pytorch_end2end_speech_recognition_tpu_torch.cli.score \
        --ref ref.txt --hyp hyp.txt [--ids]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from pytorch_end2end_speech_recognition_tpu_torch.metrics.wer import ErrorStats


def read_pairs_jsonl(path: str) -> list[tuple[str, str]]:
    pairs = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        d = json.loads(line)
        pairs.append((d["ref"], d["hyp"]))
    return pairs


def read_pairs_txt(ref: str, hyp: str, ids: bool) -> list[tuple[str, str]]:
    def load(p):
        out = {}
        for i, line in enumerate(Path(p).read_text().splitlines()):
            if ids:
                uid, _, text = line.partition(" ")
            else:
                uid, text = str(i), line
            out[uid] = text.strip()
        return out

    refs, hyps = load(ref), load(hyp)
    missing = set(refs) - set(hyps)
    if missing:
        print(f"warning: {len(missing)} utts missing from hyp", file=sys.stderr)
    return [(refs[k], hyps.get(k, "")) for k in refs]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("jsonl", nargs="?", help="decode CLI results JSONL")
    ap.add_argument("--ref")
    ap.add_argument("--hyp")
    ap.add_argument("--ids", action="store_true",
                    help="text files start with utterance ids")
    args = ap.parse_args(argv)
    if args.jsonl:
        pairs = read_pairs_jsonl(args.jsonl)
    elif args.ref and args.hyp:
        pairs = read_pairs_txt(args.ref, args.hyp, args.ids)
    else:
        ap.error("give a results JSONL or --ref/--hyp")
    wer, cer = ErrorStats(), ErrorStats()
    for r, h in pairs:
        wer.update(r.split(), h.split())
        cer.update(list(r.replace(" ", "")), list(h.replace(" ", "")))
    print(json.dumps({
        "utts": wer.sentences,
        "wer": round(wer.rate, 4), "wer_errors": wer.errors,
        "wer_tokens": wer.tokens,
        "cer": round(cer.rate, 4), "ser": round(wer.ser, 4),
    }))


if __name__ == "__main__":
    main()
