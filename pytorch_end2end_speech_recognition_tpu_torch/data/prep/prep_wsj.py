"""WSJ prep: local LDC WSJ0/WSJ1 trees (converted to WAV) -> JSONL
manifests (the port of the JAX package's `data/prep/prep_wsj.py`). WSJ is
LDC-licensed; this converter downloads nothing and indexes a local tree
in the kaldi-style layout:

    python -m pytorch_end2end_speech_recognition_tpu_torch.data.prep.prep_wsj \
        --index train_si284=/path/si284.flist:/path/si284.trans \
        --index eval92=/path/eval92.flist:/path/eval92.trans --out data/wsj

where each .flist has one WAV path a line (utterance id = its stem, upper
case) and each .trans has `UTT_ID transcript` lines (kaldi text format).
Paths that do not exist and utterances without a transcript are left out.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from pytorch_end2end_speech_recognition_tpu_torch.data.audio import read_wav
from pytorch_end2end_speech_recognition_tpu_torch.data.manifest import (
    Utterance,
    write_manifest,
)


def prep_index(flist: Path, trans: Path, out: Path) -> int:
    texts = {}
    for line in trans.read_text().splitlines():
        uid, _, text = line.strip().partition(" ")
        texts[uid.upper()] = text
    utts = []
    for line in flist.read_text().splitlines():
        wav = Path(line.strip())
        if not wav.exists():
            continue
        uid = wav.stem.upper()
        if uid not in texts:
            continue
        x, sr = read_wav(wav)
        utts.append(Utterance(id=uid, audio=str(wav),
                              duration_s=len(x) / sr, text=texts[uid]))
    write_manifest(out, utts)
    return len(utts)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--index", action="append", required=True,
                    metavar="NAME=FLIST:TRANS")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for spec in args.index:
        name, _, rest = spec.partition("=")
        flist, _, trans = rest.partition(":")
        n = prep_index(Path(flist), Path(trans), out / f"{name}.jsonl")
        print(f"{name}: {n} utts")


if __name__ == "__main__":
    main()
