"""LibriSpeech prep: a local OpenSLR-12 tree -> JSONL manifests (the port
of the JAX package's `data/prep/prep_librispeech.py`). It downloads
nothing: point it at the split directories already on disk:

    python -m pytorch_end2end_speech_recognition_tpu_torch.data.prep.prep_librispeech \
        --root /data/LibriSpeech --splits train-clean-100 dev-clean test-clean \
        --out data/librispeech

LibriSpeech ships FLAC, which `data/flac.py` (and `native/`) decode
directly; with `--ext flac` (the default) each duration is exact, read
from the file's STREAMINFO header without a decode.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from pytorch_end2end_speech_recognition_tpu_torch.data.audio import read_wav
from pytorch_end2end_speech_recognition_tpu_torch.data.flac import flac_info
from pytorch_end2end_speech_recognition_tpu_torch.data.manifest import (
    Utterance,
    write_manifest,
)

SAMPLE_RATE = 16000


def prep_split(root: Path, split: str, out: Path, ext: str) -> int:
    split_dir = root / split
    if not split_dir.exists():
        raise SystemExit(f"{split_dir} not found: put LibriSpeech on local "
                         "disk first (this converter downloads nothing)")
    utts = []
    for trans in sorted(split_dir.rglob("*.trans.txt")):
        for line in trans.read_text().splitlines():
            uid, _, text = line.partition(" ")
            audio = trans.parent / f"{uid}.{ext}"
            if not audio.exists():
                continue
            if ext == "wav":
                x, sr = read_wav(audio)
                dur = len(x) / sr
            else:
                dur = flac_info(audio).duration_s
            utts.append(Utterance(id=uid, audio=str(audio),
                                  duration_s=dur, text=text.strip()))
    write_manifest(out, utts)
    return len(utts)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", required=True)
    ap.add_argument("--splits", nargs="+",
                    default=["train-clean-100", "dev-clean", "test-clean"])
    ap.add_argument("--out", required=True)
    ap.add_argument("--ext", default="flac", choices=["wav", "flac"])
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for split in args.splits:
        n = prep_split(Path(args.root), split, out / f"{split}.jsonl",
                       args.ext)
        print(f"{split}: {n} utts")


if __name__ == "__main__":
    main()
