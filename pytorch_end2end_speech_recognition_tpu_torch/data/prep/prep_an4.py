"""AN4 corpus prep: a local CMU AN4 tree -> JSONL manifests (the port of
the JAX package's `data/prep/prep_an4.py`). It downloads nothing: point it
at an AN4 tree already on disk
(http://www.speech.cs.cmu.edu/databases/an4/):

    python -m pytorch_end2end_speech_recognition_tpu_torch.data.prep.prep_an4 \
        --root /path/to/an4 --out data/an4

Expects the standard layout: `etc/an4_train.transcription`,
`etc/an4_test.transcription`, and the audio as WAV files anywhere under
the root (raw/sph converted to wav). The last `--dev-fraction` of the
training transcriptions become the dev split.
"""

from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path

from pytorch_end2end_speech_recognition_tpu_torch.data.audio import read_wav
from pytorch_end2end_speech_recognition_tpu_torch.data.manifest import (
    Utterance,
    write_manifest,
)


def parse_transcription(path: Path) -> list[tuple[str, str]]:
    """Lines like `<s> HELLO WORLD </s> (an406-fash-b)` -> (id, text)."""
    out = []
    for line in path.read_text().splitlines():
        m = re.match(r"^(?:<s> )?(.*?)(?: </s>)? \(([^)]+)\)\s*$", line.strip())
        if m:
            text = re.sub(r"</?s>", "", m.group(1)).strip()
            out.append((m.group(2), text))
    return out


def find_wav(root: Path, utt_id: str) -> Path | None:
    for cand in root.rglob(f"{utt_id}.wav"):
        return cand
    return None


def prep_split(root: Path, pairs: list[tuple[str, str]], out: Path) -> int:
    """Write the manifest of `pairs` whose WAV exists and whose text is not
    empty; a WAV that cannot be read is reported and left out, as in the
    JAX converter. Returns the utterances written."""
    utts = []
    for uid, text in pairs:
        wav = find_wav(root, uid)
        if wav is None or not text:
            continue
        try:
            x, sr = read_wav(wav)
        except ValueError:
            print(f"skipping unreadable {wav}", file=sys.stderr)
            continue
        utts.append(Utterance(id=uid, audio=str(wav),
                              duration_s=len(x) / sr, text=text))
    write_manifest(out, utts)
    return len(utts)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", required=True, help="AN4 corpus root")
    ap.add_argument("--out", required=True, help="output manifest dir")
    ap.add_argument("--dev-fraction", type=float, default=0.1)
    args = ap.parse_args(argv)
    root, out = Path(args.root), Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    train_tr = root / "etc" / "an4_train.transcription"
    test_tr = root / "etc" / "an4_test.transcription"
    if not train_tr.exists():
        raise SystemExit(f"{train_tr} not found: put the AN4 tree on local "
                         "disk first (this converter downloads nothing)")
    train_pairs = parse_transcription(train_tr)
    n_dev = max(1, int(len(train_pairs) * args.dev_fraction))
    n = prep_split(root, train_pairs[:-n_dev], out / "train.jsonl")
    d = prep_split(root, train_pairs[-n_dev:], out / "dev.jsonl")
    t = prep_split(root, parse_transcription(test_tr), out / "test.jsonl")
    print(f"wrote {n} train / {d} dev / {t} test utts to {out}")


if __name__ == "__main__":
    main()
