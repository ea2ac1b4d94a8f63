"""Corpus manifests: one JSONL row per utterance (the port's copy of the
JAX package's `data/manifest.py`). Rows:

    {"id": str, "audio": str, "duration_s": float, "text": str}
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path


@dataclass
class Utterance:
    id: str
    audio: str
    duration_s: float
    text: str


def write_manifest(path: str | Path, utts: list[Utterance]) -> None:
    with open(path, "w") as f:
        for u in utts:
            f.write(json.dumps(u.__dict__, ensure_ascii=False) + "\n")


def read_manifest(path: str | Path) -> list[Utterance]:
    utts = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                utts.append(Utterance(**json.loads(line)))
    return utts


def filter_utts(
    utts: list[Utterance],
    min_s: float = 0.0,
    max_s: float = 1e9,
    max_label_len: int | None = None,
    tokenizer=None,
) -> list[Utterance]:
    out = []
    for u in utts:
        if not (min_s <= u.duration_s <= max_s):
            continue
        if max_label_len is not None and tokenizer is not None:
            if len(tokenizer.encode(u.text)) > max_label_len:
                continue
        out.append(u)
    return out
