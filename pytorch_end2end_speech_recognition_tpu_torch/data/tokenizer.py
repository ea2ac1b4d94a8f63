"""Text pipeline: char-level and BPE subword tokenizers (the port's copy of
the JAX package's `data/tokenizer.py`). BPE is a small self-contained
byte-pair-merge trainer. Token id conventions (shared across CTC head,
decoder, LM):

    0 = <blank> (CTC)    1 = <sos>/<eos> (shared, decoder)    2 = <unk>
"""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path

import numpy as np

BLANK_ID = 0
SOS_EOS_ID = 1
UNK_ID = 2
N_SPECIAL = 3
SPECIALS = ["<blank>", "<sos/eos>", "<unk>"]


class Tokenizer:
    """Base interface shared by char and BPE tokenizers."""

    vocab: list[str]

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def encode(self, text: str) -> list[int]:
        raise NotImplementedError

    def decode(self, ids: list[int] | np.ndarray) -> str:
        raise NotImplementedError

    def vocab_hash(self) -> int:
        """Stable uint32 fingerprint of the vocab, stored in checkpoint meta
        so decode/transcribe can detect a tokenizer/checkpoint mismatch
        (e.g. the train manifest changed and a rebuild produced a different
        vocab with the same size — silent garbage transcripts otherwise)."""
        import zlib

        payload = json.dumps([self.kind, self.vocab], ensure_ascii=False)
        return zlib.crc32(payload.encode("utf-8")) & 0xFFFFFFFF

    def save(self, path: str | Path) -> None:
        Path(path).write_text(
            json.dumps({"kind": self.kind, **self._state()}, ensure_ascii=False)
        )

    @staticmethod
    def load(path: str | Path) -> "Tokenizer":
        d = json.loads(Path(path).read_text())
        if d["kind"] == "char":
            t = CharTokenizer.__new__(CharTokenizer)
            t.vocab = d["vocab"]
            t._index = {c: i for i, c in enumerate(t.vocab)}
            return t
        if d["kind"] == "bpe":
            t = BpeTokenizer.__new__(BpeTokenizer)
            t.vocab = d["vocab"]
            t.merges = [tuple(m) for m in d["merges"]]
            t._index = {c: i for i, c in enumerate(t.vocab)}
            t._ranks = {tuple(m): i for i, m in enumerate(t.merges)}
            return t
        raise ValueError(f"unknown tokenizer kind {d['kind']}")


def _normalize(text: str) -> str:
    return " ".join(text.upper().split())


class CharTokenizer(Tokenizer):
    kind = "char"

    def __init__(self, corpus: list[str] | None = None, charset: str | None = None):
        if charset is None:
            chars = sorted(set("".join(_normalize(t) for t in (corpus or []))))
            if " " in chars:
                chars.remove(" ")
            charset = "".join(chars)
        # '_' denotes the word separator (space)
        self.vocab = SPECIALS + ["_"] + list(charset)
        self._index = {c: i for i, c in enumerate(self.vocab)}

    def _state(self):
        return {"vocab": self.vocab}

    def encode(self, text: str) -> list[int]:
        out = []
        for ch in _normalize(text):
            if ch == " ":
                out.append(self._index["_"])
            else:
                out.append(self._index.get(ch, UNK_ID))
        return out

    def decode(self, ids) -> str:
        toks = []
        for i in np.asarray(ids).tolist():
            if i < N_SPECIAL:
                continue
            toks.append(" " if self.vocab[i] == "_" else self.vocab[i])
        return "".join(toks).strip()


class BpeTokenizer(Tokenizer):
    """Byte-pair-encoding on words; '▁' marks word starts (SentencePiece style)."""

    kind = "bpe"

    def __init__(self, corpus: list[str], vocab_size: int = 256):
        words = Counter()
        for line in corpus:
            for w in _normalize(line).split():
                words["▁" + w] += 1
        # start from characters
        pieces = {tuple(w): c for w, c in words.items()}
        symbols = Counter()
        for w, c in pieces.items():
            for s in w:
                symbols[s] += c
        merges: list[tuple[str, str]] = []
        base_vocab = SPECIALS + sorted(symbols)
        while len(base_vocab) + len(merges) < vocab_size:
            pairs = Counter()
            for w, c in pieces.items():
                for a, b in zip(w, w[1:]):
                    pairs[(a, b)] += c
            if not pairs:
                break
            (a, b), cnt = pairs.most_common(1)[0]
            if cnt < 2:
                break
            merges.append((a, b))
            new_pieces = {}
            for w, c in pieces.items():
                out, i = [], 0
                while i < len(w):
                    if i + 1 < len(w) and w[i] == a and w[i + 1] == b:
                        out.append(a + b)
                        i += 2
                    else:
                        out.append(w[i])
                        i += 1
                new_pieces[tuple(out)] = c
            pieces = new_pieces
        merged_syms = sorted({a + b for a, b in merges})
        self.vocab = base_vocab + merged_syms
        self.merges = merges
        self._index = {c: i for i, c in enumerate(self.vocab)}
        self._ranks = {m: i for i, m in enumerate(self.merges)}

    def _state(self):
        return {"vocab": self.vocab, "merges": [list(m) for m in self.merges]}

    def _bpe_word(self, word: str) -> list[str]:
        pieces = list(word)
        while len(pieces) > 1:
            best, best_rank = None, None
            for i, (a, b) in enumerate(zip(pieces, pieces[1:])):
                r = self._ranks.get((a, b))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            pieces[best : best + 2] = [pieces[best] + pieces[best + 1]]
        return pieces

    def encode(self, text: str) -> list[int]:
        out = []
        for w in _normalize(text).split():
            for p in self._bpe_word("▁" + w):
                out.append(self._index.get(p, UNK_ID))
        return out

    def decode(self, ids) -> str:
        s = "".join(
            self.vocab[i] for i in np.asarray(ids).tolist() if i >= N_SPECIAL
        )
        return s.replace("▁", " ").strip()


def build_tokenizer(kind: str, corpus: list[str], vocab_size: int = 256) -> Tokenizer:
    if kind == "char":
        return CharTokenizer(corpus)
    if kind == "bpe":
        return BpeTokenizer(corpus, vocab_size=vocab_size)
    raise ValueError(f"unknown tokenizer kind {kind}")


def load_for_config(cfg) -> Tokenizer:
    """Resolve the tokenizer for a trained experiment.

    Order: explicit `data.tokenizer_path` -> the copy `cli/train.py` drops
    next to the checkpoints -> deterministic rebuild from the train
    manifest (CharTokenizer/BpeTokenizer construction is corpus-ordered and
    reproducible). Decode/transcribe CLIs use this so a config that never
    set `tokenizer_path` still round-trips train -> decode.
    """
    p = cfg.data.tokenizer_path
    if p and Path(p).is_file():
        return Tokenizer.load(p)
    ckpt_tok = Path(cfg.train.checkpoint_dir) / "tokenizer.json"
    if ckpt_tok.is_file():
        return Tokenizer.load(ckpt_tok)
    if cfg.data.train_manifest and Path(cfg.data.train_manifest).is_file():
        import sys

        from pytorch_end2end_speech_recognition_tpu_torch.data.manifest import (
            read_manifest,
        )

        print(
            "[tokenizer] WARNING: no saved tokenizer found "
            f"(data.tokenizer_path unset, no {ckpt_tok}); rebuilding from "
            f"{cfg.data.train_manifest}. If that manifest changed since "
            "training, the vocab may not match the checkpoint — transcripts "
            "would be garbage. Checkpoint meta carries a vocab hash; "
            "Solver.load_checkpoint raises on mismatch.",
            file=sys.stderr,
        )
        utts = read_manifest(cfg.data.train_manifest)
        return build_tokenizer(cfg.data.tokenizer,
                               [u.text for u in utts],
                               vocab_size=getattr(cfg.data,
                                                  "bpe_vocab_size", 256))
    raise FileNotFoundError(
        "no tokenizer: set data.tokenizer_path, or keep the tokenizer.json "
        f"saved by training under {cfg.train.checkpoint_dir}, or make the "
        "train manifest readable for a rebuild")
