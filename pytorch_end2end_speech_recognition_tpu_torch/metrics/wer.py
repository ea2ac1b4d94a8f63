"""Edit-distance scoring: WER / CER (the port's copy of the JAX package's
`metrics/wer.py`). The distance is the C++ scorer's (`native/`), or with
`ASR_TPU_NO_NATIVE` set a vectorized numpy DP over the hypothesis.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from pytorch_end2end_speech_recognition_tpu_torch import native


def edit_distance(ref: list, hyp: list) -> int:
    """Levenshtein distance between token sequences."""
    if native.enabled():
        return native.levenshtein(ref, hyp)
    return edit_distance_np(ref, hyp)


def edit_distance_np(ref: list, hyp: list) -> int:
    """`edit_distance` in numpy."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    if m == 0:
        return n
    # map tokens to int ids for vectorized comparison
    sym = {t: i for i, t in enumerate(dict.fromkeys(list(ref) + list(hyp)))}
    ref_a = np.asarray([sym[t] for t in ref])
    hyp_a = np.asarray([sym[t] for t in hyp])
    prev = np.arange(m + 1, dtype=np.int64)
    pos = np.arange(m + 1, dtype=np.int64)
    for i in range(1, n + 1):
        base = np.minimum(prev[:-1] + (hyp_a != ref_a[i - 1]), prev[1:] + 1)
        # insertion: cur[j] = min_{k<=j}(vals[k] + (j-k)) — prefix-min scan
        vals = np.concatenate(([i], base))
        cur = np.minimum.accumulate(vals - pos) + pos
        prev = cur
    return int(prev[m])


@dataclass
class ErrorStats:
    errors: int = 0
    tokens: int = 0
    sentences: int = 0
    wrong_sentences: int = 0

    @property
    def rate(self) -> float:
        return self.errors / max(self.tokens, 1)

    @property
    def ser(self) -> float:
        return self.wrong_sentences / max(self.sentences, 1)

    def update(self, ref: list, hyp: list) -> None:
        d = edit_distance(ref, hyp)
        self.errors += d
        self.tokens += len(ref)
        self.sentences += 1
        self.wrong_sentences += int(d > 0)


def wer(refs: list[str], hyps: list[str]) -> float:
    s = ErrorStats()
    for r, h in zip(refs, hyps):
        s.update(r.split(), h.split())
    return s.rate


def cer(refs: list[str], hyps: list[str]) -> float:
    s = ErrorStats()
    for r, h in zip(refs, hyps):
        s.update(list(r.replace(" ", "")), list(h.replace(" ", "")))
    return s.rate
