"""Host-side reference beam search (slow, simple, obviously correct): the
port's copy of the JAX package's `decode/oracle.py`, numpy only.

The genre's Python-object beam, kept as the oracle of the batched
`decode/beam.py`. Scoring follows hybrid CTC/attention decoding (Watanabe
et al.):

    score(h) = ctc_w * psi_ctc(h) + (1-ctc_w) * logP_att(h)
               + lm_w * logP_lm(h) + len_penalty * |h|
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

NEG_INF = -1e30
SOS_EOS_ID = 1  # the tokenizers' shared <sos>/<eos> id (blank is 0)


def log_add(a, b):
    m = np.maximum(a, b)
    out = m + np.log(np.exp(a - m) + np.exp(b - m))
    return np.where(np.isfinite(m), out, m)


class CtcPrefixScorerNp:
    """Watanabe-style CTC prefix scorer over one utterance (numpy).

    State per prefix: r_n[t], r_b[t] — log prob of the prefix with paths
    ending at frame t in a non-blank / blank. `score(c)` returns
    psi(prefix + c) for every candidate c plus the new state.
    """

    def __init__(self, ctc_logp: np.ndarray, enc_len: int):
        # pad frames: blank certain, others impossible
        lp = np.full_like(ctc_logp, NEG_INF)
        lp[:enc_len] = ctc_logp[:enc_len]
        lp[enc_len:, 0] = 0.0
        self.lp = lp
        self.T = ctc_logp.shape[0]
        self.enc_len = enc_len

    def initial_state(self):
        r_n = np.full((self.T,), NEG_INF)
        r_b = np.zeros((self.T,))
        # empty prefix: r_b[t] = sum of blank logps up to t
        r_b = np.cumsum(self.lp[:, 0])
        return r_n, r_b

    def score(self, last: int | None, state, cand: int):
        """psi(prefix+cand) and new (r_n, r_b) for the extended prefix."""
        r_n, r_b = state
        T = self.T
        new_n = np.full((T,), NEG_INF)
        new_b = np.full((T,), NEG_INF)
        psi = NEG_INF
        for t in range(T):
            if t == 0:
                phi_prev = 0.0 if last is None else NEG_INF
                prev_n = NEG_INF
                prev_b = NEG_INF
            else:
                if last is not None and cand == last:
                    phi_prev = r_b[t - 1]
                else:
                    phi_prev = log_add(r_b[t - 1], r_n[t - 1])
                prev_n = new_n[t - 1]
                prev_b = new_b[t - 1]
            new_n[t] = log_add(prev_n, phi_prev) + self.lp[t, cand]
            new_b[t] = log_add(prev_b, prev_n) + self.lp[t, 0]
            psi = log_add(psi, phi_prev + self.lp[t, cand])
        return psi, (new_n, new_b)

    def final_score(self, state) -> float:
        """Full-sequence log prob of the current prefix (for eos)."""
        r_n, r_b = state
        return float(log_add(r_n[self.T - 1], r_b[self.T - 1]))


@dataclass
class Hyp:
    tokens: list = field(default_factory=list)
    att_score: float = 0.0
    ctc_score: float = 0.0
    lm_score: float = 0.0
    coverage: float = 0.0            # sum(min(cum_attn, tau))
    cum_attn: object = None
    ctc_state: object = None
    dec_state: object = None
    lm_state: object = None
    finished: bool = False

    def total(self, ctc_w, lm_w, len_penalty, cov_penalty=0.0):
        s = (1 - ctc_w) * self.att_score + ctc_w * self.ctc_score
        s += lm_w * self.lm_score
        s += len_penalty * len(self.tokens)
        s += cov_penalty * self.coverage
        return s


def beam_search_oracle(
    att_step,            # fn(token:int, dec_state) -> (logp (V,), new_state)
    ctc_logp: np.ndarray,  # (T, V)
    enc_len: int,
    vocab_size: int,
    beam_size: int = 5,
    ctc_weight: float = 0.3,
    lm_step=None,        # fn(token:int, lm_state) -> (logp (V,), new_state)
    lm_weight: float = 0.0,
    length_penalty: float = 0.0,
    coverage_penalty: float = 0.0,
    coverage_tau: float = 0.5,
    max_len: int = 40,
    min_len: int = 0,
    pre_beam_k: int | None = None,
    nbest: int = 1,
):
    """Returns n-best [(tokens, total_score)] by joint CTC/attention scoring."""
    scorer = CtcPrefixScorerNp(ctc_logp, enc_len) if ctc_weight > 0 else None
    init = Hyp(
        ctc_state=scorer.initial_state() if scorer else None,
        dec_state="INIT",
        lm_state="INIT",
    )
    beams = [init]
    # Semantics mirror decode/beam.py exactly: finished hyps stay in the beam
    # with frozen scores and compete in top-K; loop ends when all K finished.
    for step in range(max_len):
        cands: list[Hyp] = []
        for hyp in beams:
            if hyp.finished:
                cands.append(hyp)
                continue
            last = hyp.tokens[-1] if hyp.tokens else SOS_EOS_ID
            stepped = att_step(last, hyp.dec_state)
            if len(stepped) == 3:
                att_logp, dec_state, attn = stepped
            else:
                att_logp, dec_state = stepped
                attn = None
            cum_attn = hyp.cum_attn
            coverage = hyp.coverage
            if attn is not None and coverage_penalty != 0.0:
                cum_attn = (np.asarray(attn) if cum_attn is None
                            else cum_attn + np.asarray(attn))
                coverage = float(np.minimum(cum_attn, coverage_tau).sum())
            if lm_step is not None:
                lm_logp, lm_state = lm_step(last, hyp.lm_state)
            else:
                lm_logp, lm_state = np.zeros(vocab_size), None
            # pre-beam: top candidates by (1-ctc_w)*att + lm_w*lm,
            # never blank or eos (eos scored separately below)
            pre = (1 - ctc_weight) * att_logp + lm_weight * lm_logp
            order = np.argsort(-pre, kind="stable")
            cand_ids = [c for c in order if c not in (0, SOS_EOS_ID)][
                : (pre_beam_k or vocab_size)
            ]
            for c in cand_ids:
                if scorer:
                    lastc = hyp.tokens[-1] if hyp.tokens else None
                    psi, cstate = scorer.score(lastc, hyp.ctc_state, c)
                else:
                    psi, cstate = 0.0, None
                cands.append(Hyp(
                    tokens=hyp.tokens + [int(c)],
                    att_score=hyp.att_score + float(att_logp[c]),
                    ctc_score=float(psi),
                    lm_score=hyp.lm_score + float(lm_logp[c]),
                    coverage=coverage,
                    cum_attn=cum_attn,
                    ctc_state=cstate,
                    dec_state=dec_state,
                    lm_state=lm_state,
                ))
            if step >= min_len:
                ctc_s = (
                    scorer.final_score(hyp.ctc_state) if scorer
                    else hyp.ctc_score
                )
                cands.append(Hyp(
                    tokens=list(hyp.tokens),
                    att_score=hyp.att_score + float(att_logp[SOS_EOS_ID]),
                    ctc_score=ctc_s,
                    lm_score=hyp.lm_score + float(lm_logp[SOS_EOS_ID]),
                    coverage=coverage,
                    finished=True,
                ))
        cands.sort(
            key=lambda h: -h.total(ctc_weight, lm_weight, length_penalty,
                                   coverage_penalty)
        )
        beams = cands[:beam_size]
        if all(h.finished for h in beams):
            break
    beams.sort(key=lambda h: -h.total(ctc_weight, lm_weight, length_penalty,
                                      coverage_penalty))
    return [
        (h.tokens, h.total(ctc_weight, lm_weight, length_penalty,
                           coverage_penalty))
        for h in beams[:nbest]
    ]
