"""The port's chunk-synchronized streaming beam (`decode/chunk_beam.py`,
`StreamingBeamTranscriber`) against the JAX package's, with the JAX weights
bridged in (the tiny model of `tests/test_torch_beam.py`: a 1-layer BiLSTM
d16, the LSTM speller or a 2-layer transformer decoder, vocab 10), float32
on the CPU, inputs made with numpy from a seed.

Both decoders are fed the same chunks of the JAX encoder's output. Its CTC
log-probs are the JAX CTC head's with an emission script added before the
log-softmax (blank favoured, one token spiked every 12 frames), so that a
token's evidence arrives in one chunk and not another: the beam then both
WAITS (no evidence yet) and EXTENDS mid-stream, and each case asserts that
it did both. Tolerances: tokens, lengths and finished flags exact; scores,
totals, the lattice window `r_win` and the log-prob window `lp_win` within
1e-4 (float32 sums over the window in another order)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_beam import _lm, _tiny

from pytorch_end2end_speech_recognition_tpu.data.tokenizer import (
    CharTokenizer as JCharTokenizer,
)
from pytorch_end2end_speech_recognition_tpu.decode.chunk_beam import (
    ChunkBeamDecoder as JChunkBeam,
)
from pytorch_end2end_speech_recognition_tpu.models.streaming import (
    StreamingBeamTranscriber as JStreamingBeam,
)
from pytorch_end2end_speech_recognition_tpu.utils.config import (
    DecodeConfig as JDecodeConfig,
)
from pytorch_end2end_speech_recognition_tpu_torch.data.tokenizer import (
    CharTokenizer,
)
from pytorch_end2end_speech_recognition_tpu_torch.decode.chunk_beam import (
    ChunkBeamDecoder,
)
from pytorch_end2end_speech_recognition_tpu_torch.models.streaming import (
    StreamingBeamTranscriber,
)
from pytorch_end2end_speech_recognition_tpu_torch.ops import ctc_prefix as cp
from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
    DecodeConfig,
)

TOL = 1e-4
C, W, S, U = 8, 24, 6, 24       # chunk, window, steps per chunk, max tokens
GAP = 12                        # frames between the script's token spikes


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tensors here are tiny: torch's intra-op thread pool only adds
    overhead to each of their many small ops (7x on a loaded host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# (ctc_weight, lm, lm_weight, coverage, length penalty, decoder, B, tau):
# tau is set per case so that the beam both waits and extends (a positive
# length penalty or no CTC moves the balance)
CASES = {
    "ctc0.3": (0.3, None, 0.0, 0.0, 0.0, "lstm", 1, -2.5),
    "ctc0": (0.0, None, 0.0, 0.0, 0.0, "lstm", 1, -2.2),
    "rnnlm_b2": (0.5, "lstm", 0.2, 0.0, 0.0, "transformer", 2, -2.5),
    "translm": (0.5, "transformer", 0.2, 0.0, 0.0, "transformer", 1, -2.5),
    "coverage": (0.3, None, 0.0, 0.4, 0.0, "lstm", 1, -2.5),
    "lenpen": (0.3, None, 0.0, 0.0, 0.5, "transformer", 1, -1.5),
}


@functools.lru_cache(maxsize=None)
def _setup(case: str):
    """(JAX decoder, port decoder, enc (B, T, D), logp (B, T, V), row
    lengths) for one case; the JAX decoder compiles once per case."""
    ctc_w, lm_type, lm_w, cov, lp, decoder, B, tau = CASES[case]
    jm, tm, cfgs = _tiny(decoder)
    jlm = tlm = None
    if lm_type is not None:
        jlm, tlm = _lm(cfgs, lm_type)
        tlm.eval()
    kw = dict(beam_size=4, pre_beam_k=5, ctc_weight=ctc_w, lm_weight=lm_w,
              coverage_penalty=cov, length_penalty=lp, nbest=4)
    ck = dict(chunk_frames=C, window_frames=W, steps_per_chunk=S,
              max_tokens=U, wait_threshold=tau)
    jcb = JChunkBeam(jm, JDecodeConfig(mode="beam", **kw), lm=jlm, **ck)
    tcb = ChunkBeamDecoder(tm, DecodeConfig(mode="beam", **kw), lm=tlm, **ck)
    rng = np.random.default_rng(0)
    lens = np.asarray([16000, 11000][:B], np.int32)
    audio = rng.standard_normal((B, 16000)).astype(np.float32) * 0.1
    audio[1:, 11000:] = 0.0
    enc, enc_lens = jm.encode(jnp.asarray(audio), jnp.asarray(lens),
                              train=False)
    logits = np.asarray(jm.ctc_logits(enc))
    script = np.zeros_like(logits)
    script[..., 0] = 4.0
    spikes = np.random.default_rng(1)
    for b in range(B):
        for t in range(5 + 3 * b, logits.shape[1], GAP):
            script[b, t, 0] = 0.0
            script[b, t, spikes.integers(2, logits.shape[-1])] = 8.0
    z = logits + script
    logp = z - np.log(np.exp(z - z.max(-1, keepdims=True)).sum(
        -1, keepdims=True)) - z.max(-1, keepdims=True)
    return jcb, tcb, np.asarray(enc), logp.astype(np.float32), \
        np.asarray(enc_lens)


def _feeds(enc, logp, lens, T_use=None):
    """(enc chunk, logp chunk, chunk_len, final) for each feed: C frames a
    feed up to the longest row; the last feed is final and holds the rest
    (0 frames when T_use is a multiple of C)."""
    B, T, D = enc.shape
    T = T if T_use is None else T_use
    starts = list(range(0, T, C))
    if T % C == 0:
        starts.append(T)
    out = []
    for s in starts:
        e = np.zeros((B, C, D), np.float32)
        lp = np.zeros((B, C, logp.shape[2]), np.float32)
        n = np.clip(np.minimum(lens, T) - s, 0, C).astype(np.int32)
        for b in range(B):
            e[b, :n[b]] = enc[b, s:s + n[b]]
            lp[b, :n[b]] = logp[b, s:s + n[b]]
        out.append((e, lp, n, s + C >= T))
    return out


def _run_both(jcb, tcb, feeds, min_tokens, check_each=True):
    """Feed both decoders; after every feed compare the beams (and the
    carries' totals, lattice and log-prob windows). Returns the port's
    beams and whether some hypothesis waited and some extended mid-stream."""
    B = feeds[0][0].shape[0]
    jc, tc = jcb.init(B), tcb.init(B)
    beams, prev = [], None
    waited = extended = False
    for e, lp, n, final in feeds:
        mt = np.asarray(min_tokens if final else [0] * B, np.int32)
        jc, jb = jcb.feed(jc, jnp.asarray(e), jnp.asarray(lp), n,
                          final=final, min_tokens=mt)
        tc, tb = tcb.feed(tc, torch.from_numpy(e), torch.from_numpy(lp),
                          torch.from_numpy(n).long(), final=final,
                          min_tokens=torch.from_numpy(mt).long())
        if check_each or final:
            for key in ("tokens", "lengths", "finished"):
                np.testing.assert_array_equal(tb[key].numpy(),
                                              np.asarray(jb[key]),
                                              err_msg=key)
            np.testing.assert_allclose(tb["scores"].numpy(),
                                       np.asarray(jb["scores"]), rtol=0,
                                       atol=TOL)
            for key in ("total", "r_win", "lp_win"):
                np.testing.assert_allclose(tc[key].numpy(),
                                           np.asarray(jc[key]), rtol=0,
                                           atol=TOL, err_msg=key)
        toks, lens_, scores = (tb["tokens"].numpy(), tb["lengths"].numpy(),
                               tb["scores"].numpy())
        if prev is not None and not final:
            for b in range(B):
                live = scores[b] > -1e29
                now = {tuple(toks[b, k, :lens_[b, k]])
                       for k in range(toks.shape[1]) if live[k]}
                old = prev[b]
                waited |= bool(now & old)
                extended |= max(map(len, now)) > max(map(len, old))
        prev = [{tuple(toks[b, k, :lens_[b, k]])
                 for k in range(toks.shape[1]) if scores[b, k] > -1e29}
                for b in range(B)]
        beams.append(tb)
    return beams, tc, waited, extended


@pytest.mark.parametrize("case", list(CASES))
def test_chunk_beam_matches_jax(case):
    """After every feed: tokens, lengths and finished flags exact; scores,
    totals, r_win and lp_win within 1e-4; some hypothesis waited and some
    extended mid-stream."""
    jcb, tcb, enc, logp, lens = _setup(case)
    feeds = _feeds(enc, logp, lens)
    _, _, waited, extended = _run_both(jcb, tcb, feeds,
                                       [3] * enc.shape[0])
    assert waited and extended, (waited, extended)


def test_zero_frame_final_block_and_min_tokens():
    """A stream whose frames fill whole chunks ends with a final block of 0
    valid frames, which still resolves EOS; min_tokens holds every finished
    hypothesis to at least that many tokens. Equal to JAX."""
    jcb, tcb, enc, logp, lens = _setup("ctc0.3")
    T_use = (enc.shape[1] // C) * C
    feeds = _feeds(enc, logp, lens, T_use=T_use)
    assert int(feeds[-1][2][0]) == 0 and feeds[-1][3]
    beams, _, _, _ = _run_both(jcb, tcb, feeds, [7], check_each=False)
    last = beams[-1]
    fin = last["finished"][0].numpy()
    assert fin.any()
    assert (last["lengths"][0].numpy()[fin] >= 7).all()


def test_b2_rows_equal_two_b1_runs():
    """Each row of a B=2 beam equals that row run alone (B=1)."""
    _, tcb, enc, logp, lens = _setup("rnnlm_b2")
    both = _feeds(enc, logp, lens)
    c2 = tcb.init(2)
    outs2 = []
    for e, lp, n, final in both:
        c2, b2 = tcb.feed(c2, torch.from_numpy(e), torch.from_numpy(lp),
                          torch.from_numpy(n).long(), final=final,
                          min_tokens=torch.tensor([3, 3]))
        outs2.append(b2)
    for row in range(2):
        c1 = tcb.init(1)
        for (e, lp, n, final), b2 in zip(both, outs2):
            c1, b1 = tcb.feed(c1, torch.from_numpy(e[row:row + 1]),
                              torch.from_numpy(lp[row:row + 1]),
                              torch.from_numpy(n[row:row + 1]).long(),
                              final=final, min_tokens=torch.tensor([3]))
            for key in ("tokens", "lengths", "finished"):
                assert torch.equal(b1[key][0], b2[key][row]), (row, key)
            torch.testing.assert_close(b1["scores"][0], b2["scores"][row],
                                       rtol=0, atol=TOL)


def _shapes(carry):
    out = {}
    for k, v in carry.items():
        if isinstance(v, dict):
            out.update({f"{k}.{n}": (tuple(t.shape), t.dtype)
                        for n, t in v.items()})
        elif v is not None:
            out[k] = (tuple(v.shape), v.dtype)
    return out


def test_carry_is_bounded_and_drops_the_dead_column():
    """The carry's sizes are the same after every feed (decoder and LM
    state included), and its keys are the reference's but `r_prevcol`,
    which the reference carries and never reads."""
    jcb, tcb, enc, logp, lens = _setup("translm")
    carry = tcb.init(1)
    want = _shapes(carry)
    for e, lp, n, final in _feeds(enc, logp, lens):
        carry, _ = tcb.feed(carry, torch.from_numpy(e), torch.from_numpy(lp),
                            torch.from_numpy(n).long(), final=final)
        assert _shapes(carry) == want
    assert set(jcb.init(1)) - set(carry) == {"r_prevcol"}
    assert set(carry) <= set(jcb.init(1))


def test_streaming_beam_transcriber_matches_jax():
    """StreamingBeamTranscriber end to end on the tiny hybrid model (BiLSTM,
    LSTM speller), fed 0.3 s pieces of a 2.4 s stream: after every feed the
    greedy and the beam partial text equal JAX's (the beam partial is the
    greedy one until the first beam advance, in both), and the final
    N-best's texts, tokens and scores."""
    jm, tm, _ = _tiny("lstm")
    jtok, ttok = JCharTokenizer(charset="abcdef"), CharTokenizer(
        charset="abcdef")
    assert ttok.vocab_size == 10
    kw = dict(beam_size=4, pre_beam_k=5, ctc_weight=0.3, nbest=3)
    sk = dict(chunk_s=1.0, overlap_s=0.5, chunk_frames=32, window_frames=64,
              max_tokens=16, steps_per_chunk=6, wait_threshold=-2.5)
    js = JStreamingBeam(jm, jtok, JDecodeConfig(mode="beam", **kw), **sk)
    ts = StreamingBeamTranscriber(tm, ttok, DecodeConfig(mode="beam", **kw),
                                  **sk)
    audio = (np.random.default_rng(3).standard_normal(38400) * 0.1).astype(
        np.float32)
    pieces = [audio[i:i + 4800] for i in range(0, len(audio), 4800)]
    jst, tst = js.init_stream(), ts.init_stream()
    advanced = 0
    for i, p in enumerate(pieces):
        final = i == len(pieces) - 1
        jst = js.feed(jst, p, final=final)
        tst = ts.feed(tst, p, final=final)
        assert ts.partial_text(tst) == js.partial_text(jst)
        assert ts.partial_text(tst, beam=True) == js.partial_text(
            jst, beam=True)
        advanced += tst.beam is not None
    assert 0 < advanced < len(pieces)
    want, got = js.final_nbest(jst), ts.final_nbest(tst)
    assert [g["tokens"] for g in got] == [w["tokens"] for w in want]
    assert [g["text"] for g in got] == [w["text"] for w in want]
    np.testing.assert_allclose([g["score"] for g in got],
                               [w["score"] for w in want], rtol=0, atol=TOL)


def test_prefix_plain_versions_without_r_init_unchanged():
    """With r_init absent, the prefix plain versions give the same bits as
    the full-pass beam's pre-window column passed explicitly ((NEG_INF, 0)
    for the empty prefix, else (NEG_INF, NEG_INF)); a non-trivial r_init
    changes psi and the columns."""
    g = torch.Generator().manual_seed(0)
    B, T, V, K, Cn = 2, 20, 9, 3, 4
    lp = torch.log_softmax(torch.randn(B, T, V, generator=g) * 3, -1)
    r = torch.log_softmax(torch.randn(B, K, T, 2, generator=g), -1) - 2.0
    last = torch.randint(2, V, (B, K), generator=g)
    lengths = torch.tensor([[0, 1, 3], [2, 0, 1]])
    last = torch.where(lengths == 0, 1, last)
    cand = torch.randint(2, V, (B, K, Cn), generator=g)
    cand[:, :, 0] = last
    parent = torch.randint(0, K, (B, K), generator=g)
    tok = torch.randint(2, V, (B, K), generator=g)
    is_ext = torch.tensor([[True, False, True], [True, True, False]])
    neg = torch.full((B, K), cp.NEG_INF)
    default = torch.stack([neg, torch.where(lengths == 0, 0.0, neg)], -1)
    psi0, cols0 = cp.prefix_recursion_plain(lp, r, cand, last, lengths,
                                            want_r=True)
    psi1, cols1 = cp.prefix_recursion_plain(lp, r, cand, last, lengths,
                                            want_r=True, r_init=default)
    assert torch.equal(psi0, psi1) and torch.equal(cols0, cols1)
    sel0 = cp.prefix_select_plain(lp, r, last, lengths, parent, tok, is_ext)
    sel1 = cp.prefix_select_plain(lp, r, last, lengths, parent, tok, is_ext,
                                  r_init=default)
    assert torch.equal(sel0, sel1)
    other = torch.log_softmax(torch.randn(B, K, 2, generator=g), -1)
    psi2 = cp.ctc_prefix_score(lp, r, last, lengths, cand, r_init=other)
    assert not torch.allclose(psi2, psi0)
    sel2 = cp.ctc_prefix_select(lp, r, last, lengths, parent, tok, is_ext,
                                r_init=other)
    assert not torch.equal(sel2[is_ext], sel0[is_ext])
    assert torch.equal(sel2[~is_ext], sel0[~is_ext])
