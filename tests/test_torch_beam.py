"""The port's joint CTC/attention beam search (`decode/beam.py`) against the
JAX package's `BeamSearchDecoder` with the JAX weights bridged in, and
against the port's copy of the numpy oracle (`decode/oracle.py`): the cases
of the JAX package's `tests/test_beam.py` (CTC weight, LM fusion with both
LMs, coverage, both decoders) as one parametrised test, beam 1 as greedy
attention decoding, the prefix scorer's plain version against the CTC
forward, N-best order, the prefix kernels' plain versions against the
reference's full (B, K, C, T, 2) columns, the on-device early exit, and a
rung-4-shaped model (Conformer H8 with decoupled subsampling channels, a
transformer decoder, an RnnLm) serving and decoding against JAX. float32
on the CPU, inputs made with numpy from a seed. Tolerances: tokens exact,
scores within 1e-4 (float32 sums over ~30 frames in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_train_case as case_mod
from flax import nnx

from pytorch_end2end_speech_recognition_tpu.decode.beam import (
    BeamSearchDecoder as JBeam,
)
from pytorch_end2end_speech_recognition_tpu.models.asr import (
    AsrModel as JAsrModel,
)
from pytorch_end2end_speech_recognition_tpu.models.lm import (
    build_lm as jbuild_lm,
)
from pytorch_end2end_speech_recognition_tpu.ops.ctc import ctc_loss_xla
from pytorch_end2end_speech_recognition_tpu.utils.config import (
    AsrConfig as JAsrConfig,
)
from pytorch_end2end_speech_recognition_tpu.utils.config import (
    DecodeConfig as JDecodeConfig,
)
from pytorch_end2end_speech_recognition_tpu_torch import bridge
from pytorch_end2end_speech_recognition_tpu_torch.decode import beam as beam_mod
from pytorch_end2end_speech_recognition_tpu_torch.decode import oracle
from pytorch_end2end_speech_recognition_tpu_torch.decode.beam import (
    BeamSearchDecoder,
)
from pytorch_end2end_speech_recognition_tpu_torch.models.asr import AsrModel
from pytorch_end2end_speech_recognition_tpu_torch.models.lm import build_lm
from pytorch_end2end_speech_recognition_tpu_torch.ops import ctc_prefix
from pytorch_end2end_speech_recognition_tpu_torch.ops.ctc import ctc_loss
from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
    AsrConfig,
    DecodeConfig,
)

SCORE_TOL = 1e-4


def _bridged(jmodule) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in (
        bridge._convert(n, a) for n, a in case_mod.flat(jmodule).items())}


def _tiny(decoder: str = "lstm", vocab: int = 10):
    """The JAX package's tests/test_beam.py model in both packages: a
    1-layer BiLSTM d16, the LSTM speller or a 2-layer transformer decoder,
    vocab 10, float32, the port's weights bridged from the JAX model."""
    cfgs = []
    for c in (JAsrConfig(), AsrConfig()):
        m = c.model
        m.encoder, m.encoder_layers, m.encoder_dim = "blstm", 1, 16
        m.vocab_size, m.decoder = vocab, decoder
        m.decoder_layers = 2 if decoder == "transformer" else 1
        m.decoder_dim, m.decoder_heads, m.embed_dim = 16, 2, 8
        m.attention_dim, m.location_kernel, m.location_filters = 12, 5, 4
        m.ctc_weight, m.dtype = 0.3, "float32"
        c.frontend.spec_augment = False
        cfgs.append(c)
    jm = JAsrModel(cfgs[0], nnx.Rngs(0))
    tm = AsrModel(cfgs[1], device="cpu").eval()
    missing, unexpected = tm.load_state_dict(_bridged(jm), strict=False)
    assert not unexpected and all(k.startswith("frontend.") for k in missing)
    return jm, tm, cfgs


def _lm(cfgs, lm_type: str):
    for c in cfgs:
        m = c.model
        m.lm_type, m.lm_layers, m.lm_dim = lm_type, 1, 12
        m.lm_embed_dim, m.lm_heads = 8, 2
    jlm = jbuild_lm(cfgs[0].model, nnx.Rngs(1))
    tlm = build_lm(cfgs[1].model, device="cpu")
    tlm.load_state_dict(_bridged(jlm))
    return jlm, tlm


def _enc_and_logp(jm, rng, B=2, Ts=4800):
    """The JAX encoder's output and CTC log-probs on rows of Ts and Ts/2
    samples, as numpy (both decoders then search the same inputs)."""
    audio = jnp.asarray(rng.standard_normal((B, Ts)).astype(np.float32) * 0.1)
    audio_lens = jnp.asarray([Ts, Ts // 2], dtype=jnp.int32)[:B]
    enc, enc_lens = jm.encode(audio, audio_lens, train=False)
    logp = jax.nn.log_softmax(jm.ctc_logits(enc), axis=-1)
    return np.array(enc), np.array(enc_lens), np.array(logp)


def _port_search(tm, dcfg, enc, enc_lens, logp, max_len, lm=None, **kw):
    bsd = BeamSearchDecoder(tm, dcfg, lm=lm, **kw)
    return bsd.search_arrays(torch.from_numpy(enc), torch.from_numpy(enc_lens),
                             torch.from_numpy(logp), max_len)


def _nbest(out, b, n):
    toks = np.asarray(out["tokens"])[b]
    lens = np.asarray(out["lengths"])[b]
    scores = np.asarray(out["scores"])[b]
    return [(toks[k, :lens[k]].tolist(), float(scores[k])) for k in range(n)]


def _oracle_steps(tm, enc_b, enc_len, lm=None, max_len=16):
    """The port's decoder and LM steps for one utterance, numpy in and out."""
    T = enc_b.shape[0]
    enc1 = torch.from_numpy(enc_b)[None]
    with torch.no_grad():
        keys = tm.decoder.precompute(enc1)
    mask = (torch.arange(T) < enc_len)[None, :]

    @torch.no_grad()
    def att_step(token, state):
        if isinstance(state, str):
            state = tm.decoder.init_state(1, T, max_len)
        logp, new, attn = tm.decoder.step(torch.tensor([token]), state, keys,
                                          enc1, mask)
        return logp[0].numpy(), {k: v.clone() for k, v in new.items()}, \
            attn[0].numpy()

    if lm is None:
        return att_step, None

    @torch.no_grad()
    def lm_step(token, state):
        if isinstance(state, str):
            state = lm.init_state(1, max_len)
        logp, new = lm.step(torch.tensor([token]), state)
        return logp[0].numpy(), {k: v.clone() for k, v in new.items()}

    return att_step, lm_step


@pytest.mark.parametrize("ctc_w,lm_w,cov,decoder,lm_type", [
    (0.3, 0.0, 0.0, "lstm", "lstm"), (0.0, 0.0, 0.0, "lstm", "lstm"),
    (0.5, 0.2, 0.0, "lstm", "lstm"), (0.3, 0.0, 0.4, "lstm", "lstm"),
    (0.3, 0.0, 0.0, "transformer", "lstm"),
    (0.5, 0.2, 0.0, "transformer", "lstm"),
    (0.5, 0.2, 0.0, "lstm", "transformer")])
def test_beam_matches_jax_and_oracle(ctc_w, lm_w, cov, decoder, lm_type):
    """The JAX package's test_beam_matches_oracle cases: the port's N-best
    (beam 3, pre-beam 6, 6 steps) equals the JAX decoder's and the numpy
    oracle's (run on the port's decoder and LM steps) token for token, with
    scores within SCORE_TOL."""
    rng = np.random.default_rng(0)
    jm, tm, cfgs = _tiny(decoder)
    jlm = tlm = None
    if lm_w > 0:
        jlm, tlm = _lm(cfgs, lm_type)
    kw = dict(beam_size=3, ctc_weight=ctc_w, lm_weight=lm_w, pre_beam_k=6,
              nbest=3, coverage_penalty=cov)
    enc, enc_lens, logp = _enc_and_logp(jm, rng)
    max_len = 6
    ref = JBeam(jm, JDecodeConfig(**kw), lm=jlm).search_arrays(
        jnp.asarray(enc), jnp.asarray(enc_lens), jnp.asarray(logp), max_len)
    got = _port_search(tm, DecodeConfig(**kw), enc, enc_lens, logp, max_len,
                       lm=tlm)
    for key in ("tokens", "lengths", "finished"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(ref["scores"]),
                               rtol=0, atol=SCORE_TOL)
    for b in range(enc.shape[0]):
        att_step, lm_step = _oracle_steps(tm, enc[b], int(enc_lens[b]), tlm,
                                          max_len)
        want = oracle.beam_search_oracle(
            att_step, logp[b], int(enc_lens[b]), vocab_size=10, beam_size=3,
            ctc_weight=ctc_w, lm_step=lm_step, lm_weight=lm_w,
            coverage_penalty=cov, max_len=max_len, pre_beam_k=6, nbest=3)
        for (wt, ws), (gt, gs) in zip(want, _nbest(got, b, len(want))):
            assert wt == gt, (b, want)
            assert abs(ws - gs) < SCORE_TOL, (b, ws, gs)


def test_beam_size_one_attention_only_is_greedy():
    """beam 1 and ctc_w 0 give the stepwise argmax of the attention decoder
    (blank never emitted)."""
    rng = np.random.default_rng(0)
    jm, tm, _ = _tiny()
    enc, enc_lens, logp = _enc_and_logp(jm, rng, B=1)
    max_len = 5
    out = _port_search(tm, DecodeConfig(beam_size=1, ctc_weight=0.0,
                                        pre_beam_k=8, nbest=1),
                       enc, enc_lens, logp, max_len)
    T = enc.shape[1]
    e = torch.from_numpy(enc)
    mask = torch.arange(T)[None, :] < torch.from_numpy(enc_lens)[:, None]
    state = tm.decoder.init_state(1, T, max_len)
    tok, expected = torch.tensor([oracle.SOS_EOS_ID]), []
    with torch.no_grad():
        keys = tm.decoder.precompute(e)
        for _ in range(max_len):
            lp, state, _ = tm.decoder.step(tok, state, keys, e, mask)
            lp = lp[0].clone()
            lp[0] = -1e30
            nxt = int(lp.argmax())
            if nxt == oracle.SOS_EOS_ID:
                break
            expected.append(nxt)
            tok = torch.tensor([nxt])
    assert _nbest(out, 0, 1)[0][0] == expected


def test_prefix_scorer_matches_ctc_forward():
    """The prefix recursion's plain version, extending a prefix one label at
    a time: its full-sequence score log_add(r_n, r_b) at the last frame is
    the CTC log-likelihood of the labels, from the port's CTC loss and from
    `ctc_loss_xla` (within 1e-4), and psi of each extension is the
    oracle's."""
    rng = np.random.default_rng(4)
    T, V = 10, 6
    logits = rng.standard_normal((T, V)).astype(np.float32)
    lp = torch.log_softmax(torch.from_numpy(logits), -1)
    for labels in ([2, 3], [2, 2], [4, 5, 4]):
        r = torch.stack([torch.full((T,), ctc_prefix.NEG_INF),
                         torch.cumsum(lp[:, 0], 0)], -1)[None, None]
        sc = oracle.CtcPrefixScorerNp(lp.numpy(), T)
        state, last = sc.initial_state(), None
        for n, c in enumerate(labels):
            psi, cols = ctc_prefix.prefix_recursion_plain(
                lp[None], r, torch.tensor([[[c]]]),
                torch.tensor([[last if last is not None else 1]]),
                torch.tensor([[n]]), want_r=True)
            want_psi, state = sc.score(last, state, c)
            assert abs(float(psi) - want_psi) < 1e-4
            r, last = cols[:, :, 0], c
        full = float(ctc_prefix.log_add(r[0, 0, T - 1, 0], r[0, 0, T - 1, 1]))
        args = (torch.from_numpy(logits)[None], torch.tensor([T]),
                torch.tensor([labels]), torch.tensor([len(labels)]))
        assert abs(full + float(ctc_loss(*args)[0])) < 1e-4
        ll = -float(ctc_loss_xla(*(jnp.asarray(a.numpy()) for a in args))[0])
        assert abs(full - ll) < 1e-4


def test_beam_nbest_sorted_and_finished():
    rng = np.random.default_rng(0)
    jm, tm, _ = _tiny()
    enc, enc_lens, logp = _enc_and_logp(jm, rng)
    out = _port_search(tm, DecodeConfig(beam_size=4, ctc_weight=0.3,
                                        pre_beam_k=6, nbest=4),
                       enc, enc_lens, logp, 8)
    scores = out["scores"].numpy()
    assert (np.diff(scores, axis=1) <= 1e-6).all()
    lens = out["lengths"].numpy()
    assert (lens <= 8).all() and (lens > 0).any()
    fin = out["finished"].numpy()
    assert np.isfinite(scores[fin]).all()


def _random_beam_state(seed, B=2, K=3, C=4, T=9, V=7):
    g = torch.Generator().manual_seed(seed)
    lp = torch.log_softmax(torch.randn(B, T, V, generator=g), -1)
    lp[1, 6:] = ctc_prefix.NEG_INF     # row 1: 6 frames, the pad blank-certain
    lp[1, 6:, 0] = 0.0
    r = torch.randn(B, K, T, 2, generator=g).cumsum(2) - 3.0
    r[0, 2] = ctc_prefix.NEG_INF       # a dead hypothesis
    last = torch.randint(2, V, (B, K), generator=g)
    lengths = torch.randint(0, 3, (B, K), generator=g)
    last[lengths == 0] = 1
    cand = torch.stack([torch.randperm(V - 2, generator=g)[:C] + 2
                        for _ in range(B * K)]).reshape(B, K, C)
    cand[0, 0, 0] = last[0, 0]         # a candidate repeating the last token
    return lp, r, last, lengths, cand


def test_prefix_kernel_plain_versions_match_the_reference_columns():
    """`ctc_prefix_score` and `ctc_prefix_select` on CPU tensors (their
    plain versions; no launch counted) against the reference's way: every
    candidate's (T, 2) columns, psi from the same recursion, and the kept
    hypotheses' columns gathered by (parent, slot) where extended, the
    parent's otherwise. Bit for bit: the same arithmetic."""
    lp, r, last, lengths, cand = _random_beam_state(0)
    before = (ctc_prefix.ctc_prefix_score.launches,
              ctc_prefix.ctc_prefix_select.launches)
    psi = ctc_prefix.ctc_prefix_score(lp, r, last, lengths, cand)
    want_psi, cols = ctc_prefix.prefix_recursion_plain(lp, r, cand, last,
                                                       lengths, want_r=True)
    assert torch.equal(psi, want_psi)
    parent = torch.tensor([[2, 0, 0], [1, 1, 0]])
    slot = torch.tensor([[1, 3, 0], [0, 2, 1]])
    is_ext = torch.tensor([[True, False, True], [True, True, False]])
    tok = cand.gather(1, parent[..., None].expand(-1, -1, 4)).gather(
        2, slot[..., None])[..., 0]
    got = ctc_prefix.ctc_prefix_select(lp, r, last, lengths, parent, tok,
                                       is_ext)
    by_parent = lambda x: ctc_prefix._by_parent(x, parent)  # noqa: E731
    sel = by_parent(cols).gather(
        2, slot[:, :, None, None, None].expand(-1, -1, 1, 9, 2))[:, :, 0]
    want = torch.where(is_ext[..., None, None], sel, by_parent(r))
    assert torch.equal(got, want)
    assert (ctc_prefix.ctc_prefix_score.launches,
            ctc_prefix.ctc_prefix_select.launches) == before


def test_device_freeze_equals_early_exit(monkeypatch):
    """The loop tests 'all finished' on the host only every SYNC_EVERY
    steps and freezes the results on the device in between: every
    interval, and never (the loop runs to max_len), gives the N-best of the
    JAX decoder, whose while_loop stops when all hypotheses have finished
    (here at step 23 of 30)."""
    rng = np.random.default_rng(1)
    jm, tm, _ = _tiny()
    enc, enc_lens, logp = _enc_and_logp(jm, rng)
    kw = dict(beam_size=4, ctc_weight=0.3, pre_beam_k=6)
    ref = JBeam(jm, JDecodeConfig(**kw)).search_arrays(
        jnp.asarray(enc), jnp.asarray(enc_lens), jnp.asarray(logp), 30)
    assert np.asarray(ref["finished"]).all()
    for n, steps in ((1, 23), (5, 25), (100, 30)):
        monkeypatch.setattr(beam_mod, "SYNC_EVERY", n)
        out = _port_search(tm, DecodeConfig(**kw), enc, enc_lens, logp, 30)
        assert out["steps"] == steps
        for key in ("tokens", "lengths", "finished"):
            np.testing.assert_array_equal(out[key].numpy(),
                                          np.asarray(ref[key]), err_msg=key)
        np.testing.assert_allclose(out["scores"].numpy(),
                                   np.asarray(ref["scores"]), rtol=0,
                                   atol=SCORE_TOL)


def test_mesh_decode_is_refused():
    """Mesh decoding runs since the parallelism slice (its two-process
    check is tests/test_torch_multiproc.py); a mesh that is not the port's
    is refused."""
    _, tm, _ = _tiny()
    with pytest.raises(TypeError, match="make_mesh"):
        BeamSearchDecoder(tm, DecodeConfig(), mesh=object())


def test_rung4_shaped_model_serves_and_decodes_like_jax():
    """libri960_conformer at 2 layers and narrow widths, its shape kept:
    a Conformer with H8 and subsampling channels decoupled from d_model, a
    transformer decoder with H8, an RnnLm fused at lm_weight 0.3, beam 4.
    The serving logits (frontend to CTC) within 1e-4 relative + 1e-5 and
    the encoder lengths exact; each package's beam on its own encoder
    output gives the same N-best, scores within SCORE_TOL."""
    from pytorch_end2end_speech_recognition_tpu.configs import (
        presets as jpresets,
    )
    from pytorch_end2end_speech_recognition_tpu.utils.config import (
        resolve_platform,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.configs import presets

    cfgs = [resolve_platform(jpresets.libri960_conformer()),
            presets.libri960_conformer()]
    for c in cfgs:
        m = c.model
        m.encoder_layers, m.encoder_dim, m.encoder_ffn_dim = 2, 64, 128
        m.subsample_channels, m.encoder_heads = 16, 8
        m.decoder_layers, m.decoder_dim, m.decoder_heads = 2, 64, 8
        m.vocab_size, m.dtype, m.residual_dtype = 32, "float32", "float32"
        m.encoder_dropout = m.decoder_dropout = 0.0
        m.lm_layers, m.lm_dim, m.lm_embed_dim = 2, 24, 16
        c.decode.beam_size, c.decode.pre_beam_k = 4, 8
        c.frontend.spec_augment = False
    assert cfgs[1].model.lm_type == "lstm" and cfgs[1].decode.lm_weight == 0.3
    jm = JAsrModel(cfgs[0], nnx.Rngs(0))
    tm = AsrModel(cfgs[1], device="cpu").eval()
    missing, unexpected = tm.load_state_dict(_bridged(jm), strict=False)
    assert not unexpected and all(k.startswith("frontend.") for k in missing)
    with torch.no_grad():
        jm.encoder.rel.table[...] = jax.random.normal(
            jax.random.PRNGKey(2), jm.encoder.rel.table[...].shape)
        tm.encoder.rel.table.copy_(torch.from_numpy(
            np.array(jm.encoder.rel.table[...])))
    jlm = jbuild_lm(cfgs[0].model, nnx.Rngs(1))
    tlm = build_lm(cfgs[1].model, device="cpu")
    tlm.load_state_dict(_bridged(jlm))
    rng = np.random.default_rng(3)
    audio = (rng.standard_normal((2, 16000)) * 0.1).astype(np.float32)
    alens = np.asarray([16000, 11000], np.int32)
    audio[1, 11000:] = 0.0
    jb = JBeam(jm, cfgs[0].decode, lm=jlm)
    enc_j, lens_j, logp_j = jb._encode(jb.model_split[1], jnp.asarray(audio),
                                       jnp.asarray(alens))
    tb = BeamSearchDecoder(tm, cfgs[1].decode, lm=tlm)
    enc, lens, logp = tb.encode(torch.from_numpy(audio),
                                torch.from_numpy(alens))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(lens_j))
    np.testing.assert_allclose(logp.numpy(), np.asarray(logp_j), rtol=1e-4,
                               atol=1e-5)
    max_len = 5
    ref = jb.search_arrays(enc_j, lens_j, logp_j, max_len)
    got = tb.search_arrays(enc, lens, logp, max_len)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(ref["tokens"]))
    np.testing.assert_array_equal(got["lengths"].numpy(),
                                  np.asarray(ref["lengths"]))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(ref["scores"]),
                               rtol=0, atol=SCORE_TOL)
