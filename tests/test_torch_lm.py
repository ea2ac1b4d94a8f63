"""The port's language models (`models/lm.py`: `RnnLm`, `TransformerLm`,
`lm_loss`) and the transformer decoder's beam interface
(`precompute`/`init_state`/`step`) against the JAX package's, with the JAX
weights bridged in: the teacher-forced log-probs, every incremental step
(both `per_row_pos` modes, the caches written in place), and the loss.
float32 on the CPU, inputs made with numpy from a seed. Tolerance: 1e-5
relative + 1e-5 absolute on log-probs (float32 products in another order);
the step against the port's own teacher-forced pass 1e-4, as the JAX
package's test_step_matches_teacher_forced states."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_train_case as case_mod
from flax import nnx

from pytorch_end2end_speech_recognition_tpu.models import (
    decoder_transformer as jdec,
)
from pytorch_end2end_speech_recognition_tpu.models import lm as jlm
from pytorch_end2end_speech_recognition_tpu.utils.config import (
    ModelConfig as JModelConfig,
)
from pytorch_end2end_speech_recognition_tpu_torch import bridge
from pytorch_end2end_speech_recognition_tpu_torch.models import (
    decoder_transformer as tdec,
)
from pytorch_end2end_speech_recognition_tpu_torch.models import lm as tlm
from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
    ModelConfig,
)

V = 13
RTOL = ATOL = 1e-5


def _bridged(jmodule) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in (
        bridge._convert(n, a) for n, a in case_mod.flat(jmodule).items())}


def _lms(kind: str):
    kw = dict(vocab_size=V, lm_type=kind, lm_layers=2, lm_dim=16,
              lm_embed_dim=8, lm_heads=2, lm_ffn_dim=24)
    j = jlm.build_lm(JModelConfig(**kw), nnx.Rngs(3))
    t = tlm.build_lm(ModelConfig(**kw), device="cpu")
    t.load_state_dict(_bridged(j))
    return j, t


def _tokens(seed=0, B=3, U=7):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(2, V, (B, U)).astype(np.int32)
    lens = np.asarray([7, 4, 0], np.int32)[:B]
    return tokens * (np.arange(U)[None, :] < lens[:, None]), lens


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("kind", ["lstm", "transformer"])
def test_lm_forward_and_loss_match_jax(kind):
    """Teacher-forced log-probs (B, U+1, V) and lm_loss (mean NLL over the
    tokens and eos, and the count), a row without tokens included."""
    j, t = _lms(kind)
    tokens, lens = _tokens()
    want = j(jnp.asarray(tokens), jnp.asarray(lens))
    with torch.no_grad():
        got = t(torch.from_numpy(tokens), torch.from_numpy(lens))
        loss, count = tlm.lm_loss(t, torch.from_numpy(tokens),
                                  torch.from_numpy(lens))
    assert got.shape == (3, 8, V)
    _close(got, want)
    jloss, jcount = jlm.lm_loss(j, jnp.asarray(tokens), jnp.asarray(lens))
    assert int(count) == int(jcount) == 7 + 4 + 0 + 3
    assert float(loss) == pytest.approx(float(jloss), rel=1e-6)


@pytest.mark.parametrize("kind", ["lstm", "transformer"])
def test_lm_step_matches_jax_and_teacher_forcing(kind):
    """`step` from `init_state`, fed [sos, tokens] one at a time: each
    step's log-probs equal the JAX step's and the teacher-forced pass's
    column, and the state equals JAX's (the transformer's caches written in
    place at each step's position)."""
    j, t = _lms(kind)
    tokens, lens = _tokens(1)
    B, U = tokens.shape
    inputs = np.concatenate([np.ones((B, 1), np.int32), tokens], 1)
    with torch.no_grad():
        full = t(torch.from_numpy(tokens), torch.from_numpy(lens))
    js, ts = j.init_state(B, U + 1), t.init_state(B, U + 1)
    for u in range(U + 1):
        jl, js = j.step(jnp.asarray(inputs[:, u]), js)
        with torch.no_grad():
            tl, ts = t.step(torch.from_numpy(inputs[:, u]), ts)
        _close(tl, jl)
        _close(tl, full[:, u], rtol=1e-4, atol=1e-4)
        for name, val in js.items():
            _close(ts[name].float(), np.asarray(val, np.float32))


def test_transformer_lm_per_row_positions():
    """`per_row_pos`: rows at different positions (one row stepped twice
    before the others start) give each row's own prefix's log-probs, as the
    JAX step does."""
    j, t = _lms("transformer")
    B, U = 3, 6
    js, ts = j.init_state(B, U), t.init_state(B, U)
    js["pos"] = jnp.asarray([2, 0, 1], jnp.int32)
    ts["pos"] = torch.tensor([2, 0, 1])
    for tok in ([4, 5, 6], [7, 8, 9]):
        jl, js = j.step(jnp.asarray(tok, jnp.int32), js, per_row_pos=True)
        with torch.no_grad():
            tl, ts = t.step(torch.tensor(tok), ts, per_row_pos=True)
        _close(tl, jl)
    for name, val in js.items():
        _close(ts[name].float(), np.asarray(val, np.float32))


KW = dict(decoder="transformer", decoder_layers=2, decoder_dim=32,
          decoder_heads=4, decoder_ffn_dim=48, vocab_size=V, dtype="float32")


def _decoders(d_enc=20):
    jd = jdec.TransformerDecoder(d_enc, JModelConfig(**KW), nnx.Rngs(0))
    td = tdec.TransformerDecoder(d_enc, ModelConfig(**KW))
    td.load_state_dict(_bridged(jd))
    rng = np.random.default_rng(5)
    enc = rng.standard_normal((3, 11, d_enc)).astype(np.float32)
    enc_lens = np.asarray([11, 6, 1], np.int32)
    return jd, td, enc, enc_lens


@pytest.mark.parametrize("per_row_pos", [False, True])
def test_decoder_step_matches_jax_and_teacher_forcing(per_row_pos):
    """The transformer decoder's `step` (both modes, all rows in lockstep),
    fed [sos, tokens]: log-probs and the cross-attention row against the
    JAX step, log-probs against the port's teacher-forced pass, and the
    caches and positions against JAX's after every step."""
    jd, td, enc, enc_lens = _decoders()
    tokens, lens = _tokens(2)
    B, U = tokens.shape
    inputs = np.concatenate([np.ones((B, 1), np.int32), tokens], 1)
    T = enc.shape[1]
    e, el = torch.from_numpy(enc), torch.from_numpy(enc_lens)
    with torch.no_grad():
        full = td(e, el, torch.from_numpy(tokens))
        keys = td.precompute(e)
    jkeys = jd.precompute(jnp.asarray(enc))
    _close(keys, jkeys)
    mask = torch.arange(T)[None, :] < el[:, None]
    jmask = jnp.asarray(mask.numpy())
    js, ts = jd.init_state(B, T, U + 1), td.init_state(B, T, U + 1)
    for u in range(U + 1):
        jl, js, ja = jd.step(jnp.asarray(inputs[:, u]), js, jkeys,
                             jnp.asarray(enc), jmask, per_row_pos=per_row_pos)
        with torch.no_grad():
            tl, ts, ta = td.step(torch.from_numpy(inputs[:, u]), ts, keys, e,
                                 mask, per_row_pos=per_row_pos)
        _close(tl, jl)
        _close(ta, ja)
        _close(tl, full[:, u], rtol=1e-4, atol=1e-4)
        for name, val in js.items():
            _close(ts[name].float(), np.asarray(val, np.float32))


def test_decoder_step_per_row_positions_and_grouped_keys():
    """Rows out of lockstep (`per_row_pos`, positions 3, 0, 1) against the
    JAX step; and the beam's grouped form, G = 2 hypothesis rows on each
    utterance's keys and mask, equal to the same rows with the keys
    repeated."""
    jd, td, enc, enc_lens = _decoders()
    T = enc.shape[1]
    e, el = torch.from_numpy(enc), torch.from_numpy(enc_lens)
    with torch.no_grad():
        keys = td.precompute(e)
    mask = torch.arange(T)[None, :] < el[:, None]
    js = jd.init_state(3, T, 6)
    ts = td.init_state(3, T, 6)
    js["pos"] = jnp.asarray([3, 0, 1], jnp.int32)
    ts["pos"] = torch.tensor([3, 0, 1])
    for tok in ([4, 5, 6], [7, 8, 9]):
        jl, js, ja = jd.step(jnp.asarray(tok, jnp.int32), js,
                             jd.precompute(jnp.asarray(enc)), jnp.asarray(enc),
                             jnp.asarray(mask.numpy()), per_row_pos=True)
        with torch.no_grad():
            tl, ts, ta = td.step(torch.tensor(tok), ts, keys, e, mask,
                                 per_row_pos=True)
        _close(tl, jl)
        _close(ta, ja)
    tok = torch.tensor([4, 9, 5, 5, 11, 2])
    with torch.no_grad():
        gl, gs, ga = td.step(tok, td.init_state(6, T, 4), keys, e, mask)
        rl, rs, ra = td.step(tok, td.init_state(6, T, 4),
                             keys.repeat_interleave(2, 0),
                             e.repeat_interleave(2, 0),
                             mask.repeat_interleave(2, 0))
    _close(gl, rl.numpy(), rtol=1e-6, atol=1e-6)
    _close(ga, ra.numpy(), rtol=1e-6, atol=1e-6)
    assert torch.equal(gs["k_cache"], rs["k_cache"])


def test_pe_table_is_the_reference_table_at_every_length():
    """The decoders' device PE table: the reference's sinusoidal table at
    each length asked for, bit for bit, whether it is sliced from a longer
    table built before or rebuilt for a longer request; `init_state`
    builds it, so the token steps only read it."""
    from pytorch_end2end_speech_recognition_tpu_torch.models import encoders

    cpu = torch.device("cpu")
    encoders._PE_TABLES.pop((22, cpu), None)
    for T in (40, 7, 90, 13):
        np.testing.assert_array_equal(encoders.pe_table(T, 22, cpu).numpy(),
                                      jdec.sinusoidal_pe(T, 22))
    assert encoders._PE_TABLES[(22, cpu)].shape == (90, 22)
    td = _decoders()[1]
    td.init_state(2, 5, 1234, device=cpu)
    assert encoders._PE_TABLES[(td.D, cpu)].shape[0] >= 1234
