"""The port's transformer decoder (teacher-forced pass) and its losses against
the JAX package's, with the JAX weights bridged in. float32 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from pytorch_end2end_speech_recognition_tpu.models import (
    decoder_transformer as jdec,
)
from pytorch_end2end_speech_recognition_tpu.training import losses as jlosses
from pytorch_end2end_speech_recognition_tpu.utils.config import (
    ModelConfig as JModelConfig,
)
from pytorch_end2end_speech_recognition_tpu_torch import bridge
from pytorch_end2end_speech_recognition_tpu_torch.models import (
    decoder_transformer as tdec,
)
from pytorch_end2end_speech_recognition_tpu_torch.training import losses
from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
    ModelConfig,
)

KW = dict(decoder="transformer", decoder_layers=2, decoder_dim=32,
          decoder_heads=4, vocab_size=11, dtype="float32")


def _flat(module) -> dict:
    return {".".join(map(str, path)): np.array(var[...])
            for path, var in nnx.to_flat_state(nnx.state(module, nnx.Param))}


def _pair(d_enc=24):
    jd = jdec.TransformerDecoder(d_enc, JModelConfig(**KW), nnx.Rngs(0))
    td = tdec.TransformerDecoder(d_enc, ModelConfig(**KW))
    sd = {}
    for name, arr in _flat(jd).items():
        key, val = bridge._convert(name, arr)
        sd[key] = torch.from_numpy(np.ascontiguousarray(val))
    td.load_state_dict(sd)
    return jd, td


def _batch(rng, B=4, T=17, U=6, d_enc=24, V=11):
    enc = rng.standard_normal((B, T, d_enc)).astype(np.float32)
    enc_lens = np.asarray([17, 9, 1, 0], np.int32)[:B]
    tokens = rng.integers(2, V, (B, U)).astype(np.int32)
    token_lens = np.asarray([6, 3, 1, 0], np.int32)[:B]
    tokens *= np.arange(U)[None, :] < token_lens[:, None]
    return enc, enc_lens, tokens, token_lens


def test_sinusoidal_pe_and_ids_are_the_references():
    np.testing.assert_array_equal(tdec.sinusoidal_pe(37, 16),
                                  jdec.sinusoidal_pe(37, 16))
    assert tdec.SOS_EOS_ID == jdec.SOS_EOS_ID


def test_teacher_forced_pass_matches_jax():
    """Causal self-attention, cross-attention to ragged encoder lengths (a
    row with none), log-probs over [tokens, eos]."""
    rng = np.random.default_rng(0)
    jd, td = _pair()
    enc, enc_lens, tokens, token_lens = _batch(rng)
    want = np.asarray(jd(jnp.asarray(enc), jnp.asarray(enc_lens),
                         jnp.asarray(tokens), jnp.asarray(token_lens)))
    got = td(torch.from_numpy(enc), torch.from_numpy(enc_lens),
             torch.from_numpy(tokens)).detach().numpy()
    assert got.shape == want.shape == (4, 7, 11)
    # float32 both sides, two blocks: ~1e-6 measured
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_return_attn_matches_jax():
    """`return_attn`: the last block's cross-attention weights averaged
    over heads (B, U+1, T), which the Solver's attention image reads; the
    same log-probs as without it."""
    rng = np.random.default_rng(1)
    jd, td = _pair()
    enc, enc_lens, tokens, token_lens = _batch(rng)
    jlp, jw = jd(jnp.asarray(enc), jnp.asarray(enc_lens), jnp.asarray(tokens),
                 jnp.asarray(token_lens), return_attn=True)
    args = (torch.from_numpy(enc), torch.from_numpy(enc_lens),
            torch.from_numpy(tokens))
    lp, w = td(*args, return_attn=True)
    assert w.shape == (4, 7, 17)
    assert torch.equal(lp, td(*args))
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(jlp),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ls", [0.0, 0.1])
def test_attention_ce_and_hybrid_loss_match_jax(ls):
    """EOS at token_lens, label smoothing, pad rows excluded; the hybrid
    loss's CTC term normalised by max(token_lens, 1), both terms by the
    rows with tokens."""
    rng = np.random.default_rng(1)
    B, U, V, T = 4, 6, 11, 20
    logps = np.log(rng.dirichlet(np.ones(V), (B, U + 1))).astype(np.float32)
    tokens = rng.integers(2, V, (B, U)).astype(np.int32)
    token_lens = np.asarray([6, 3, 0, 1], np.int32)
    tokens *= np.arange(U)[None, :] < token_lens[:, None]
    want = np.asarray(jlosses.attention_ce_loss(
        jnp.asarray(logps), jnp.asarray(tokens), jnp.asarray(token_lens), ls))
    got = losses.attention_ce_loss(torch.from_numpy(logps),
                                   torch.from_numpy(tokens),
                                   torch.from_numpy(token_lens), ls).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    ctc_logits = rng.standard_normal((B, T, V)).astype(np.float32)
    enc_lens = np.asarray([20, 14, 9, 20], np.int32)
    jt, jm = jlosses.hybrid_loss(
        jnp.asarray(ctc_logits), jnp.asarray(enc_lens), jnp.asarray(logps),
        jnp.asarray(tokens), jnp.asarray(token_lens), 0.3, ls)
    tt, tm = losses.hybrid_loss(
        torch.from_numpy(ctc_logits), torch.from_numpy(enc_lens),
        torch.from_numpy(logps), torch.from_numpy(tokens),
        torch.from_numpy(token_lens), 0.3, ls)
    assert set(tm) == set(jm) == {"loss", "ctc_loss", "att_loss"}
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
