"""The port's encoder, CTC head and greedy decode against the JAX package,
with the JAX model's weights bridged into the port. float32 on the CPU;
inputs are made with numpy from a seed and handed to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from pytorch_end2end_speech_recognition_tpu.models import encoders as jenc
from pytorch_end2end_speech_recognition_tpu.ops.ctc import (
    ctc_greedy_decode as jax_greedy,
)
from pytorch_end2end_speech_recognition_tpu.utils.config import (
    ModelConfig as JModelConfig,
)
from pytorch_end2end_speech_recognition_tpu_torch import bridge
from pytorch_end2end_speech_recognition_tpu_torch.models import encoders as tenc
from pytorch_end2end_speech_recognition_tpu_torch.ops.ctc import (
    ctc_greedy_decode,
)
from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
    ModelConfig,
)


def _flat(module) -> dict:
    """nnx params as dotted path -> numpy (read with [...], not .value)."""
    return {".".join(map(str, path)): np.array(var[...])
            for path, var in nnx.to_flat_state(nnx.state(module, nnx.Param))}


def _bridged(module_jax, prefix=""):
    sd = {}
    for name, arr in _flat(module_jax).items():
        key, val = bridge._convert(prefix + name, arr)
        sd[key] = torch.from_numpy(np.ascontiguousarray(val))
    return sd


@pytest.mark.parametrize("T", [37, 40])
def test_conv_subsample_matches_jax(T):
    """Flax SAME padding at stride 2 pads (0,1) for an even length and (1,1)
    for an odd one, on time and mel axes; the flatten is (F, C) with C
    fastest. Odd and even T, ragged lengths."""
    rng = np.random.default_rng(T)
    jcfg = JModelConfig(encoder_dim=32, subsample_channels=8, dtype="float32",
                        residual_dtype="float32")
    jsub = jenc.ConvSubsample(80, 32, jcfg, nnx.Rngs(0))
    x = rng.standard_normal((3, T, 80)).astype(np.float32)
    lens = np.asarray([T, T - 9, 5], np.int32)
    ref, ref_lens = jsub(jnp.asarray(x), jnp.asarray(lens))
    tcfg = ModelConfig(encoder_dim=32, subsample_channels=8, dtype="float32",
                       residual_dtype="float32")
    tsub = tenc.ConvSubsample(80, 32, tcfg)
    tsub.load_state_dict(_bridged(jsub))
    out, out_lens = tsub(torch.from_numpy(x), torch.from_numpy(lens))
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(ref_lens))
    assert out.shape == ref.shape == (3, (T + 3) // 4, 32)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)


def test_rel_pos_bias_buckets_and_expansion_match_jax():
    jrel = jenc.RelPosBias(3, 2, nnx.Rngs(0))
    trel = tenc.RelPosBias(3, 2)
    trel.load_state_dict(_bridged(jrel))
    rel = np.arange(-900, 901)
    np.testing.assert_array_equal(
        trel._bucket(torch.from_numpy(rel)).numpy(),
        np.asarray(jrel._bucket(jnp.asarray(rel)[None, :])[0]))
    T = 45
    ref = np.asarray(jrel(T))[:, 0]                          # (L, H, T, T)
    out = trel(T).detach().numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(trel.diags(T).detach().numpy(),
                                  np.asarray(jrel.diags(T)))


@pytest.fixture(scope="module")
def slice_pair():
    """The JAX AsrModel at flagship-small (4 L, d128, 2-layer decoder),
    float32 on the CPU, and the port's AsrModel with the same weights
    (decoder included) bridged in."""
    from __graft_entry__ import _flagship_cfg
    from pytorch_end2end_speech_recognition_tpu.models.asr import (
        AsrModel as JAsrModel,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.configs.presets import (
        flagship_conformer,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.models.asr import (
        AsrModel,
    )

    jcfg = _flagship_cfg(small=True)
    jcfg.model.dtype = "float32"
    jmodel = JAsrModel(jcfg, nnx.Rngs(0))
    tcfg = flagship_conformer()
    m = tcfg.model
    m.encoder_layers, m.encoder_dim, m.encoder_ffn_dim = 4, 128, 256
    m.decoder_dim = 128
    tmodel = AsrModel(tcfg, device="cpu", seed=1)
    sd = bridge.state_dict_from_jax(_flat(jmodel), tcfg)
    missing, unexpected = tmodel.load_state_dict(sd, strict=False)
    assert not unexpected
    assert all(k.startswith("frontend.") for k in missing)
    assert any(k.startswith("decoder.embed.") for k in sd)
    return jmodel, tmodel


# float32 both sides; sums in another order through 4 conformer layers
# (about 1e-5 measured on the CPU; |enc| is up to ~3)
ENC_TOL = 1e-4


def test_slice_matches_jax(slice_pair):
    """encode -> CTC logits -> greedy tokens at flagship-small with audio
    lengths [Ts, Ts//2, Ts//3, 16000]: valid frames agree within ENC_TOL;
    greedy paths agree wherever the top-2 logit margin exceeds it."""
    jmodel, tmodel = slice_pair
    rng = np.random.default_rng(0)
    Ts = 2 * 16000
    audio = rng.standard_normal((4, Ts)).astype(np.float32) * 0.1
    lens = np.asarray([Ts, Ts // 2, Ts // 3, 16000], np.int32)
    jenc_out, jlens = jmodel.encode(jnp.asarray(audio), jnp.asarray(lens))
    jlogits = np.asarray(jmodel.ctc_logits(jenc_out))
    with torch.inference_mode():
        enc, elens = tmodel.encode(torch.from_numpy(audio),
                                   torch.from_numpy(lens))
        logits = tmodel.ctc_logits(enc)
        tokens, tlens = ctc_greedy_decode(logits, elens)
    np.testing.assert_array_equal(elens.numpy(), np.asarray(jlens))
    valid = (np.arange(enc.shape[1])[None, :]
             < np.asarray(jlens)[:, None])[..., None]
    np.testing.assert_allclose(enc.numpy() * valid,
                               np.asarray(jenc_out) * valid,
                               rtol=ENC_TOL, atol=ENC_TOL)
    np.testing.assert_allclose(logits.numpy() * valid, jlogits * valid,
                               rtol=ENC_TOL, atol=ENC_TOL)
    top2 = np.sort(jlogits, axis=-1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0] > ENC_TOL) & valid[..., 0]
    assert sure.sum() > 0.9 * valid.sum()
    path = logits.numpy().argmax(-1)
    np.testing.assert_array_equal(path[sure], jlogits.argmax(-1)[sure])
    jtok, jtl = jax_greedy(jnp.asarray(jlogits), jlens)
    if np.all(sure | ~valid[..., 0]):
        np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtok))
        np.testing.assert_array_equal(tlens.numpy(), np.asarray(jtl))


def test_ctc_greedy_decode_matches_jax():
    """Crafted paths: repeats, blanks between repeats, all blank, a frame
    past the row's length, and a zero-length row."""
    V = 5
    paths = np.asarray([
        [1, 1, 0, 1, 2, 2, 0, 0, 3, 3],
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        [4, 0, 4, 4, 0, 0, 4, 1, 1, 2],
        [2, 3, 2, 3, 2, 3, 2, 3, 2, 3],
        [1, 2, 3, 4, 1, 2, 3, 4, 1, 2],
    ])
    lens = np.asarray([10, 10, 8, 5, 0], np.int32)
    logits = np.eye(V, dtype=np.float32)[paths] * 5.0
    ref_tok, ref_len = jax_greedy(jnp.asarray(logits), jnp.asarray(lens))
    tok, tlen = ctc_greedy_decode(torch.from_numpy(logits),
                                  torch.from_numpy(lens))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(ref_len))
    assert tok[0, :4].tolist() == [1, 1, 2, 3] and int(tlen[4]) == 0


def test_long_audio_raises_on_kernel_path_only():
    """Past FLASH_T frames the kernel path names the unported flash kernel;
    the plain path stays dense."""
    cfg = ModelConfig(encoder="conformer", encoder_layers=1, encoder_dim=32,
                      encoder_heads=2, dtype="float32", attn_impl="cuda")
    rel = tenc.RelPosBias(1, 2)
    torch.nn.init.normal_(rel.table)
    with pytest.raises(NotImplementedError, match="flash"):
        tenc._rel_bias_repr(rel, cfg, tenc.FLASH_T + 1)
    cfg.attn_impl = "torch"
    out = tenc._rel_bias_repr(rel, cfg, tenc.FLASH_T + 1)
    assert out.shape == (1, 2, tenc.FLASH_T + 1, tenc.FLASH_T + 1)
