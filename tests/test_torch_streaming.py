"""The port's streaming encoder and greedy streaming transcriber
(`models/streaming.py`) against the JAX package's, with the JAX weights
bridged in: the Conformer of `tests/test_streaming.py:_model` (2 layers d32,
H4, vocab 12, CTC only) and a 1-layer BiLSTM, float32 on the CPU, on a
12 s stream of noise made with numpy from a seed. After every feed the
emitted frames' count is equal and their values (and CTC logits) within
1e-4, the stream's `window_start` and `emitted_upto` are equal, and so are
the greedy tokens. The JAX package's own streaming properties (the emitted
count within 2 of the full pass; the error shrinking as the overlap grows)
are checked on the port alone, and the host-side frame count against the
encoder's lengths."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_train_case as case_mod
from flax import nnx

from pytorch_end2end_speech_recognition_tpu.models.asr import (
    AsrModel as JAsrModel,
)
from pytorch_end2end_speech_recognition_tpu.models.streaming import (
    StreamingTranscriber as JStreamingTranscriber,
)
from pytorch_end2end_speech_recognition_tpu.utils.config import (
    AsrConfig as JAsrConfig,
)
from pytorch_end2end_speech_recognition_tpu_torch import bridge
from pytorch_end2end_speech_recognition_tpu_torch.data.tokenizer import (
    CharTokenizer,
)
from pytorch_end2end_speech_recognition_tpu_torch.models.asr import AsrModel
from pytorch_end2end_speech_recognition_tpu_torch.models.streaming import (
    StreamingEncoder,
    StreamingTranscriber,
    encoded_len,
)
from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
    AsrConfig,
)

TOL = 1e-4
SR = 16000


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tensors here are tiny: torch's intra-op thread pool only adds
    overhead to each of their many small ops (7x on a loaded host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configure(c, encoder: str):
    m = c.model
    m.encoder, m.encoder_layers = encoder, 2 if encoder == "conformer" else 1
    m.encoder_dim = 32 if encoder == "conformer" else 16
    m.encoder_ffn_dim, m.encoder_heads = 64, 4
    m.vocab_size, m.ctc_weight, m.dtype = 12, 1.0, "float32"
    c.frontend.spec_augment = False
    return c


_MODELS = {}


def _models(encoder: str = "conformer"):
    """(JAX model, port model) with the port's weights bridged."""
    if encoder not in _MODELS:
        jm = JAsrModel(_configure(JAsrConfig(), encoder), nnx.Rngs(0))
        tm = AsrModel(_configure(AsrConfig(), encoder), device="cpu").eval()
        state = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in (
            bridge._convert(n, a) for n, a in case_mod.flat(jm).items())}
        missing, unexpected = tm.load_state_dict(state, strict=False)
        assert not unexpected and all(k.startswith("frontend.")
                                      for k in missing)
        _MODELS[encoder] = (jm, tm)
    return _MODELS[encoder]


def _audio(seconds: float, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(int(seconds * SR)) * 0.1).astype(np.float32)


def _pieces(audio, feed_s):
    feed = int(feed_s * SR)
    return [audio[i:i + feed] for i in range(0, len(audio), feed)]


def _recording(st):
    """Wrap st.enc.process to record each feed's emitted frames."""
    got, orig = [], st.enc.process

    def process(state, chunk, final=False):
        out = orig(state, chunk, final=final)
        got.append((np.asarray(out[1]), np.asarray(out[2])))
        return out
    st.enc.process = process
    return got


def _stream_both(encoder, pieces, chunk_s, overlap_s, finals=None):
    """Feed both transcribers the same pieces; after each feed compare the
    emitted frames, the positions and the greedy tokens."""
    jm, tm = _models(encoder)
    tok = CharTokenizer(charset="abcdefgh")
    js = JStreamingTranscriber(jm, tok, chunk_s, overlap_s)
    ts = StreamingTranscriber(tm, tok, chunk_s, overlap_s)
    assert (ts.enc.chunk, ts.enc.overlap, ts.enc.step_samples) == (
        js.enc.chunk, js.enc.overlap, js.enc.step_samples)
    jrec, trec = _recording(js), _recording(ts)
    jst, tst = js.enc.init_stream(), ts.enc.init_stream()
    finals = finals or [i == len(pieces) - 1 for i in range(len(pieces))]
    n_emitted = 0
    for p, final in zip(pieces, finals):
        jst = js.feed(jst, p, final=final)
        tst = ts.feed(tst, torch.from_numpy(p), final=final)
        (je, jl), (te, tl) = jrec[-1], trec[-1]
        assert len(te) == len(je)
        if len(je):
            np.testing.assert_allclose(te, je, rtol=0, atol=TOL)
            np.testing.assert_allclose(tl, jl, rtol=0, atol=TOL)
        n_emitted += len(je)
        assert (tst.window_start, tst.emitted_upto) == (jst.window_start,
                                                        jst.emitted_upto)
        assert tst.tokens == jst.tokens and tst.last_token == jst.last_token
    return n_emitted


@pytest.mark.parametrize("chunk_s,overlap_s,feed_s", [
    (4.0, 1.0, 1.0), (3.0, 0.5, 0.7), (3.0, 3.0, 2.5)])
def test_stream_matches_jax(chunk_s, overlap_s, feed_s):
    n = _stream_both("conformer", _pieces(_audio(12.0), feed_s), chunk_s,
                     overlap_s)
    assert n > 0


def test_stream_single_final_feed_matches_jax():
    """The whole 12 s in one final feed: the window is the whole remainder,
    then what is left of it, as in the reference."""
    assert _stream_both("conformer", [_audio(12.0)], 3.0, 1.0) > 0


def test_stream_shorter_than_one_window_matches_jax():
    """A 2.5 s stream under a 5 s window: nothing until the final feed."""
    assert _stream_both("conformer", _pieces(_audio(2.5), 0.5), 4.0,
                        1.0) > 0


def test_stream_empty_final_feed_matches_jax():
    """The last feed is empty and final: it flushes the held-back tail."""
    pieces = _pieces(_audio(7.0), 1.0) + [np.zeros((0,), np.float32)]
    assert _stream_both("conformer", pieces, 3.0, 1.0) > 0


def test_stream_blstm_matches_jax():
    assert _stream_both("blstm", _pieces(_audio(6.0, seed=1), 0.8), 2.0,
                        0.5) > 0


def _full(tm, audio):
    with torch.no_grad():
        enc, lens = tm.encode(torch.from_numpy(audio)[None],
                              torch.tensor([len(audio)]))
    return enc[0, :int(lens[0])].numpy()


def _streamed(tm, audio, chunk_s, overlap_s, feed_s=1.0):
    se = StreamingEncoder(tm, chunk_s, overlap_s)
    state, outs = se.init_stream(), []
    pieces = _pieces(audio, feed_s)
    for i, p in enumerate(pieces):
        state, enc, _ = se.process(state, p, final=i == len(pieces) - 1)
        if len(enc):
            outs.append(enc.numpy())
    return np.concatenate(outs)


def test_stream_output_count_matches_full():
    """The JAX package's tiling property on the port alone: the emitted
    frames number within 2 of the full pass."""
    _, tm = _models()
    audio = _audio(12.0)
    assert abs(len(_streamed(tm, audio, 4.0, 1.0)) - len(_full(tm, audio))
               ) <= 2


def test_stream_error_shrinks_with_overlap():
    """The JAX package's property on the port alone: the streamed frames'
    relative error against the full pass shrinks as the overlap grows."""
    _, tm = _models()
    audio = _audio(12.0)
    full = _full(tm, audio)

    def err(overlap_s):
        s = _streamed(tm, audio, 3.0, overlap_s)
        n = min(len(s), len(full))
        return float(np.abs(s[:n] - full[:n]).mean()
                     / (np.abs(full[:n]).mean() + 1e-6))

    e_small, e_big = err(0.5), err(3.0)
    assert e_big <= e_small * 1.05, (e_small, e_big)
    assert e_big < 0.5, e_big


@pytest.mark.parametrize("encoder,extra", [
    ("conformer", {}), ("transformer", {}), ("blstm", {}),
    ("pblstm", {"vgg_frontend": True, "pyramid_layers": 2,
                "encoder_layers": 3})])
def test_host_frame_count_matches_encoder_lengths(encoder, extra):
    """`encoded_len`, the host's count of a window's frames, equals the
    encoder's lengths on the device for window lengths around the frame and
    subsampling boundaries."""
    cfg = _configure(AsrConfig(), encoder)
    cfg.model.encoder_dim, cfg.model.encoder_layers = 16, 1
    for k, v in extra.items():
        setattr(cfg.model, k, v)
    tm = AsrModel(cfg, device="cpu").eval()
    lens = [400, 559, 560, 719, 1200, 1680, 1681, 2001, 3999, 16000, 16161]
    audio = torch.zeros((len(lens), max(lens)))
    with torch.no_grad():
        _, enc_lens = tm.encode(audio, torch.tensor(lens))
    assert [encoded_len(cfg, n) for n in lens] == enc_lens.tolist()
