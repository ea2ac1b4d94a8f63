"""The port's native host library (`..._torch/native/`): its readers, batch
fill and Levenshtein against the port's Python paths and the JAX package's
bindings; the loader decoding through it, bit for bit; a failed build
raising; `ASR_TPU_NO_NATIVE` honoured."""

import numpy as np
import pytest

from pytorch_end2end_speech_recognition_tpu import native as jnative
from pytorch_end2end_speech_recognition_tpu.data import dataset as jdataset
from pytorch_end2end_speech_recognition_tpu.data import tokenizer as jtok
from pytorch_end2end_speech_recognition_tpu.utils.config import (
    DataConfig as JDataConfig,
)
from pytorch_end2end_speech_recognition_tpu_torch import native
from pytorch_end2end_speech_recognition_tpu_torch.data import audio as taudio
from pytorch_end2end_speech_recognition_tpu_torch.data import dataset
from pytorch_end2end_speech_recognition_tpu_torch.data import flac as tflac
from pytorch_end2end_speech_recognition_tpu_torch.data import tokenizer as ttok
from pytorch_end2end_speech_recognition_tpu_torch.data.manifest import (
    Utterance,
)
from pytorch_end2end_speech_recognition_tpu_torch.metrics import wer
from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
    DataConfig,
)


def _signals():
    """tests/test_flac.py's signals."""
    rng = np.random.default_rng(7)
    t = np.arange(20000) / 16000.0
    return [
        ("tone", np.sin(2 * np.pi * 440 * t).astype(np.float32) * 0.5, "fixed"),
        ("noise", (rng.standard_normal(4097) * 0.2).astype(np.float32), "fixed"),
        ("loud", rng.standard_normal(3000).astype(np.float32), "fixed"),
        ("speechish", (np.sin(2 * np.pi * 150 * t[:9000]) * 0.4
                       + rng.standard_normal(9000) * 0.01).astype(np.float32),
         "lpc"),
        ("const", np.full(5000, 0.25, np.float32), "fixed"),
        ("tiny", np.array([0.1, -0.2, 0.3], np.float32), "fixed"),
        ("silence", np.zeros(4096, np.float32), "fixed"),
    ]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Each signal as FLAC and as a 16-bit WAV, one WAV at 8 kHz (the
    batch fill leaves it for Python's resampler) and one broken file."""
    d = tmp_path_factory.mktemp("native")
    out = []
    for name, x, pred in _signals():
        tflac.write_flac(d / f"{name}.flac", x, 16000, predictor=pred)
        taudio.write_wav(d / f"{name}.wav", x, 16000)
        out += [d / f"{name}.flac", d / f"{name}.wav"]
    taudio.write_wav(d / "slow.wav", _signals()[0][1][:8000], 8000)
    (d / "broken.wav").write_bytes(b"RIFF\x00\x00\x00\x00WAVEjunk")
    return out + [d / "slow.wav", d / "broken.wav"]


def test_native_readers_match_python_and_the_jax_bindings(files):
    assert jnative.get_lib() is not None
    for p in files[:-2]:
        py, sr = taudio.read_audio(p)
        reader = (native.read_flac_native if p.suffix == ".flac"
                  else native.read_wav_native)
        for fn in (reader, native.read_audio_native):
            cc, csr = fn(str(p), max_samples=len(py) + 8)
            assert csr == sr == 16000
            np.testing.assert_array_equal(cc, py, err_msg=p.name)
        jfn = (jnative.read_flac_native if p.suffix == ".flac"
               else jnative.read_wav_native)
        np.testing.assert_array_equal(jfn(str(p), max_samples=len(py) + 8)[0],
                                      py)
    with pytest.raises(ValueError, match="native decode failed"):
        native.read_audio_native(str(files[-1]))


def test_batch_fill_matches_python_rows(files):
    Ts = 6000  # cuts the longer signals
    paths = [str(p) for p in files]
    out = np.zeros((len(paths) + 1, Ts), np.float32)
    lens = np.zeros(len(paths) + 1, np.int32)
    done = native.load_batch_native(paths, out[:len(paths)],
                                    lens[:len(paths)], expect_sr=16000)
    jout, jlens = np.zeros_like(out), np.zeros_like(lens)
    assert jnative.load_batch_native(paths, jout[:len(paths)],
                                     jlens[:len(paths)]) == done
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(lens, jlens)
    assert done == len(paths) - 2 and lens[-3:].tolist() == [0, 0, 0]
    for row, p in enumerate(paths[:-2]):
        x = taudio.load_audio(p, 16000)[:Ts]
        assert lens[row] == len(x)
        np.testing.assert_array_equal(out[row, :len(x)], x)
        assert not out[row, len(x):].any()
    assert not out[-3:].any()


def _loader_utts(files, tmp_path):
    return [Utterance(id=p.name, audio=str(p),
                      duration_s=len(taudio.read_audio(p)[0]) / 16000,
                      text=f"text {i}") for i, p in enumerate(files[:-1])]


def test_loader_batches_through_native_bit_for_bit(files, tmp_path,
                                                   monkeypatch):
    """The port's loader decodes through the batch fill (its 8 kHz row in
    Python): every batch equals the JAX loader's, and the port's own with
    ASR_TPU_NO_NATIVE (every row in Python), bit for bit."""
    utts = _loader_utts(files, tmp_path)
    texts = [u.text for u in utts]
    kw = dict(batch_size=4, n_length_buckets=2, min_audio_s=0.0)
    calls = []
    fill = dataset.load_batch_native

    def counted(paths, *a, **k):
        n = fill(paths, *a, **k)
        calls.append((len(paths), n))
        return n

    monkeypatch.setattr(dataset, "load_batch_native", counted)
    tl = dataset.BucketedLoader(utts, ttok.CharTokenizer(texts),
                                DataConfig(**kw))
    jl = jdataset.BucketedLoader(utts, jtok.CharTokenizer(texts),
                                 JDataConfig(**kw))
    got = list(tl.epoch(0))
    kept = [u.id for u in tl.utts]
    assert "slow.wav" in kept and len(kept) == len(utts)
    assert sum(c[0] for c in calls) == len(kept)
    assert sum(c[1] for c in calls) == len(kept) - 1  # not the 8 kHz row
    monkeypatch.setenv("ASR_TPU_NO_NATIVE", "1")
    plain = list(tl.epoch(0))
    assert sum(c[1] for c in calls[len(got):]) == 0
    for a, b, c in zip(got, plain, jl.epoch(0)):
        assert a.ids == b.ids == c.ids
        for k in ("audio", "audio_lens", "tokens", "token_lens"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
            np.testing.assert_array_equal(getattr(a, k), getattr(c, k))


def test_loader_has_no_fallback_around_the_native_path(files, tmp_path,
                                                       monkeypatch):
    utts = _loader_utts(files, tmp_path)
    tl = dataset.BucketedLoader(utts, ttok.CharTokenizer(
        [u.text for u in utts]), DataConfig(batch_size=4))

    def broken():
        raise RuntimeError("building asrnative.cpp failed")

    native._load.cache_clear()
    monkeypatch.setattr(native, "build", broken)
    try:
        with pytest.raises(RuntimeError, match="asrnative"):
            list(tl.epoch(0))
    finally:
        native._load.cache_clear()


@pytest.mark.parametrize("compiler", [["false"], ["/nonexistent/g++"]])
def test_a_failed_build_raises(tmp_path, monkeypatch, compiler):
    """A compiler that fails, or none at all, raises (no fallback)."""
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(native, "COMPILER", compiler)
    with pytest.raises(RuntimeError, match="asrnative.cpp"):
        native.build()
    assert not list(tmp_path.rglob("*.so"))


def test_build_is_cached_by_source_hash(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    lib = native.build()
    assert lib.parent.parent == tmp_path and lib.exists()
    mtime = lib.stat().st_mtime_ns
    assert native.build() == lib and lib.stat().st_mtime_ns == mtime


def test_levenshtein_matches_python_and_jax():
    rng = np.random.default_rng(3)
    cases = [([], []), ([], list("ab")), (list("abc"), []),
             ("the cat sat".split(), "the bat sat down".split())]
    cases += [(rng.integers(0, 5, rng.integers(0, 30)).tolist(),
               rng.integers(0, 5, rng.integers(0, 30)).tolist())
              for _ in range(40)]
    for a, b in cases:
        want = wer.edit_distance_np(a, b)
        assert native.levenshtein(a, b) == want == jnative.levenshtein(a, b)
        assert wer.edit_distance(a, b) == want


def test_no_native_env_is_honoured(monkeypatch, files):
    monkeypatch.setenv("ASR_TPU_NO_NATIVE", "1")
    assert not native.enabled() and native.get_lib() is None
    out = np.zeros((1, 100), np.float32)
    lens = np.zeros(1, np.int32)
    assert native.load_batch_native([str(files[0])], out, lens) == 0
    assert lens[0] == 0 and not out.any()
    with pytest.raises(RuntimeError, match="ASR_TPU_NO_NATIVE"):
        native.read_audio_native(str(files[0]))
    assert wer.edit_distance(list("kitten"), list("sitting")) == 3
