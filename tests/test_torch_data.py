"""The port's host-side data layer against the JAX package's on the same
inputs: the synthetic corpora, the tokenizers (ids, vocab, vocab_hash,
saved files), WAV/FLAC decoding and resampling, the bucketed loader (shape
set, every batch of two epochs bit for bit, shards, resume cursor), the
prefetch thread, WER scoring, global CMVN statistics and the score CLI;
plus the behaviours of `test_data.py`, `test_flac.py`, `test_wer.py` and
`test_average_ckpts.py` held by the port's own copies. The JAX loader
decodes through its C++ batch path where it is built; the port reads
audio through Python only, so equal batches also hold the two decoders to
each other."""

import json
import struct
import threading
import time

import numpy as np
import pytest
import torch

from pytorch_end2end_speech_recognition_tpu.data import audio as jaudio
from pytorch_end2end_speech_recognition_tpu.data import dataset as jdataset
from pytorch_end2end_speech_recognition_tpu.data import flac as jflac
from pytorch_end2end_speech_recognition_tpu.data import synthetic as jsynth
from pytorch_end2end_speech_recognition_tpu.data import tokenizer as jtok
from pytorch_end2end_speech_recognition_tpu.metrics import wer as jwer
from pytorch_end2end_speech_recognition_tpu.utils.config import (
    DataConfig as JDataConfig,
)
from pytorch_end2end_speech_recognition_tpu_torch.data import audio as taudio
from pytorch_end2end_speech_recognition_tpu_torch.data import (
    dataset as tdataset,
)
from pytorch_end2end_speech_recognition_tpu_torch.data import flac as tflac
from pytorch_end2end_speech_recognition_tpu_torch.data import (
    synthetic as tsynth,
)
from pytorch_end2end_speech_recognition_tpu_torch.data import tokenizer as ttok
from pytorch_end2end_speech_recognition_tpu_torch.data.manifest import (
    Utterance,
    read_manifest,
    write_manifest,
)
from pytorch_end2end_speech_recognition_tpu_torch.metrics import wer as twer
from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
    AsrConfig,
    DataConfig,
)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The digits corpus of `conftest.digits_corpus` made by the port."""
    root = tmp_path_factory.mktemp("tdigits")
    return tsynth.make_digits_corpus(root, n_train=24, n_dev=6, n_test=6,
                                     max_digits=3)


@pytest.fixture(scope="module")
def utts(corpus):
    return read_manifest(corpus["train"])


# ---------------------------------------------------------------- corpora
@pytest.mark.parametrize("kind", ["digits", "phrases", "commands"])
def test_synthetic_corpora_equal_jax(tmp_path, kind):
    """Same manifests (ids, texts, durations) and the same WAV bytes."""
    kw = dict(n_train=4, n_dev=2, n_test=1, seed=3)
    jm = getattr(jsynth, f"make_{kind}_corpus")(tmp_path / "j", **kw)
    tm = getattr(tsynth, f"make_{kind}_corpus")(tmp_path / "t", **kw)
    assert set(jm) == set(tm)
    for split in jm:
        ju, tu = read_manifest(jm[split]), read_manifest(tm[split])
        assert [(u.id, u.text, u.duration_s) for u in ju] == [
            (u.id, u.text, u.duration_s) for u in tu]
        for a, b in zip(ju, tu):
            assert open(a.audio, "rb").read() == open(b.audio, "rb").read()


# ---------------------------------------------------------------- tokenizers
@pytest.mark.parametrize("kind", ["char", "bpe"])
def test_tokenizer_matches_jax(tmp_path, kind):
    """The phrases and commands transcripts: the same vocab, ids, decoded
    text, vocab_hash and saved file; each package loads the other's file.
    BPE at a target of 256 pieces."""
    texts = []
    for mk in (tsynth.make_phrases_corpus, tsynth.make_commands_corpus):
        m = mk(tmp_path / mk.__name__, n_train=40, n_dev=1, n_test=1, seed=1)
        texts += [u.text for u in read_manifest(m["train"])]
    j = jtok.build_tokenizer(kind, texts, vocab_size=256)
    t = ttok.build_tokenizer(kind, texts, vocab_size=256)
    assert t.vocab == j.vocab and t.vocab_size == j.vocab_size
    if kind == "bpe":
        assert t.merges == j.merges and t.vocab_size > 100
    assert t.vocab_hash() == j.vocab_hash()
    probe = texts + ["hello world", "  two   three ", "zz?"]
    for s in probe:
        ids = t.encode(s)
        assert ids == j.encode(s), s
        assert t.decode(ids) == j.decode(ids)
        assert t.decode(np.asarray(ids, np.int32)) == j.decode(ids)
    t.save(tmp_path / "t.json")
    j.save(tmp_path / "j.json")
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json"
                                                  ).read_bytes()
    back = ttok.Tokenizer.load(tmp_path / "j.json")
    assert back.vocab_hash() == j.vocab_hash()
    assert [back.encode(s) for s in probe] == [j.encode(s) for s in probe]


def test_char_tokenizer_roundtrip(tmp_path):
    t = ttok.CharTokenizer(["HELLO WORLD", "SPEECH RECOGNITION"])
    ids = t.encode("hello world")
    assert all(i >= ttok.N_SPECIAL for i in ids)
    assert t.decode(ids) == "HELLO WORLD"
    t.save(tmp_path / "tok.json")
    assert ttok.Tokenizer.load(tmp_path / "tok.json").encode(
        "hello world") == ids


def test_bpe_tokenizer_roundtrip(tmp_path):
    t = ttok.BpeTokenizer(["THE CAT SAT ON THE MAT"] * 10
                          + ["THE DOG RAN"] * 5, vocab_size=40)
    ids = t.encode("the cat ran")
    assert t.decode(ids) == "THE CAT RAN"
    t.save(tmp_path / "bpe.json")
    t2 = ttok.Tokenizer.load(tmp_path / "bpe.json")
    assert t2.encode("the cat ran") == ids
    assert t2.decode(ids) == "THE CAT RAN"


def test_vocab_hash_tells_same_sized_vocabs_apart():
    a, b = ttok.CharTokenizer(charset="ABC"), ttok.CharTokenizer(charset="ABD")
    assert a.vocab_size == b.vocab_size and a.vocab_hash() != b.vocab_hash()
    assert a.vocab_hash() == jtok.CharTokenizer(charset="ABC").vocab_hash()


def test_tokenizer_load_for_config_fallbacks(tmp_path, utts, corpus):
    """The copy beside the checkpoints first, then a rebuild from the train
    manifest, else FileNotFoundError."""
    cfg = AsrConfig()
    cfg.data.train_manifest = str(corpus["train"])
    cfg.train.checkpoint_dir = str(tmp_path / "ckpt")
    (tmp_path / "ckpt").mkdir()
    ref = ttok.CharTokenizer([u.text for u in utts])
    ref.save(tmp_path / "ckpt" / "tokenizer.json")
    assert ttok.load_for_config(cfg).vocab == ref.vocab
    (tmp_path / "ckpt" / "tokenizer.json").unlink()
    assert ttok.load_for_config(cfg).vocab == ref.vocab
    cfg.data.train_manifest = str(tmp_path / "missing.jsonl")
    with pytest.raises(FileNotFoundError):
        ttok.load_for_config(cfg)


# ---------------------------------------------------------------- audio
@pytest.mark.parametrize("sr_in,sr_out", [(16000, 16000), (8000, 16000),
                                          (22050, 16000), (48000, 16000)])
def test_wav_and_resample_equal_jax(tmp_path, sr_in, sr_out):
    rng = np.random.default_rng(sr_in)
    x = (rng.standard_normal(sr_in // 3) * 0.3).astype(np.float32)
    taudio.write_wav(tmp_path / "t.wav", x, sr_in)
    jaudio.write_wav(tmp_path / "j.wav", x, sr_in)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav"
                                                 ).read_bytes()
    y, sr = taudio.read_wav(tmp_path / "t.wav")
    yj, _ = jaudio.read_wav(tmp_path / "t.wav")
    assert sr == sr_in
    np.testing.assert_array_equal(y, yj)
    np.testing.assert_allclose(y, np.clip(x, -1, 1), atol=1e-4)
    np.testing.assert_array_equal(taudio.load_audio(tmp_path / "t.wav", sr_out),
                                  jaudio.load_audio(tmp_path / "t.wav", sr_out))


@pytest.mark.parametrize("fmt,bits", [(1, 8), (1, 24), (1, 32), (3, 32)])
def test_read_wav_formats_equal_jax(tmp_path, fmt, bits):
    """PCM 8/24/32 and float WAVs, stereo, written by hand."""
    rng = np.random.default_rng(bits)
    x = np.clip(rng.standard_normal((300, 2)) * 0.3, -1, 1)
    if fmt == 3:
        data = x.astype("<f4").tobytes()
    elif bits == 8:
        data = (x * 127 + 128).astype(np.uint8).tobytes()
    elif bits == 24:
        v = (x * 8388607).astype(np.int32).reshape(-1)
        data = np.stack([v & 255, (v >> 8) & 255, (v >> 16) & 255],
                        1).astype(np.uint8).tobytes()
    else:
        data = (x * 2147483647).astype("<i4").tobytes()
    fmt_chunk = struct.pack("<HHIIHH", fmt, 2, 16000, 16000 * 2 * bits // 8,
                            2 * bits // 8, bits)
    raw = (b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
           + b"fmt " + struct.pack("<I", 16) + fmt_chunk
           + b"data" + struct.pack("<I", len(data)) + data)
    (tmp_path / "x.wav").write_bytes(raw)
    y, sr = taudio.read_wav(tmp_path / "x.wav")
    yj, _ = jaudio.read_wav(tmp_path / "x.wav")
    assert sr == 16000 and y.shape == (300,)
    np.testing.assert_array_equal(y, yj)


def test_corrupt_wav_header_raises(tmp_path):
    (tmp_path / "bad.wav").write_bytes(b"RIFX" + b"\0" * 40)
    with pytest.raises(ValueError):
        taudio.read_wav(tmp_path / "bad.wav")


def _signals():
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


@pytest.mark.parametrize("name,x,pred", _signals())
def test_flac_roundtrip_bit_exact_and_equal_jax(tmp_path, name, x, pred):
    """The port's encoder writes the JAX encoder's bytes; its decoder reads
    them back bit-exact (CRC and MD5 checked) and equal to JAX's."""
    p = tmp_path / f"{name}.flac"
    tflac.write_flac(p, x, 16000, predictor=pred)
    jflac.write_flac(tmp_path / "j.flac", x, 16000, predictor=pred)
    assert p.read_bytes() == (tmp_path / "j.flac").read_bytes()
    y, sr = tflac.read_flac(p, check_crc=True, verify_md5=True)
    assert sr == 16000
    ref = (np.clip(x, -1, 1) * 32767.0).astype(np.int64)
    np.testing.assert_array_equal(np.round(y * 32768.0).astype(np.int64), ref)
    np.testing.assert_array_equal(y, jflac.read_flac(p)[0])
    np.testing.assert_array_equal(taudio.load_audio(p, 16000),
                                  jaudio.load_audio(p, 16000))


def test_flac_crc_info_and_corruption(tmp_path):
    assert tflac.crc8(b"123456789") == 0xF4
    assert tflac.crc16(b"123456789") == 0xFEE8
    x = np.sin(np.arange(12345) * 0.01).astype(np.float32) * 0.5
    p = tmp_path / "c.flac"
    tflac.write_flac(p, x, 16000)
    info = tflac.flac_info(p)
    assert (info.total_samples, info.sample_rate, info.bits_per_sample,
            info.channels) == (12345, 16000, 16, 1)
    raw = bytearray(p.read_bytes())
    raw[len(raw) // 2] ^= 0x40
    p.write_bytes(bytes(raw))
    with pytest.raises(ValueError):
        tflac.read_flac(p, check_crc=True, verify_md5=True)
    (tmp_path / "x.flac").write_bytes(b"RIFFxxxxWAVE" + b"\x00" * 64)
    with pytest.raises(ValueError):
        tflac.read_flac(tmp_path / "x.flac")


# ---------------------------------------------------------------- loader
def _loaders(utts, shard=0, shards=1, train=True, **kw):
    texts = [u.text for u in utts]
    jl = jdataset.BucketedLoader(utts, jtok.CharTokenizer(texts),
                                 JDataConfig(**kw), train=train,
                                 shard_index=shard, num_shards=shards)
    tl = tdataset.BucketedLoader(utts, ttok.CharTokenizer(texts),
                                 DataConfig(**kw), train=train,
                                 shard_index=shard, num_shards=shards)
    return jl, tl


def _same_batch(a, b):
    assert a.ids == b.ids and a.texts == b.texts
    for k in ("audio", "audio_lens", "tokens", "token_lens"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(batch_size=4, n_length_buckets=3),
    dict(batch_size=5, n_length_buckets=8, batch_frames=60000, seed=4),
    dict(batch_size=3, n_length_buckets=2, shuffle=False)])
def test_loader_matches_jax_bit_for_bit(utts, kw):
    """shape_set, len, and every batch of epochs 0 and 1, in order."""
    jl, tl = _loaders(utts, **kw)
    assert tl.shape_set == jl.shape_set and len(tl) == len(jl)
    for ep in (0, 1):
        jb, tb = list(jl.epoch(ep)), list(tl.epoch(ep))
        assert len(jb) == len(tb) == len(jl)
        for a, b in zip(jb, tb):
            _same_batch(a, b)
    assert [b.ids for b in tl.epoch(0)] != [b.ids for b in tl.epoch(1)] or (
        not kw.get("shuffle", True))


@pytest.mark.parametrize("shards", [2, 3])
def test_loader_shards_match_jax(utts, shards):
    """Each shard's batches, with the empty pad batches that keep the
    shards in step; together the shards hold every utterance once."""
    seen = []
    n_batches = set()
    for s in range(shards):
        jl, tl = _loaders(utts, s, shards, batch_size=4, n_length_buckets=2)
        tb = list(tl.epoch(1))
        for a, b in zip(jl.epoch(1), tb):
            _same_batch(a, b)
        n_batches.add(len(tb))
        seen += [i for b in tb for i in b.ids]
    assert len(n_batches) == 1
    assert sorted(seen) == sorted(u.id for u in utts)


def test_repeat_from_a_cursor_matches_jax(utts):
    """repeat(epoch, batch, with_cursor=True) from mid-epoch into the next
    epoch: the same cursors and batches as the JAX loader's, and the same
    batches as an uninterrupted repeat from (0, 0)."""
    jl, tl = _loaders(utts, batch_size=4, n_length_buckets=3)
    n = len(tl)
    jr = jl.repeat(0, 2, with_cursor=True)
    tr = tl.repeat(0, 2, with_cursor=True)
    full = tdataset.BucketedLoader(tl.utts, tl.tokenizer, tl.cfg).repeat(
        with_cursor=True)
    for _ in range(2):
        next(full)
    for _ in range(n + 3):
        (je, jb, ja), (te, tbi, ta), (fe, fb, fa) = next(jr), next(tr), next(full)
        assert (je, jb) == (te, tbi) == (fe, fb)
        _same_batch(ja, ta)
        _same_batch(fa, ta)
    assert te == 1


def test_bucketed_loader_shapes(utts):
    cfg = DataConfig(batch_size=4, n_length_buckets=3, batch_frames=10**9)
    loader = tdataset.BucketedLoader(utts, ttok.CharTokenizer(
        [u.text for u in utts]), cfg)
    shapes, n_utts = set(), 0
    for b in loader:
        assert b.audio.dtype == np.float32 and b.tokens.dtype == np.int32
        assert b.audio.shape[0] == b.tokens.shape[0]
        n_utts += int((b.audio_lens > 0).sum())
        assert (b.audio_lens <= b.audio.shape[1]).all()
        assert (b.token_lens <= b.tokens.shape[1]).all()
        for r in range(b.tokens.shape[0]):
            assert (b.tokens[r, b.token_lens[r]:] == ttok.BLANK_ID).all()
        shapes.add(b.shape_key)
    assert n_utts == len(loader.utts)
    assert len(shapes) <= len(loader.buckets)


def test_loader_refuses_an_empty_manifest(utts):
    tok = ttok.CharTokenizer(["A"])
    with pytest.raises(ValueError, match="no utterances"):
        tdataset.BucketedLoader([], tok, DataConfig())
    with pytest.raises(ValueError, match="no utterances"):
        tdataset.BucketedLoader(utts, tok, DataConfig(max_audio_s=0.01))


def test_bucketed_loader_on_flac_corpus(tmp_path):
    utts = []
    for i in range(6):
        n = 4000 + 700 * i
        x = (np.sin(np.arange(n) * (0.01 + 0.001 * i)) * 0.4).astype(
            np.float32)
        p = tmp_path / f"u{i}.flac"
        tflac.write_flac(p, x, 16000)
        utts.append(Utterance(id=f"u{i}", audio=str(p), duration_s=n / 16000,
                              text="ONE TWO"))
    write_manifest(tmp_path / "m.jsonl", utts)
    utts = read_manifest(tmp_path / "m.jsonl")
    jl, tl = _loaders(utts, batch_size=3, n_length_buckets=2,
                      min_audio_s=0.01)
    seen = 0
    for a, b in zip(jl.epoch(0), tl.epoch(0)):
        _same_batch(a, b)
        seen += int((b.audio_lens > 0).sum())
        assert all(np.abs(b.audio[i]).max() > 0 for i in range(len(b.ids)))
    assert seen == 6


# ---------------------------------------------------------------- prefetch
def test_prefetch_preserves_order():
    assert list(tdataset.prefetch(iter(range(20)), depth=3)) == list(
        range(20))
    assert list(jdataset.prefetch(iter(range(20)), depth=2)) == list(
        tdataset.prefetch(iter(range(20)), depth=2))


def test_prefetch_runs_ahead_at_most_depth_and_raises_the_workers_error():
    made = []

    def gen():
        for i in range(10):
            made.append(i)
            yield i
        raise OSError("disk gone")

    it = tdataset.prefetch(gen(), depth=2)
    assert next(it) == 0
    time.sleep(0.3)
    assert len(made) <= 4   # the item taken, two queued, one in hand
    with pytest.raises(OSError, match="disk gone"):
        list(it)


def test_closing_prefetch_stops_its_thread():
    before = threading.active_count()
    it = tdataset.prefetch(iter(range(10 ** 6)), depth=2)
    assert next(it) == 0
    assert threading.active_count() == before + 1
    it.close()
    assert threading.active_count() == before


# ---------------------------------------------------------------- scoring
def test_edit_distance_basic():
    ed = twer.edit_distance
    assert ed([], []) == 0 and ed([], list("abc")) == 3
    assert ed(list("abc"), list("abc")) == 0
    assert ed(list("abc"), list("abd")) == 1
    assert ed(list("abc"), list("ab")) == 1
    assert ed(list("abc"), list("xabc")) == 1
    assert ed(list("kitten"), list("sitting")) == 3
    assert ed(list("sunday"), list("saturday")) == 3


def test_edit_distance_matches_jax_and_bruteforce():
    def brute(a, b):
        D = np.zeros((len(a) + 1, len(b) + 1), int)
        D[:, 0] = np.arange(len(a) + 1)
        D[0, :] = np.arange(len(b) + 1)
        for i in range(1, len(a) + 1):
            for j in range(1, len(b) + 1):
                D[i, j] = min(D[i - 1, j] + 1, D[i, j - 1] + 1,
                              D[i - 1, j - 1] + (a[i - 1] != b[j - 1]))
        return D[-1, -1]

    rng = np.random.default_rng(0)
    for _ in range(60):
        a = rng.integers(0, 4, rng.integers(0, 9)).tolist()
        b = rng.integers(0, 4, rng.integers(0, 9)).tolist()
        assert twer.edit_distance(a, b) == brute(a, b) == jwer.edit_distance(
            a, b), (a, b)


def test_wer_cer_and_error_stats():
    refs, hyps = ["the cat sat", "hello world"], ["the cat sat", "hello word"]
    assert twer.wer(refs, refs) == 0.0
    assert twer.wer(refs, hyps) == pytest.approx(1 / 5)
    assert twer.cer(["abc"], ["abd"]) == 1 / 3
    assert twer.cer(refs, hyps) == jwer.cer(refs, hyps)
    s = twer.ErrorStats()
    s.update(["a", "b"], ["a", "b"])
    s.update(["a", "b"], ["a", "c"])
    assert (s.tokens, s.errors, s.ser) == (4, 1, 0.5)


def test_score_cli_matches_jax(tmp_path, capsys):
    from pytorch_end2end_speech_recognition_tpu.cli import score as jscore
    from pytorch_end2end_speech_recognition_tpu_torch.cli import score

    rows = [{"id": "a", "ref": "ONE TWO THREE", "hyp": "ONE TOO THREE"},
            {"id": "b", "ref": "FOUR", "hyp": "FOUR FIVE"}]
    (tmp_path / "r.jsonl").write_text(
        "\n".join(json.dumps(r) for r in rows) + "\n")
    score.main([str(tmp_path / "r.jsonl")])
    jscore.main([str(tmp_path / "r.jsonl")])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[0]) == json.loads(out[1])
    assert json.loads(out[0])["wer_errors"] == 2


# ---------------------------------------------------------------- CMVN
def test_compute_global_cmvn_matches_jax(tmp_path, corpus):
    """The same statistics from the port's logmel_np as from the JAX
    package's, on the digits corpus (float32 host sums: 1e-6 relative),
    in the JSON that `Frontend(cmvn='global')` reads."""
    from pytorch_end2end_speech_recognition_tpu.ops.frontend import (
        compute_global_cmvn as jcmvn,
    )
    from pytorch_end2end_speech_recognition_tpu.utils.config import (
        FrontendConfig as JFrontendConfig,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops.frontend import (
        Frontend,
        compute_global_cmvn,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
        FrontendConfig,
        resolve_device,
    )

    got = compute_global_cmvn(str(corpus["train"]), FrontendConfig(),
                              str(tmp_path / "t.json"))
    want = jcmvn(str(corpus["train"]), JFrontendConfig(),
                 str(tmp_path / "j.json"))
    assert got["frames"] == want["frames"] > 1000
    np.testing.assert_allclose(got["mean"], want["mean"], rtol=1e-6)
    np.testing.assert_allclose(got["std"], want["std"], rtol=1e-5)
    cfg = AsrConfig()
    cfg.frontend.cmvn, cfg.frontend.cmvn_stats_path = "global", str(
        tmp_path / "t.json")
    fe = Frontend(resolve_device(cfg, "cpu").frontend, "cpu")
    np.testing.assert_array_equal(fe.global_mean.numpy(),
                                  np.float32(got["mean"]))


# ---------------------------------------------------------------- averaging
def _save(ckpt_dir, step, w):
    from pytorch_end2end_speech_recognition_tpu_torch.training.checkpoint import (  # noqa: E501
        save_checkpoint,
    )

    params = {"enc.w": torch.full((4, 8), w),
              "enc.steps_seen": torch.tensor(step, dtype=torch.int32)}
    opt_state = {"count": step, "m1": [torch.full((4, 8), w * 10)]}
    save_checkpoint(str(ckpt_dir), f"step_{step:08d}", params, opt_state,
                    step=step, best_wer=0.5)


def test_average_is_param_mean_and_meta_from_newest(tmp_path):
    from pytorch_end2end_speech_recognition_tpu_torch.cli.average_ckpts import (  # noqa: E501
        average_checkpoints,
        pick_last_n,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.training.checkpoint import (  # noqa: E501
        load_checkpoint,
    )

    for step, w in ((1, 1.0), (2, 2.0), (3, 6.0)):
        _save(tmp_path, step, w)
    tags = pick_last_n(str(tmp_path), 3)
    assert tags == ["step_00000003", "step_00000002", "step_00000001"]
    average_checkpoints(str(tmp_path), tags, "avg")
    got = load_checkpoint(str(tmp_path), "avg")
    np.testing.assert_allclose(got["params"]["enc.w"].numpy(),
                               np.full((4, 8), 3.0))
    assert int(got["params"]["enc.steps_seen"]) == 3
    np.testing.assert_allclose(got["opt_state"]["m1"][0].numpy(),
                               np.full((4, 8), 60.0))
    assert got["step"] == 3


def test_pick_last_n_subset_missing_and_warning(tmp_path, capsys):
    from pytorch_end2end_speech_recognition_tpu_torch.cli.average_ckpts import (  # noqa: E501
        pick_last_n,
    )

    _save(tmp_path, 1, 1.0)
    assert pick_last_n(str(tmp_path), 3) == ["step_00000001"]
    assert "WARNING" in capsys.readouterr().err
    for step in (2, 3, 4):
        _save(tmp_path, step, float(step))
    assert pick_last_n(str(tmp_path), 2) == ["step_00000004",
                                             "step_00000003"]
    with pytest.raises(FileNotFoundError):
        pick_last_n(str(tmp_path / "empty"), 2)


def test_out_tag_collision_rejected(tmp_path):
    from pytorch_end2end_speech_recognition_tpu_torch.cli.average_ckpts import (  # noqa: E501
        average_checkpoints,
        pick_last_n,
    )

    for step in (1, 2):
        _save(tmp_path, step, float(step))
    tags = pick_last_n(str(tmp_path), 2)
    for bad in ("last", "best", "step_00000001"):
        with pytest.raises(ValueError, match="collides"):
            average_checkpoints(str(tmp_path), tags, bad)
