"""The port's corpus converters (`..._torch/data/prep/`) against the JAX
package's on the fixture trees of tests/test_prep.py: the same manifests,
line for line (with the audio paths of the same tree), and the same
transcription parse."""

import importlib

import numpy as np
import pytest

from pytorch_end2end_speech_recognition_tpu.data.audio import write_wav
from pytorch_end2end_speech_recognition_tpu.data.flac import write_flac

JPREP = "pytorch_end2end_speech_recognition_tpu.data.prep"
TPREP = "pytorch_end2end_speech_recognition_tpu_torch.data.prep"


def _tone(n=4000, f=0.02):
    return (np.sin(np.arange(n) * f) * 0.4).astype(np.float32)


def _both(name: str):
    return (importlib.import_module(f"{JPREP}.{name}"),
            importlib.import_module(f"{TPREP}.{name}"))


def _same_manifests(tmp_path, name: str, argv, files) -> None:
    """Run both packages' `main(argv(out_dir))` and compare `files`."""
    jmod, tmod = _both(name)
    jmod.main(argv(tmp_path / "jax"))
    tmod.main(argv(tmp_path / "torch"))
    for f in files:
        want = (tmp_path / "jax" / f).read_text().splitlines()
        got = (tmp_path / "torch" / f).read_text().splitlines()
        assert got == want and want, f


def test_prep_an4_transcription_parse_matches_jax(tmp_path):
    text = ("<s> HELLO WORLD </s> (an406-fash-b)\n"
            "YES </s> (an407-mblw-a)\n"
            "<s> RUBOUT G M E F THREE NINE (cen1-fash-b)\n"
            "P I T T S B U R G H (an86-mblw-b)\n"
            "garbage line without id\n"
            "<s>  </s> (an1-empty-a)\n")
    p = tmp_path / "t.transcription"
    p.write_text(text)
    jmod, tmod = _both("prep_an4")
    assert tmod.parse_transcription(p) == jmod.parse_transcription(p)
    assert len(tmod.parse_transcription(p)) == 5


def test_prep_an4_manifests_match_jax(tmp_path):
    root = tmp_path / "an4"
    (root / "etc").mkdir(parents=True)
    (root / "wav" / "spk1").mkdir(parents=True)
    train_lines, test_lines = [], []
    for i in range(10):
        uid = f"an{i:03d}-spk1-b"
        write_wav(root / "wav" / "spk1" / f"{uid}.wav", _tone(3200 + 160 * i),
                  16000)
        train_lines.append(f"<s> WORD{i} UTT </s> ({uid})")
    for i in range(2):
        uid = f"te{i:03d}-spk1-b"
        write_wav(root / "wav" / "spk1" / f"{uid}.wav", _tone(3000), 16000)
        test_lines.append(f"<s> TEST {i} </s> ({uid})")
    train_lines.append("<s> MISSING AUDIO </s> (an999-spk9-b)")
    (root / "wav" / "spk1" / "an500-spk1-b.wav").write_bytes(b"not a wav")
    train_lines.insert(3, "<s> BROKEN </s> (an500-spk1-b)")
    (root / "etc" / "an4_train.transcription").write_text(
        "\n".join(train_lines))
    (root / "etc" / "an4_test.transcription").write_text(
        "\n".join(test_lines))
    _same_manifests(
        tmp_path, "prep_an4",
        lambda out: ["--root", str(root), "--out", str(out),
                     "--dev-fraction", "0.2"],
        ("train.jsonl", "dev.jsonl", "test.jsonl"))


def test_prep_wsj_manifests_match_jax(tmp_path):
    wavdir = tmp_path / "wavs"
    wavdir.mkdir()
    flist, trans = [], []
    for i in range(5):
        uid = f"011c020{i}"
        write_wav(wavdir / f"{uid}.wav", _tone(4800 + 16 * i), 16000)
        flist.append(str(wavdir / f"{uid}.wav"))
        trans.append(f"{uid.upper()} THE QUICK BROWN FOX {i}")
    trans.append("011C0299 NO AUDIO HERE")
    write_wav(wavdir / "011c0298.wav", _tone(1600), 16000)
    flist.append(str(wavdir / "011c0298.wav"))
    flist.append(str(wavdir / "does_not_exist.wav"))
    (tmp_path / "si.flist").write_text("\n".join(flist))
    (tmp_path / "si.trans").write_text("\n".join(trans))
    _same_manifests(
        tmp_path, "prep_wsj",
        lambda out: ["--index",
                     f"train_si={tmp_path}/si.flist:{tmp_path}/si.trans",
                     "--out", str(out)],
        ("train_si.jsonl",))


@pytest.mark.parametrize("ext", ["flac", "wav"])
def test_prep_librispeech_manifests_match_jax(tmp_path, ext):
    split = tmp_path / "LibriSpeech" / "dev-clean" / "84" / "121123"
    split.mkdir(parents=True)
    lines = []
    for i in range(4):
        uid = f"84-121123-{i:04d}"
        n = 16000 + 4000 * i
        if ext == "flac":
            write_flac(split / f"{uid}.flac", _tone(n), 16000)
        else:
            write_wav(split / f"{uid}.wav", _tone(n), 16000)
        lines.append(f"{uid} SOME LIBRI TEXT {i}")
    lines.append("84-121123-0099 NO AUDIO")
    (split / "84-121123.trans.txt").write_text("\n".join(lines))
    _same_manifests(
        tmp_path, "prep_librispeech",
        lambda out: ["--root", str(tmp_path / "LibriSpeech"), "--splits",
                     "dev-clean", "--out", str(out), "--ext", ext],
        ("dev-clean.jsonl",))
