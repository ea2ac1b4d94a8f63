"""Host-side audio I/O: WAV read/write and resampling (the port's copy of
the JAX package's `data/audio.py`).

WAV parsing is pure numpy (PCM 8/16/24/32 and float); resampling is
polyphase via scipy; `read_audio` sniffs the container and decodes FLAC
with `data/flac.py`. The loader decodes a batch with the C++ decoder
(`native/`) first, and reads here the rows it leaves.
"""

from __future__ import annotations

import struct
import wave
from pathlib import Path

import numpy as np


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 mono samples in [-1, 1], sample_rate)."""
    path = str(path)
    with open(path, "rb") as f:
        header = f.read(12)
        if header[:4] != b"RIFF" or header[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            chunk_hdr = f.read(8)
            if len(chunk_hdr) < 8:
                break
            cid, size = struct.unpack("<4sI", chunk_hdr)
            if cid == b"fmt ":
                fmt = f.read(size)
                if size % 2:
                    f.read(1)
            elif cid == b"data":
                data = f.read(size)
                if size % 2:
                    f.read(1)
            else:
                f.seek(size + (size % 2), 1)
        if fmt is None or data is None:
            raise ValueError(f"{path}: missing fmt/data chunk")
    audio_fmt, n_ch, sr, _, _, bits = struct.unpack("<HHIIHH", fmt[:16])
    if audio_fmt == 0xFFFE and len(fmt) >= 26:  # WAVE_FORMAT_EXTENSIBLE
        (audio_fmt,) = struct.unpack("<H", fmt[24:26])
    if audio_fmt == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
            x = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            x = (x - ((x & 0x800000) << 1)).astype(np.float32) / 8388608.0
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif audio_fmt == 3:  # IEEE float
        dt = "<f4" if bits == 32 else "<f8"
        x = np.frombuffer(data, dtype=dt).astype(np.float32)
    else:
        raise ValueError(f"{path}: unsupported WAV format tag {audio_fmt}")
    if n_ch > 1:
        x = x.reshape(-1, n_ch).mean(axis=1)
    return np.ascontiguousarray(x, dtype=np.float32), sr


def write_wav(path: str | Path, x: np.ndarray, sr: int) -> None:
    """Write float32 [-1,1] mono samples as PCM16 WAV."""
    x16 = np.clip(np.asarray(x, dtype=np.float32), -1.0, 1.0)
    x16 = (x16 * 32767.0).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(x16.tobytes())


def resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resample to sr_out (parity with torchaudio resample)."""
    if sr_in == sr_out:
        return x
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(sr_in, sr_out)
    return resample_poly(x, sr_out // g, sr_in // g).astype(np.float32)


def read_audio(path: str | Path) -> tuple[np.ndarray, int]:
    """Container-sniffed decode: WAV or FLAC -> (float32 mono, sr)."""
    with open(str(path), "rb") as f:
        magic = f.read(4)
    if magic == b"fLaC":
        from pytorch_end2end_speech_recognition_tpu_torch.data.flac import read_flac

        return read_flac(path)
    return read_wav(path)


def load_audio(path: str | Path, target_sr: int = 16000) -> np.ndarray:
    """Read + resample to target_sr; the loader-facing entry point."""
    x, sr = read_audio(path)
    return resample(x, sr, target_sr)
