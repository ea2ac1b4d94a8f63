"""ctypes bindings of the native host library (`asrnative.cpp`; the port of
the JAX package's `native/`): WAV and FLAC decode, the loader's
multithreaded batch fill, and the WER scorer's Levenshtein distance.

The library is built with g++ at its first use, never at import, into
`<checkout>/build/native/<hash of the source and flags>/`, so a checkout
builds once and rebuilds when the source changes. A failed build raises
with the compiler's output: there is no silent fallback (the JAX package
prints the failure and falls back to Python). With `ASR_TPU_NO_NATIVE`
set, nothing is built: `load_batch_native` decodes no row (the loader
reads every row in Python), the `read_*_native` functions raise, and the
scorer takes its numpy path (`enabled()` is False).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().with_name("asrnative.cpp")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
COMPILER = ["g++"]
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
MAX_SAMPLES = 16000 * 120

_I = ctypes.c_int
_L = ctypes.c_long
_PF = ctypes.POINTER(ctypes.c_float)
_PI = ctypes.POINTER(ctypes.c_int)
_READ = ([ctypes.c_char_p, _PF, _L, _PI], _L)
SIGNATURES = {
    "asr_read_wav": _READ,
    "asr_read_flac": _READ,
    "asr_read_audio": _READ,
    # paths, n, out, row_stride, lens, expect_sr, n_threads
    "asr_load_batch": ([ctypes.POINTER(ctypes.c_char_p), _L, _PF, _L, _PI,
                        _I, _I], _L),
    # a, n, b, m
    "asr_levenshtein": ([_PI, _L, _PI, _L], _L),
}


def enabled() -> bool:
    """False when `ASR_TPU_NO_NATIVE` is set."""
    return not os.environ.get("ASR_TPU_NO_NATIVE")


def build() -> Path:
    """Compile `asrnative.cpp` (once per source and flags); the library's
    path. Raises RuntimeError with the compiler's output on failure."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(COMPILER + FLAGS).encode())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / "libasrnative.so"
    if lib.exists():
        return lib
    if shutil.which(COMPILER[0]) is None:
        raise RuntimeError(f"building {SRC.name}: compiler {COMPILER[0]!r} "
                           "not found")
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libasrnative.so.{os.getpid()}.tmp"
    res = subprocess.run([*COMPILER, *FLAGS, str(SRC), "-o", str(tmp)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"building {SRC.name} failed "
                           f"({' '.join(COMPILER)}, exit {res.returncode}):\n"
                           + res.stdout + res.stderr)
    os.replace(tmp, lib)  # atomic: concurrent builds leave one library
    return lib


@functools.cache
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def get_lib() -> ctypes.CDLL | None:
    """The library, built on first call; None when disabled."""
    return _load() if enabled() else None


def _read_native(fn_name: str, path: str, max_samples: int):
    lib = get_lib()
    if lib is None:
        raise RuntimeError("the native library is disabled "
                           "(ASR_TPU_NO_NATIVE)")
    out = np.empty(max_samples, np.float32)
    sr = ctypes.c_int(0)
    n = getattr(lib, fn_name)(str(path).encode(), out.ctypes.data_as(_PF),
                              max_samples, ctypes.byref(sr))
    if n < 0:
        raise ValueError(f"{path}: native decode failed ({fn_name})")
    return out[:n].copy(), sr.value


def read_wav_native(path: str, max_samples: int = MAX_SAMPLES):
    """(float32 samples, sample rate) of a WAV file, by the C++ reader."""
    return _read_native("asr_read_wav", path, max_samples)


def read_flac_native(path: str, max_samples: int = MAX_SAMPLES):
    """(float32 samples, sample rate) of a FLAC file, by the C++ decoder."""
    return _read_native("asr_read_flac", path, max_samples)


def read_audio_native(path: str, max_samples: int = MAX_SAMPLES):
    """(float32 samples, sample rate): WAV or FLAC, by its header."""
    return _read_native("asr_read_audio", path, max_samples)


def load_batch_native(paths: list[str], out: np.ndarray, lens: np.ndarray,
                      expect_sr: int = 16000, n_threads: int = 0) -> int:
    """Decode `paths` in parallel into rows of the zeroed float32 (B, Ts)
    buffer `out` (each row cut to Ts samples), lengths into `lens` (int32).
    A row that fails to decode or whose rate is not `expect_sr` gets
    lens 0 and a zero row, for the caller to read in Python. Returns the
    rows decoded (0, decoding none, when disabled)."""
    lib = get_lib()
    if lib is None:
        return 0
    if out.dtype != np.float32 or not out.flags.c_contiguous:
        raise ValueError("out must be a C-contiguous float32 array")
    if lens.dtype != np.int32:
        raise ValueError("lens must be int32")
    if min(out.shape[0], lens.shape[0]) < len(paths):
        raise ValueError(f"{len(paths)} paths for {out.shape[0]} rows and "
                         f"{lens.shape[0]} lengths")
    arr = (ctypes.c_char_p * len(paths))(*[str(p).encode() for p in paths])
    return lib.asr_load_batch(arr, len(paths), out.ctypes.data_as(_PF),
                              out.shape[1], lens.ctypes.data_as(_PI),
                              expect_sr, n_threads)


def levenshtein(a, b) -> int:
    """Edit distance between two token sequences (any hashable tokens), by
    the C++ scorer."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("the native library is disabled "
                           "(ASR_TPU_NO_NATIVE)")
    sym = {t: i for i, t in enumerate(dict.fromkeys(list(a) + list(b)))}
    aa = np.asarray([sym[t] for t in a], np.int32)
    bb = np.asarray([sym[t] for t in b], np.int32)
    return int(lib.asr_levenshtein(aa.ctypes.data_as(_PI), len(aa),
                                   bb.ctypes.data_as(_PI), len(bb)))
