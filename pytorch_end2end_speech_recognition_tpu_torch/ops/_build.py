"""Build and load the hand-written CUDA kernels in `csrc/`.

Each `csrc/*.cu` has a plain C interface (no PyTorch headers), so `nvcc`
compiles it in seconds. The sources compile in parallel, one `nvcc` each,
for `sm_90a`, then link into one shared library that `ctypes` loads. The
library lands in `<checkout>/build/kernels/<hash of the sources>/`, so a
checkout builds once and rebuilds only when a source changes. Nothing is
built at import: the first kernel launch calls `load()`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argument types. Every entry returns the
# cudaError_t of its launch (0 on success).
SIGNATURES = {
    # audio, basis (f32, (win, 2F)) or basis_t (bf16, (2F, win)),
    # basis_prev, mel, flens, out, B, Ts, n_frames, hop, win, F, M, stream
    "logmel_f32_launch": [_P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _I, _P],
    "logmel_bf16_launch": [_P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _I, _P],
    # diag, out, out_is_bf16, N, T, P, stream
    "toeplitz_launch": [_P, _P, _I, _I, _I, _I, _P],
    # g, out, in_is_bf16, N, T, P, stream
    "toeplitz_reduce_launch": [_P, _P, _I, _I, _I, _I, _P],
    # q, k, v, bias, bias_ld, lens, out, lse, B, T, H, Dh, sm_scale, stream
    "attention_launch": [_P, _P, _P, _P, _I, _P, _P, _P,
                         _I, _I, _I, _I, _F, _P],
    # q, k, v, g, bias, bias_ld, lens, lse, delta, dq, dk, dv, dbias,
    # B, T, H, Dh, sm_scale, stream
    "attention_bwd_launch": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                             _P, _I, _I, _I, _I, _F, _P],
    # lp, skip, sok, tlen, last, alpha, ll, B, T, S, stream
    "ctc_alpha_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # lp, skip, sok, tlen, last, alpha, ll, g, grad, B, T, S, stream
    "ctc_beta_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _P],
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels are "
                       "built from csrc/ at first use")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH + FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> tuple[Path, str]:
    """Compile every csrc/*.cu (in parallel) and link them into one shared
    library. Returns (library path, the compilers' combined output, which
    holds each kernel's register and shared-memory use from `ptxas -v`)."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / "libkernels.so"
    log_path = out_dir / "build.log"
    if lib.exists() and log_path.exists():
        return lib, log_path.read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in _sources():
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *ARCH, *FLAGS, "-I", str(CSRC), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src.name}\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    tmp = out_dir / f"libkernels.so.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", "-o", str(tmp),
         *[str(o) for _, o, _ in procs]],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError("linking the kernels failed:\n" + link.stdout
                           + link.stderr)
    text = "\n".join(log)
    os.replace(tmp, lib)
    log_path.write_text(text)
    return lib, text


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built on first call, with argtypes declared."""
    lib_path, _ = build()
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.kernels_error_string.argtypes = [ctypes.c_int]
    lib.kernels_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        msg = load().kernels_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} "
                           f"({msg})")
