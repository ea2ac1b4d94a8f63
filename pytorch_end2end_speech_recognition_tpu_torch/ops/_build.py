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
    # audio, basis (f32, (win, 2F)), basis_prev, mel, flens, out, B, Ts,
    # n_frames, hop, win, F, M, stream
    "logmel_f32_launch": [_P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _I, _P],
    # audio, basis_t (bf16, (2F, win)), basis_prev, mel_t, bands, flens,
    # out, B, Ts, n_frames, hop, win, F, M, vec4, stream
    "logmel_bf16_launch": [_P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "logmel_smem_bytes": [],
    # diag, out, out_is_bf16, N, T, P, stream
    "toeplitz_launch": [_P, _P, _I, _I, _I, _I, _P],
    # g, out, in_is_bf16, N, T, P, stream
    "toeplitz_reduce_launch": [_P, _P, _I, _I, _I, _I, _P],
    # q, k, v, bias, bias_ld, lens, out, lse, B, T, H, Dh, sm_scale, stream
    "attention_launch": [_P, _P, _P, _P, _I, _P, _P, _P,
                         _I, _I, _I, _I, _F, _P],
    # q, k, v, g, bias, bias_ld, lens, lse, delta, work, dq, dk, dv, dbias,
    # B, T, H, Dh, sm_scale, stream
    "attention_bwd_launch": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                             _P, _P, _I, _I, _I, _I, _F, _P],
    # q, k, v, diag, lens, out, lse, B, T, H, Dh, sm_scale, stream
    "flash_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    # q, k, v, g, diag, lens, lse, delta, work, dq, dk, dv, part, ddiag,
    # B, T, H, Dh, sm_scale, stream
    "flash_bwd_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _P, _P, _I, _I, _I, _I, _F, _P],
    # lp, skip, sok, tlen, last, alpha, ll, B, T, S, stream
    "ctc_alpha_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # lp, skip, sok, tlen, last, alpha, ll, g, grad, B, T, S, stream
    "ctc_beta_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _P],
    # lp, r_state, last, lengths, cand, r_init (or null), psi, B, K, C, T,
    # V, stream
    "ctc_prefix_score_launch": [_P] * 7 + [_I, _I, _I, _I, _I, _P],
    # lp, r_state, last, lengths, parent, tok, is_ext, r_init (or null),
    # out, B, K, T, V, stream
    "ctc_prefix_select_launch": [_P] * 9 + [_I, _I, _I, _I, _P],
    # bwd, D, B, H, out (int[7]): the LSTM kernels' cluster plan
    "lstm_plan": [_I, _I, _I, _I, _P],
    # xg, whh, lens, h_all, c_all, D, B, T, H, stream
    "lstm_fwd_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # D, B, T, H -> the dW_hh product's row splits S
    "lstm_bwd_splits": [_I, _I, _I, _I],
    # xg, whh, lens, h_all, c_all, g, dxg, dwhh, part, D, B, T, H, stream
    "lstm_bwd_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _P],
    # x, gamma, beta, w1, b1, w2, b2, seed, out, x_is_bf16, R, D, F,
    # scale, rate, keep_scale, stream
    "ffn_fwd_launch": [_P] * 9 + [_I, _I, _I, _I, _F, _F, _F, _P],
    # R, D, F, out (int[4]): the backward's plan (S, n_part, n_db, af)
    "ffn_bwd_plan": [_I, _I, _I, _P],
    # the wgmma kernels' dynamic shared memory in bytes (for reports):
    # attention by kernel (0 forward, 1 backward delta pre-pass, 2 backward
    # main, 3 dbias) and bias mode (0 none, 1 dense, 2 diagonals); the FFN
    # kernels at D 256 (0 forward, 1 backward rows, 2 backward weights)
    "attention_smem_bytes": [_I, _I],
    "ffn_smem_bytes": [_I],
    # x, g, gamma, beta, w1, b1, w2, seed, dx, yw, g2w, aw, hw, part, dw1p,
    # dw2p, db1p, dgamma, dbeta, dw1, db1, dw2, db2, x_is_bf16, R, D, F, S,
    # scale, rate, keep_scale, stream
    "ffn_bwd_launch": [_P] * 23 + [_I, _I, _I, _I, _I, _F, _F, _F, _P],
    # x, lens, w1p, w2r, b2p, out, B, T, n_mels, C, stream
    "subsample_launch": [_P] * 6 + [_I, _I, _I, _I, _P],
    # n_mels, C, out (int[5]): the subsampling kernel's plan
    "subsample_plan": [_I, _I, _P],
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
    """Hash of every source and header in csrc/ and the flags: a change to
    any of them rebuilds."""
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
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
