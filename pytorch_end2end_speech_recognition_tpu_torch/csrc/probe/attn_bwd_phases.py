"""Where a query tile of the attention backward's main kernel spends its
cycles, on the card.

Builds `csrc/attention.cu` with `-DATTN_PHASES` (its PHASE markers then read
clock64 in consumer thread 0 of the first and of the last 128-key block of
batch row 0, head 0) into `build/attn_bwd_phases/`, runs the forward (for
the lse) and the backward at the flagship's dense shape (B=32, T 750, H 4,
a (4, 768, 768) bias) and the long-audio flash shape (B=16, T 1,638, H 4,
diagonals), full lengths, random inputs from a seed, and prints the cycles
per query tile of each phase. The kernel library itself compiles the
markers to nothing. Run from the checkout's root on a machine with the card
and nvcc:

    python3 pytorch_end2end_speech_recognition_tpu_torch/csrc/probe/attn_bwd_phases.py
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent
OUT = CSRC.parents[1] / "build" / "attn_bwd_phases"
PHASES = {0: "wait for the stage", 1: "S, dP issued, S awaited",
          2: "P^T, dV issued", 3: "dP awaited", 4: "dS^T, its stores",
          5: "dK issued", 6: "consumers' barrier", 7: "dQ issued",
          8: "dV, dK awaited", 9: "diagonal sums", 10: "dQ awaited",
          11: "dQ partial stored", 12: "block start: K and V awaited"}


def build() -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / "libattn_bwd_phases.so"
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-Xcompiler", "-fPIC", "-shared", "-DATTN_PHASES", "-I",
                    str(CSRC), str(CSRC / "attention.cu"), "-o", str(lib)],
                   check=True)
    so = ctypes.CDLL(str(lib))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    so.attention_launch.argtypes = [P, P, P, P, I, P, P, P, I, I, I, I, F, P]
    so.flash_launch.argtypes = [P] * 7 + [I, I, I, I, F, P]
    so.attention_bwd_launch.argtypes = [P] * 5 + [I] + [P] * 8 + [I] * 4 + [
        F, P]
    so.flash_bwd_launch.argtypes = [P] * 14 + [I] * 4 + [F, P]
    so.attn_phase_read.argtypes = [P]
    return so


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    so = build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = (ctypes.c_longlong * 32)()
    stream = torch.cuda.current_stream().cuda_stream
    for tag, B, T, H, flash in (("dense, B=32 x T 750", 32, 750, 4, False),
                                ("flash, B=16 x T 1638", 16, 1638, 4, True)):
        D, P = H * 64, -(-T // 8) * 8
        mk = lambda: (torch.randn(B, T, D, device=dev, generator=gen) * 0.5
                      ).to(torch.bfloat16)
        q, k, v, g = mk(), mk(), mk(), mk()
        lens = torch.full((B,), T, dtype=torch.int32, device=dev)
        out_, dq, dk, dv = (torch.empty_like(q) for _ in range(4))
        lse = torch.empty(B, H, T, device=dev)
        delta = torch.empty_like(lse)
        n_kb, n_qt = -(-T // 128), -(-T // 64)
        work = torch.empty(B * H * n_kb * n_qt * 4096, device=dev)
        ptrs = lambda *ts: [t.data_ptr() for t in ts]
        if flash:
            diag = torch.randn(H, 2 * T - 1, device=dev, generator=gen) * 4
            part = torch.empty(B * n_kb * H * n_qt, 192, device=dev)
            ddiag = torch.empty_like(diag)
            assert so.flash_launch(*ptrs(q, k, v, diag, lens, out_, lse), B,
                                   T, H, 64, 0.125, stream) == 0
            launch = lambda: so.flash_bwd_launch(
                *ptrs(q, k, v, g, diag, lens, lse, delta, work, dq, dk, dv,
                      part, ddiag), B, T, H, 64, 0.125, stream)
        else:
            bias = (torch.randn(H, P, P, device=dev, generator=gen) * 4).to(
                torch.bfloat16)
            dbias = torch.empty_like(bias)
            assert so.attention_launch(*ptrs(q, k, v, bias), P,
                                       *ptrs(lens, out_, lse), B, T, H, 64,
                                       0.125, stream) == 0
            launch = lambda: so.attention_bwd_launch(
                *ptrs(q, k, v, g, bias), P,
                *ptrs(lens, lse, delta, work, dq, dk, dv, dbias), B, T, H,
                64, 0.125, stream)
        for _ in range(2):  # the second launch is the one read
            assert launch() == 0
        assert so.attn_phase_read(out) == 0
        for off, which in ((0, "first key block"), (16, "last key block")):
            total = sum(out[off + i] for i in PHASES)
            print(f"{tag}, {which}: {total / n_qt:.0f} cycles per query "
                  "tile: " + ", ".join(f"{v} {out[off + i] / n_qt:.0f}"
                                       for i, v in PHASES.items()),
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
