"""Where a step of the LSTM recurrence kernels spends its cycles, on the card.

Builds `csrc/lstm.cu` with `-DLSTM_PHASES` (its PHASE markers then read
clock64 in thread 0 of block 0) into `build/lstm_phases/`, launches the
two-direction forward and backward at both rungs' layer-0 shapes (B=32,
full lengths, random inputs from a seed), and prints the cycles per
dependent step of each phase. The kernel library itself compiles the
markers to nothing. Run from the checkout's root on a machine with the
card and nvcc:

    python3 pytorch_end2end_speech_recognition_tpu_torch/csrc/probe/lstm_phases.py
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent
OUT = CSRC.parents[1] / "build" / "lstm_phases"
SHAPES = (("an4_ctc layer 0", 32, 800, 256), ("wsj_las layer 0", 32, 400, 320))
FWD = {7: "loop top", 0: "wait for h", 1: "gate dot", 2: "slice shuffles",
       3: "k-warp sums", 4: "cell, stores, sends"}
BWD = {6: "loop top", 0: "wait for dh", 1: "dgates", 2: "block barrier",
       3: "dh product", 4: "shuffles, unit-warp sums", 5: "sends"}


def build() -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / "liblstm_phases.so"
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-Xcompiler", "-fPIC", "-shared", "-DLSTM_PHASES", "-I",
                    str(CSRC), str(CSRC / "lstm.cu"), "-o", str(lib)],
                   check=True)
    so = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    so.lstm_fwd_launch.argtypes = [P] * 5 + [I] * 4 + [P]
    so.lstm_bwd_launch.argtypes = [P] * 9 + [I] * 4 + [P]
    so.lstm_bwd_splits.argtypes = [I] * 4
    so.lstm_phase_read.argtypes = [P]
    return so


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    so = build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = (ctypes.c_longlong * 16)()
    stream = torch.cuda.current_stream().cuda_stream
    for tag, B, T, H in SHAPES:
        xg = torch.randn(2, B, T, 4 * H, device=dev, generator=gen) * 0.5
        whh = (torch.rand(2, H, 4 * H, device=dev, generator=gen) * 2 - 1) \
            * H ** -0.5
        g = torch.randn(2, B, T, H, device=dev, generator=gen)
        lens = torch.full((B,), T, dtype=torch.int32, device=dev)
        h, c = torch.empty_like(g), torch.empty_like(g)
        dx, dw = torch.empty_like(xg), torch.empty_like(whh)
        part = xg.new_empty(2, so.lstm_bwd_splits(2, B, T, H), H, 4 * H)
        for _ in range(2):  # the second launch of each is the one read
            assert so.lstm_fwd_launch(xg.data_ptr(), whh.data_ptr(),
                                      lens.data_ptr(), h.data_ptr(),
                                      c.data_ptr(), 2, B, T, H, stream) == 0
            assert so.lstm_bwd_launch(
                xg.data_ptr(), whh.data_ptr(), lens.data_ptr(), h.data_ptr(),
                c.data_ptr(), g.data_ptr(), dx.data_ptr(), dw.data_ptr(),
                part.data_ptr(), 2, B, T, H, stream) == 0
        assert so.lstm_phase_read(out) == 0
        for name, phases, off in (("forward", FWD, 0), ("backward", BWD, 8)):
            total = sum(out[off + i] for i in phases)
            print(f"{tag} (two directions, B={B}, T={T}, H {H}), {name}: "
                  f"{total / T:.0f} cycles per step: " + ", ".join(
                      f"{v} {out[off + i] / T:.0f}"
                      for i, v in phases.items()), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
