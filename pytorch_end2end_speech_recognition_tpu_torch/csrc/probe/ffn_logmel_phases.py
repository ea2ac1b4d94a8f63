"""Where the FFN backward's row-tile kernel (launch A) and the log-mel kernel
spend their cycles, on the card.

Builds `csrc/ffn.cu` with `-DFFN_PHASES` and `csrc/logmel.cu` with
`-DLOGMEL_PHASES` (their PHASE markers then read clock64 in consumer thread 0
of block 0; the kernel library compiles them to nothing) with
`csrc/toeplitz.cu` (the error strings) into `build/ffn_logmel_phases/`, points
the port's wrappers at that library, runs `ffn_bwd` at the flagship's rows (R
= 24,000, D 256, F 1,024, rate 0.1, bf16) and `logmel` on B=32 x 30 s of
random audio (full rows, the flagship's front end, bf16 basis), and prints
the cycles per tile of each phase, with block 0's tile count. Run from the
checkout's root on a machine with the card and nvcc:

    python3 pytorch_end2end_speech_recognition_tpu_torch/csrc/probe/ffn_logmel_phases.py
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent
ROOT = CSRC.parents[1]
OUT = ROOT / "build" / "ffn_logmel_phases"
FFN_PHASES = {0: "LayerNorm, g2 (and their stores)", 1: "wait for W1, W2",
              2: "issue gy, ga, h1", 3: "await the products",
              4: "a, gh1 (stores, db1 sums)", 5: "LayerNorm backward"}
LOGMEL_PHASES = {0: "frames to shared memory", 1: "wait for the basis",
                 2: "issue the DFT", 3: "power", 4: "mel sums",
                 5: "await the DFT, release", 6: "log, stores",
                 7: "the barrier after the power"}


def build():
    sys.path.insert(0, str(ROOT))
    from pytorch_end2end_speech_recognition_tpu_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / "libffn_logmel_phases.so"
    subprocess.run(["/usr/local/cuda/bin/nvcc", *_build.ARCH, *_build.FLAGS,
                    "-shared", "-DFFN_PHASES", "-DLOGMEL_PHASES", "-I",
                    str(CSRC), str(CSRC / "ffn.cu"), str(CSRC / "logmel.cu"),
                    str(CSRC / "toeplitz.cu"), "-o", str(lib)],
                   check=True, capture_output=True)
    so = ctypes.CDLL(str(lib))
    for name in ("ffn_bwd_plan", "ffn_bwd_launch", "logmel_bf16_launch"):
        fn = getattr(so, name)
        fn.argtypes = _build.SIGNATURES[name]
        fn.restype = ctypes.c_int
    so.kernels_error_string.argtypes = [ctypes.c_int]
    so.kernels_error_string.restype = ctypes.c_char_p
    for name in ("ffn_phase_read", "logmel_phase_read"):
        getattr(so, name).argtypes = [ctypes.c_void_p]
    _build.load = lambda: so  # the wrappers launch from this library
    return so


def show(tag: str, cycles, names: dict, tiles: int) -> None:
    total = sum(cycles[i] for i in names)
    print(f"{tag}: {total / tiles:.0f} cycles per tile over block 0's "
          f"{tiles} tiles: " + ", ".join(
              f"{v} {cycles[i] / tiles:.0f}" for i, v in names.items()),
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    so = build()
    from pytorch_end2end_speech_recognition_tpu_torch.ops import frontend as fe
    from pytorch_end2end_speech_recognition_tpu_torch.ops.ffn_kernel import (
        ffn_bwd,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops.frontend_kernel import (
        logmel,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.utils import device as dv
    from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
        FrontendConfig,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cyc = (ctypes.c_longlong * 16)()

    R, D, F = 24000, 256, 1024
    r = lambda *s: torch.randn(*s, device=dev, generator=gen)  # noqa: E731
    bf = torch.bfloat16
    x, g = r(R, D).to(bf), r(R, D).to(bf)
    w = (1.0 + 0.5 * r(D), 0.5 * r(D), (r(F, D) * D ** -0.5).to(bf),
         (0.5 * r(F)).to(bf), (r(D, F) * F ** -0.5).to(bf), (0.5 * r(D)).to(bf))
    seed = torch.tensor([7], dtype=torch.int32, device=dev)
    for _ in range(2):  # the second launch is the one read
        ffn_bwd(x, g, *w, seed, 0.1, 0.5)
    assert so.ffn_phase_read(cyc) == 0
    tiles = len(range(0, -(-R // 128), min(sms, -(-R // 128))))
    show(f"ffn_bwd launch A (R {R}, D {D}, F {F})", cyc, FFN_PHASES, tiles)

    B, Ts = 32, 480000
    front = fe.Frontend(FrontendConfig(impl="cuda", dft_dtype="bfloat16"), dev)
    audio = 0.1 * torch.randn(B, Ts, device=dev, generator=gen)
    T = front.n_frames(Ts)
    flens = front.frame_lens(torch.full((B,), Ts, device=dev))
    for _ in range(2):
        logmel(audio, front.basis, front.basis_prev, front.mel_b, front.hop,
               T, flens, plan=(front.mel_bands, front.mel_t))
    assert so.logmel_phase_read(cyc) == 0
    n_tiles = B * -(-T // 128)
    tiles = len(range(0, n_tiles, min(sms, n_tiles)))
    show(f"logmel (B={B} x 30 s, {T} frames)", cyc, LOGMEL_PHASES, tiles)
    print(dv.card_info())
    return 0


if __name__ == "__main__":
    sys.exit(main())
