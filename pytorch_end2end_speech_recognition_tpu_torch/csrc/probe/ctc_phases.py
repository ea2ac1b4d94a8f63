"""Where a dependent step of the CTC lattice kernels (TPU kernels 9 and 10)
spends its cycles, on the card, for any checkout of the port.

    python3 pytorch_end2end_speech_recognition_tpu_torch/csrc/probe/ctc_phases.py [ROOT ...]

For each ROOT (a checkout's root directory; default: the checkout holding
this script), in a fresh process each, it builds ROOT's `csrc/ctc.cu` with
`-DCTC_PHASES` (its PHASE markers then read clock64 in block 0: lane 0 of
each warp; the kernel library compiles them to nothing) and
`csrc/toeplitz.cu` (the error strings) into `build/ctc_phases/`, points the
port's wrappers at that library, runs `ctc_alpha` and `ctc_beta` at the
flagship's lattice (B=32, T' 750, U 64, S 129; row 0, the one block 0 runs,
has all 750 frames) and prints, for each warp, the cycles of each phase
over the row's frames. A `ctc.cu` without markers (the earlier kernels:
one thread a lattice state, a block barrier a frame) gets them inserted at
its statements first (`THREAD_MARKS`, thread 0 only); there PHASE_USE(x)
makes the step wait for x, so a load's latency shows where it is awaited.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve()
MACROS = r"""
#ifdef CTC_PHASES
__device__ long long ctc_phase_cycles[16];
__device__ float ctc_phase_sink;
#define PHASES_BEGIN \
  long long ph_last_ = clock64(), ph_acc_[8] = {0, 0, 0, 0, 0, 0, 0, 0}; \
  float ph_sink_ = 0.f;
#define PHASE(i)                        \
  do {                                  \
    const long long c_ = clock64();     \
    ph_acc_[i] += c_ - ph_last_;        \
    ph_last_ = c_;                      \
  } while (0)
#define PHASE_USE(x) asm volatile("max.f32 %0, %0, %1;" : "+f"(ph_sink_) : "f"(x))
#define PHASES_END(off)                                          \
  if (threadIdx.x == 0 && blockIdx.x == 0) {                     \
    for (int i_ = 0; i_ < 8; ++i_) ctc_phase_cycles[(off) + i_] = ph_acc_[i_]; \
    ctc_phase_sink = ph_sink_;                                   \
  }
extern "C" int ctc_phase_read(long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(out, ctc_phase_cycles, 16 * sizeof(long long));
  return (int)e;
}
#endif
"""
# markers for the one-thread-a-state kernels: (statement, its occurrence,
# lines after it (0 = before it), text inserted)
THREAD_MARKS = (
    ("float lpt = in ? lpb[s] : NEG_INF;", 0, 1, "PHASES_BEGIN"),
    ("for (int t = 0; t < T; ++t) {", 0, 1, "PHASE_USE(lpt); PHASE(0);"),
    (": NEG_INF;", 0, 1, "PHASE(1);"),
    ("cur = nw;", 0, 1, "PHASE(2);"),
    ("__syncthreads();", 0, 0, "PHASE(3);"),
    ("__syncthreads();", 0, 1, "PHASE(4);"),
    ("lpt = lp_next;", 0, 2, "PHASES_END(0)"),
    ("float at = in ? ab[(size_t)(T - 1) * S + s] : NEG_INF;", 0, 1,
     "PHASES_BEGIN"),
    ("for (int k = 0; k < T; ++k) {", 0, 1,
     "PHASE_USE(lpt); PHASE_USE(at); PHASE(0);"),
    ("a_next = ab[(size_t)(t - 1) * S + s];", 0, 2, "PHASE(1);"),
    ("cur = nb;", 0, 1, "PHASE(2);"),
    ("__syncthreads();", 2, 0, "PHASE(3);"),
    ("__syncthreads();", 2, 1, "PHASE(4);"),
    ("at = a_next;", 0, 2, "PHASES_END(8)"),
)
THREAD_PHASES = {"alpha": {0: "wait for this frame's lp (loaded a step ahead)",
                        1: "issue the next frame's load",
                        2: "lse (with the neighbours' shared reads)",
                        3: "stores (shared, alpha)", 4: "block barrier"},
              "beta": {0: "wait for this frame's lp, alpha",
                       1: "issue the next frame's loads",
                       2: "lse (with the neighbours' shared reads)",
                       3: "gradient (expf), its store, the shared store",
                       4: "block barrier"}}
# the one-warp chains: (warp, its role, its phases) of each kernel's block
PRODUCER = {0: "wait for a free stage", 1: "issue the copies"}
WARPS = {"alpha": ((0, "chain", {0: "wait for the ring at a chunk's start",
                                 1: "steps (shuffle, lse, alpha stores)",
                                 2: "the carry to frames past tlen"}),
                   (1, "producer", PRODUCER)),
         "beta": ((0, "chain", {0: "wait for the ring at a chunk's start",
                                1: "steps (shuffles, lse, betas to shared "
                                   "memory)"}),
                  (1, "producer", PRODUCER),
                  (2, "gradient", {0: "wait for a chunk's betas",
                                   1: "gradients (ex2) and their stores",
                                   2: "zeros past tlen"}))}
B, T, V, U = 32, 750, 64, 64


def instrument(src: str) -> tuple[str, dict]:
    """(ctc.cu with the phase macros and markers, the phase names)."""
    head, sep, rest = src.partition("namespace {")
    if "CTC_PHASES" in src:
        return src, WARPS
    lines = rest.split("\n")
    inserts = []
    for stmt, occ, after, text in THREAD_MARKS:
        hits = [i for i, ln in enumerate(lines) if ln.strip() == stmt]
        i = hits[occ] + after
        indent = len(lines[hits[occ]]) - len(lines[hits[occ]].lstrip())
        inserts.append((i, " " * indent + text))
    for i, text in sorted(inserts, key=lambda x: -x[0]):
        lines.insert(i, text)
    return head + MACROS + sep + "\n".join(lines), THREAD_PHASES


def run(root: Path) -> int:
    sys.path.insert(0, str(root))
    import torch

    from pytorch_end2end_speech_recognition_tpu_torch.ops import _build
    from pytorch_end2end_speech_recognition_tpu_torch.ops.ctc import (
        lattice_inputs,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops import ctc_kernel
    from pytorch_end2end_speech_recognition_tpu_torch.ops.ctc_kernel import (
        ctc_alpha,
        ctc_beta,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.utils import device as dv

    csrc = _build.CSRC
    out = root / "build" / "ctc_phases"
    out.mkdir(parents=True, exist_ok=True)
    src, phases = instrument((csrc / "ctc.cu").read_text())
    (out / "ctc_phases.cu").write_text(src)
    lib = out / "libctc_phases.so"
    subprocess.run(["/usr/local/cuda/bin/nvcc", *_build.ARCH, *_build.FLAGS,
                    "-shared", "-DCTC_PHASES", "-I", str(csrc),
                    str(out / "ctc_phases.cu"), str(csrc / "toeplitz.cu"),
                    "-o", str(lib)], check=True, capture_output=True)
    so = ctypes.CDLL(str(lib))
    for name in ("ctc_alpha_launch", "ctc_beta_launch"):
        fn = getattr(so, name)
        fn.argtypes = _build.SIGNATURES[name]
        fn.restype = ctypes.c_int
    so.kernels_error_string.argtypes = [ctypes.c_int]
    so.kernels_error_string.restype = ctypes.c_char_p
    so.ctc_phase_read.argtypes = [ctypes.c_void_p]
    _build.load = lambda: so  # the wrappers launch from this library

    card = dv.card_info()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)
    tlen = torch.full((B,), T, dtype=torch.int64, device=dev)
    tlen[1::2] = torch.randint(T // 30, T + 1, (B // 2,), device=dev,
                               generator=gen)
    logits = torch.randn(B, T, V, device=dev, generator=gen)
    labels = 1 + torch.cumsum(torch.randint(1, V - 1, (B, U), device=dev,
                                            generator=gen), 1) % (V - 1)
    lens = torch.minimum(torch.randint(1, U + 1, (B,), device=dev,
                                       generator=gen), tlen // 2)
    labels = labels * (torch.arange(U, device=dev)[None, :] < lens[:, None])
    kw = {"pad_to": ctc_kernel.STATE_ALIGN} if phases is WARPS else {}
    lat, skip, sok = lattice_inputs(logits, labels, lens, **kw)
    for _ in range(2):  # the second launch of each is the one read
        alpha, ll = ctc_alpha(lat, skip, sok, tlen, 2 * lens)
        ctc_beta(lat, skip, sok, tlen, 2 * lens, alpha, ll,
                 torch.ones(B, device=dev))
    cyc = (ctypes.c_longlong * 256)()
    assert so.ctc_phase_read(cyc) == 0
    steps = int(tlen[0])
    print(f"== {root}: lattice {tuple(lat.shape)}, row 0 {steps} frames; "
          f"{card}", flush=True)
    if phases is THREAD_PHASES:  # thread 0 only
        rows = [(name, off, "", phases[name])
                for name, off in (("alpha", 0), ("beta", 8))]
    else:  # lane 0 of each warp
        rows = [(name, base + 8 * w, f", {who}", names)
                for name, base in (("alpha", 0), ("beta", 128))
                for w, who, names in phases[name]]
    for name, off, who, names in rows:
        total = sum(cyc[off + i] for i in names)
        print(f"ctc_{name}{who}: {total / steps:.0f} cycles per dependent "
              "step: " + ", ".join(f"{v} {cyc[off + i] / steps:.1f}"
                                   for i, v in names.items()), flush=True)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    if len(sys.argv) == 2 and sys.argv[1].startswith("--one="):
        return run(Path(sys.argv[1][6:]).resolve())
    roots = [str(Path(r).resolve()) for r in sys.argv[1:]] or [
        str(HERE.parents[3])]
    rc = 0
    for root in roots:
        env = dict(os.environ)
        env.pop("PYTHONPATH", None)
        rc |= subprocess.run([sys.executable, str(HERE), f"--one={root}"],
                             cwd=root, env=env).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
