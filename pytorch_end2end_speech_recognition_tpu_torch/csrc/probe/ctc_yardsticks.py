"""The CTC lattice kernels (TPU kernels 9 and 10) against `F.ctc_loss`, on
the card, for any checkout of the port.

    python3 pytorch_end2end_speech_recognition_tpu_torch/csrc/probe/ctc_yardsticks.py [ROOT ...]

For each ROOT (a checkout's root directory; default: the checkout holding
this script), in a fresh process each, it builds that checkout's kernels and
times, at every lattice shape of the training paths (`SHAPES`):
- `ctc_alpha` in turns with `F.ctc_loss` forward,
- `ctc_beta` in turns with `F.ctc_loss` forward + backward (autograd),
on the lattice as that checkout's `ctc_loss(impl='cuda')` builds it
(`lattice_inputs(..., pad_to=STATE_ALIGN)` where the checkout has it), with ragged
lengths drawn as `chip_smoke.py` [3g] draws them: even rows full, odd rows
from T/30 to T frames, labels without repeats, at most half a row's frames,
the last row a pad row. It prints each time, the bound (each input read
once, each output written once, at the unpadded S), the microseconds per
dependent step (kernel time over the longest row's frames) and the card's
name and power limit. Turns: 5 windows, each timing the two in order and
then in reverse, 20 launches a timing (CUDA events); the medians. Several
ROOTs run in the order given, so `parent change change parent` compares two
commits on one card.
"""

from __future__ import annotations

import inspect
import os
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve()
# (tag, B, T', vocab, U): the lattice of each training path, S = 2U + 1
SHAPES = (("flagship 30 s", 32, 750, 64, 64),
          ("rung 3", 32, 750, 256, 128),
          ("long audio", 16, 1638, 64, 128),
          ("an4_ctc", 32, 798, 32, 200),
          ("wsj_las", 32, 50, 32, 200))
HBM_BYTES_PER_S = 3.35e12


def turns_ms(fns: dict, windows: int = 5, iters: int = 20) -> dict:
    import torch

    for fn in fns.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    samples = {k: [] for k in fns}
    order = list(fns) + list(fns)[::-1]
    for _ in range(windows):
        for k in order:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(iters):
                fns[k]()
            b.record()
            b.synchronize()
            samples[k].append(a.elapsed_time(b) / iters)
    return {k: statistics.median(v) for k, v in samples.items()}


def ctc_case(B, T, V, U, gen, dev):
    """(logits (B, T, V), frame lens, labels (B, U), label lens): ragged as
    chip_smoke.py [3g] draws them."""
    import torch

    tlen = torch.full((B,), T, dtype=torch.int64, device=dev)
    tlen[1::2] = torch.randint(max(1, T // 30), T + 1, (B // 2,), device=dev,
                               generator=gen)
    logits = torch.randn(B, T, V, device=dev, generator=gen)
    steps = torch.randint(1, V - 1, (B, U), device=dev, generator=gen)
    labels = 1 + torch.cumsum(steps, 1) % (V - 1)          # never a repeat
    lens = torch.minimum(
        torch.randint(1, U + 1, (B,), device=dev, generator=gen), tlen // 2)
    lens[B - 1] = 0
    labels = labels * (torch.arange(U, device=dev)[None, :] < lens[:, None])
    return logits, tlen, labels, lens


def run(root: Path) -> int:
    sys.path.insert(0, str(root))
    import torch
    import torch.nn.functional as F

    import pytorch_end2end_speech_recognition_tpu_torch as pkg
    from pytorch_end2end_speech_recognition_tpu_torch.ops.ctc import (
        lattice_inputs,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops import ctc_kernel
    from pytorch_end2end_speech_recognition_tpu_torch.ops.ctc_kernel import (
        ctc_alpha,
        ctc_beta,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.utils import device as dv

    dv.set_tf32(False)
    card = dv.card_info()
    dev = torch.device("cuda")
    pad = ({"pad_to": ctc_kernel.STATE_ALIGN}
           if "pad_to" in inspect.signature(lattice_inputs).parameters else {})
    print(f"== {root} (package {Path(pkg.__file__).parent}; lattice "
          f"{pad or 'unpadded'}); {card}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(10)
    for tag, B, T, V, U in SHAPES:
        logits, tlen, labels, lens = ctc_case(B, T, V, U, gen, dev)
        lat, skip, sok = lattice_inputs(logits, labels, lens, **pad)
        last = 2 * lens
        alpha, ll = ctc_alpha(lat, skip, sok, tlen, last)
        g = torch.ones(B, device=dev)
        lp_t = F.log_softmax(logits, -1).transpose(0, 1).detach() \
            .requires_grad_()

        def lib_fwd():
            return F.ctc_loss(lp_t, labels, tlen, lens, reduction="none",
                              zero_infinity=True)

        ta = turns_ms({
            "kernel": lambda: ctc_alpha(lat, skip, sok, tlen, last),
            "library": lib_fwd})
        tb = turns_ms({
            "kernel": lambda: ctc_beta(lat, skip, sok, tlen, last, alpha, ll,
                                       g),
            "library": lambda: torch.autograd.grad(lib_fwd().sum(), lp_t)})
        S = 2 * U + 1
        steps = int(tlen.max())
        lattice, flags, rows = B * T * S * 4, 2 * B * S, 4 * B
        bounds = {"alpha": (2 * lattice + flags + 3 * rows) / HBM_BYTES_PER_S,
                  "beta": (3 * lattice + flags + 4 * rows) / HBM_BYTES_PER_S}
        for name, t, lib in (("alpha", ta, "F.ctc_loss forward"),
                             ("beta", tb, "F.ctc_loss forward + backward")):
            k = t["kernel"]
            print(f"{tag} (B={B}, T'={T}, S={S}, V={V}) ctc_{name}: kernel "
                  f"{k:.4f} ms ({k * 1e3 / steps:.4f} us per dependent step "
                  f"over {steps} frames), {lib} {t['library']:.4f} ms, bound "
                  f"{bounds[name] * 1e3:.4f} ms (bytes); {card}", flush=True)
        del logits, lat, skip, sok, alpha, ll, lp_t
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
