"""The FFN backward (TPU kernel 14) and the log-mel front end (TPU kernel 1)
against their library yardsticks, on the card, for any checkout of the port.

    python3 pytorch_end2end_speech_recognition_tpu_torch/csrc/probe/ffn_logmel_yardsticks.py [ROOT ...]

For each ROOT (a checkout's root directory; default: the checkout holding
this script), in a fresh process each, it builds that checkout's kernels and
prints, at the flagship's shapes:
- `ffn_bwd` at R = 24,000, D 256, F 1,024, rate 0.1, bf16: its split by
  kernel (torch.profiler over 10 calls), and its time in turns with the
  unfused torch sequence's autograd backward alone (the sequence's forward
  run once outside the timed window: F.layer_norm, two cuBLAS F.linear,
  SiLU, the residual) and with that sequence's forward + backward;
- `logmel` (bf16 basis, with `Frontend`'s cached filterbank plan where the
  checkout has one) on B=32 x 30 s of speech-like audio, full rows: its
  time in turns with a library sequence (frames by unfold, cast to bf16, a
  cuBLAS bf16 matmul with the (win, 2F) basis, the predecessor term, power,
  a float32 matmul with the filterbank, log, the frame mask);
beside the card's name and power limit. Turns: 5 windows, each timing the
two in order and then in reverse, 20 launches a timing (CUDA events); the
medians. Several ROOTs run in the order given, so `parent change change
parent` compares two commits on one card.
"""

from __future__ import annotations

import math
import os
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve()
PKG = "pytorch_end2end_speech_recognition_tpu_torch"


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


def split_ms(fn, iters: int = 10) -> dict:
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in p.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            t = getattr(ev, "self_device_time_total", None)
            if t is None:
                t = ev.self_cuda_time_total
            m = re.search(r"(\w+_kernel)", ev.key)
            name = m.group(1) if m else ev.key[:40]
            out[name] = out.get(name, 0.0) + t / 1e3 / iters
    return out


def run(root: Path) -> int:
    sys.path.insert(0, str(root))
    import torch
    import torch.nn.functional as F

    from pytorch_end2end_speech_recognition_tpu_torch.ops import frontend as fe
    from pytorch_end2end_speech_recognition_tpu_torch.ops.ffn_kernel import (
        LN_EPS,
        ffn_bwd,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops.frontend_kernel import (
        logmel,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.utils import device as dv
    from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
        FrontendConfig,
    )

    import pytorch_end2end_speech_recognition_tpu_torch as pkg

    dv.set_tf32(False)
    card = dv.card_info()
    dev = torch.device("cuda")
    print(f"== {root} (package {Path(pkg.__file__).parent}); {card}",
          flush=True)

    # ---- FFN backward
    R, D, F_, rate, scale = 24000, 256, 1024, 0.1, 0.5
    gen = torch.Generator(device=dev).manual_seed(13)
    r = lambda *s: torch.randn(*s, device=dev, generator=gen)  # noqa: E731
    bf = torch.bfloat16
    x = r(R, D).to(bf)
    w = (1.0 + 0.5 * r(D), 0.5 * r(D), (r(F_, D) * D ** -0.5).to(bf),
         (0.5 * r(F_)).to(bf), (r(D, F_) * F_ ** -0.5).to(bf),
         (0.5 * r(D)).to(bf))
    g = r(R, D).to(bf)
    seed = torch.tensor([20261016], dtype=torch.int32, device=dev)
    leaves = [t.detach().requires_grad_() for t in (x, *w)]

    def unfused(xx, gm, bt, w1_, b1_, w2_, b2_):
        y = F.layer_norm(xx.float(), (D,), gm, bt, LN_EPS)
        h = F.silu(F.linear(y.to(bf), w1_, b1_))
        return xx + scale * F.linear(h, w2_, b2_)

    out = unfused(*leaves)
    kern = lambda: ffn_bwd(x, g, *w, seed, rate, scale)  # noqa: E731
    split = split_ms(kern)
    print("ffn_bwd split, device ms per call by kernel: " + ", ".join(
        f"{k} {v:.4f}" for k, v in sorted(split.items(), key=lambda kv: -kv[1]))
        + f" (sum {sum(split.values()):.4f})", flush=True)
    t = turns_ms({"kernel": kern,
                  "library backward": lambda: torch.autograd.grad(
                      out, leaves, g, retain_graph=True)})
    t2 = turns_ms({"kernel": kern,
                   "library forward + backward": lambda: torch.autograd.grad(
                       unfused(*leaves), leaves, g)})
    flops = 10.0 * R * D * F_
    print(f"ffn_bwd (R {R}, D {D}, F {F_}, rate {rate}): kernel "
          f"{t['kernel']:.4f} ms ({flops / t['kernel'] / 1e9:.1f} TFLOP/s of "
          f"the function's 10 R D F), unfused torch backward alone "
          f"{t['library backward']:.4f} ms; in a second pairing kernel "
          f"{t2['kernel']:.4f}, unfused forward + backward "
          f"{t2['library forward + backward']:.4f} ms; {card}", flush=True)
    del out, leaves, x, g, w

    # ---- log-mel
    B, SR, secs = 32, 16000, 30.0
    Ts = int(secs * SR)
    seg = SR // 10
    n_seg = -(-Ts // seg)
    u = lambda: torch.rand(B, n_seg, 1, device=dev, generator=gen)  # noqa: E731
    pitch, tone, noise = 100 + 3900 * u(), 10 ** (2 * u() - 2), 10 ** (2 * u() - 3)
    tt = torch.arange(seg, device=dev) / SR
    audio = (0.3 * (tone * torch.sin(2 * math.pi * pitch * tt) + noise * torch.randn(
        B, n_seg, seg, device=dev, generator=gen))).reshape(B, -1)[:, :Ts].contiguous()
    cfg = FrontendConfig(impl="cuda", dft_dtype="bfloat16")
    front = fe.Frontend(cfg, dev)
    T = front.n_frames(Ts)
    flens = front.frame_lens(torch.full((B,), Ts, device=dev))
    hop, win = front.hop, front.win
    basis, prev_b, mel_b = front.basis, front.basis_prev, front.mel_b

    def library():
        fr = audio.unfold(1, win, hop)[:, :T].to(bf)
        reim = (fr @ basis).float()
        prev = F.pad(audio[:, hop - 1:(T - 1) * hop:hop].to(bf).float(), (1, 0))
        reim = reim + prev[..., None] * prev_b
        n = reim.shape[-1] // 2
        mel = (reim[..., :n].square() + reim[..., n:].square()) @ mel_b
        valid = torch.arange(T, device=dev)[None, :] < flens[:, None]
        return torch.where(valid[..., None], torch.log(mel + 1e-10),
                           torch.zeros((), device=dev))

    # the filterbank's plan as `Frontend` keeps it, where the checkout has
    # one (computing it inside every timed call would time the host)
    kw = ({"plan": (front.mel_bands, front.mel_t)}
          if hasattr(front, "mel_t") else {})
    t = turns_ms({"kernel": lambda: logmel(audio, basis, prev_b, mel_b, hop, T,
                                           flens, **kw),
                  "library sequence": library})
    dft = 2.0 * B * T * win * basis.shape[1]
    print(f"logmel (B={B} x {secs:g} s, {T} frames, bf16 basis): kernel "
          f"{t['kernel']:.4f} ms ({dft / t['kernel'] / 1e9:.1f} TFLOP/s of "
          f"the 257-bin DFT), library sequence {t['library sequence']:.4f} "
          f"ms; {card}", flush=True)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    if len(sys.argv) == 2 and sys.argv[1].startswith("--one="):
        return run(Path(sys.argv[1][6:]).resolve())
    roots = sys.argv[1:] or [str(HERE.parents[3])]
    rc = 0
    for root in roots:
        env = dict(os.environ)
        env.pop("PYTHONPATH", None)
        rc |= subprocess.run([sys.executable, str(HERE), f"--one={root}"],
                             cwd=root, env=env).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
