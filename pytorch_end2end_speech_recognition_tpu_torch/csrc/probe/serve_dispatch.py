"""The flagship's serving forward in eager mode, on the card, for any
checkout of the port: what the registered operators (`asr_port::*`, PR 14)
cost the host beside the plain ctypes wrappers before them.

    python3 pytorch_end2end_speech_recognition_tpu_torch/csrc/probe/serve_dispatch.py [ROOT ...]

For each ROOT (a checkout's root directory; default: the checkout holding
this script), in a fresh process each, it builds that checkout's kernels
and the `flagship_conformer` preset at full width (bf16, seed 0, the
relative-bias table at std 4), and runs encode -> CTC logits -> greedy
decode on B=32 rows of 30 s of seeded noise, as `chip_smoke.py` [6] and
[7] do. It prints, after 3 warm forwards: the kernels' launch counters of
one forward ([4]'s counts); the host's enqueue time of a forward (the
call's return, before any sync: what the dispatcher adds shows here), the
median of 30; the wall time of a forward (10 forwards and a sync, the
median of 7 windows); under torch.profiler over 10 forwards the device
kernels and device busy ms a forward ([7]'s numbers) and the idle share;
and the host microseconds of one call of the Toeplitz and attention
wrappers at tiny shapes (the dispatch alone, 200 calls a timing, the
median of 9); with the card's name and power limit. Several ROOTs run in
the order given, so `parent change change parent` compares two commits on
one card.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve()
B, SECONDS, SR = 32, 30, 16000


def run(root: Path) -> int:
    sys.path.insert(0, str(root))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pytorch_end2end_speech_recognition_tpu_torch.configs.presets import (
        flagship_conformer,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.models.asr import (
        AsrModel,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops import (
        attention_kernel as ak,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops import (
        frontend_kernel as fk,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops.ctc import (
        ctc_greedy_decode,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.utils import (
        device as dv,
    )

    dev = torch.device("cuda")
    card = dv.card_info()
    model = AsrModel(flagship_conformer(), device=dev, seed=0).eval()
    g = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        model.encoder.rel.table.normal_(0.0, 4.0, generator=g)
    audio = 0.1 * torch.randn(B, SECONDS * SR, device=dev, generator=g)
    lens = torch.full((B,), SECONDS * SR, device=dev)

    def forward():
        enc, elens = model.encode(audio, lens)
        return ctc_greedy_decode(model.ctc_logits(enc), elens)

    counted = (fk.logmel, ak.toeplitz_fwd, ak.attention_fwd, ak.flash_fwd)
    with torch.inference_mode():
        for _ in range(3):
            forward()
        torch.cuda.synchronize()
        for fn in counted:
            fn.launches = 0
        forward()
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counted}
        host = []
        for _ in range(30):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward()
            host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        walls = []
        for _ in range(7):
            t0 = time.perf_counter()
            for _ in range(10):
                forward()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3 / 10)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(10):
                forward()
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3 / 10
        # the wrappers alone at tiny shapes (the device's part negligible):
        # host microseconds a call, 200 calls a timing, the median of 9
        diag = torch.randn(4, 127, device=dev)
        q = torch.randn(1, 64, 64, device=dev, dtype=torch.bfloat16)
        bias = torch.randn(1, 64, 64, device=dev, dtype=torch.bfloat16)
        one = torch.full((1,), 64, device=dev)
        calls = {"toeplitz_fwd": lambda: ak.toeplitz_fwd(diag, 64, 64,
                                                         torch.bfloat16),
                 "attention_fwd": lambda: ak.attention_fwd(q, q, q, bias,
                                                           one, 1)}
        per_call = {}
        for name, fn in calls.items():
            times = []
            for _ in range(9):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(200):
                    fn()
                times.append((time.perf_counter() - t0) * 1e6 / 200)
            per_call[name] = round(statistics.median(times), 1)
        torch.cuda.synchronize()
    busy, n = 0.0, 0
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            t = getattr(ev, "self_device_time_total", None)
            busy += (ev.self_cuda_time_total if t is None else t) / 1e3 / 10
            n += ev.count
    print(f"{root}: launches {launches}; host enqueue median "
          f"{statistics.median(host):.3f} ms a forward (min {min(host):.3f}); "
          f"wall median {statistics.median(walls):.3f} ms (min "
          f"{min(walls):.3f}, max {max(walls):.3f}); profiled: "
          f"{n / 10:.0f} device kernels, busy {busy:.3f} ms, wall "
          f"{prof_wall:.3f} ms, idle {1 - busy / prof_wall:.3f} a forward; "
          f"host us a wrapper call {per_call}; {card}", flush=True)
    return 0


def main() -> int:
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
