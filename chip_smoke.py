"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases, every one of which must pass (the script exits non-zero otherwise):

1. versions, and the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from `csrc/` (parallel nvcc, ptxas -v printed);
3. each kernel against its plain PyTorch version on the card, at the shapes
   the main paths give it, with kernel, plain, library and bound times:
   log-mel, Toeplitz expand and reduce, attention forward and backward
   (also at rung 4's d512/H8 shape), CTC alpha and beta (also against
   `torch.nn.functional.ctc_loss`), each with controls that must fail the
   same check (attention: bias dropped, lengths ignored; CTC: skip
   transitions disabled);
4. the main path: the `flagship_conformer` preset at full width (12 L, d256,
   H4, FFN 1024, vocab 64), bf16, seeded random weights, encode -> CTC
   logits -> greedy decode on a ragged batch of 32 requests padded to 30 s;
   launch counts 1/1/12; the same model with every implementation set to
   'torch' as the reference, and a control (its relative bias zeroed) that
   must fail that comparison; requests alone vs in the batch; a
   numpy-oracle check of the log-mel on one utterance;
5. a few ragged requests answered, each held against itself alone and
   against the plain model, and their tokens printed;
6. throughput in audio-seconds per second at B=32 x 30 s, the median of
   timed windows;
7. a torch.profiler trace of the forward: device busy and idle share, and
   device time by kernel group and by kernel;
8. the training path at full width: one hybrid step (SpecAugment ->
   encoder -> CTC + 2-layer decoder -> hybrid loss, lambda 0.3 ->
   backward) on B=32 x 30 s with U=64 tokens, bf16, ragged, held against
   the same weights in plain torch on the card (loss, and every parameter's
   gradient by relative error and cosine), with a control (the plain model
   with its relative bias zeroed) that must fail; launch counts of one
   Solver step; five Solver steps with dropout and SpecAugment on, finite;
   train throughput in audio-seconds per second, peak memory, and a
   torch.profiler breakdown of one step.

It then prints the `kernels` JSON line, the card's name and power limit, and
last `{"ok": true, "device": {...}}`. Without a card it exits non-zero
before printing any result. It imports only the port, never JAX.
"""

from __future__ import annotations

import json
import math
import platform
import statistics
import sys
import time

import numpy as np
import torch

B, SECONDS, SR = 32, 30.0, 16000
WIN, HOP = 400, 160
REQUEST_LENS = (4 * SR, 2 * SR, 4 * SR // 3, SR)  # __graft_entry__.entry()
ALONE_ROWS = (1, 2, 7)  # batch rows also answered alone
WINDOWS, ITERS = 7, 5
PKG = "pytorch_end2end_speech_recognition_tpu_torch"
# std of the relative-position table in the kernel checks and the model.
# At the init's 0.02 the bias moves the attention output by ~1e-3 and the
# logits by less than bf16 noise, so a kernel that dropped or misread it
# would pass. A table of std 4 makes attention local, as a trained one is,
# and the attention branch a visible part of the residual stream; the
# controls in [3] and [4] show that the checks then see the bias.
BIAS_STD = 4.0

# tolerances of the kernel checks, kernel vs plain on the same inputs
TOL_LOGMEL = 1e-3      # float32 sums in another order, in the log domain
TOL_TOEPLITZ = 0.0     # a copy: exact
# attention, elementwise, from the bf16 unit roundoff u = 2^-8: both outputs
# are rounded once to bf16 (2u|o|), and the kernel rounds the unnormalised
# e where the plain version rounds p (at most 3u p_j each, <= 4u sum p|v|):
#   |kernel - plain| <= 2^-7 |plain| + 2^-6 (p . |v|)
ATTN_RTOL, ATTN_VTOL = 2.0 ** -7, 2.0 ** -6
# the whole bf16 model through 12 layers: kernels vs plain torch, and one
# request alone vs in the batch (cuBLAS picks other GEMM tilings for other
# row counts), differ by bf16 rounding at other places; 0.05 was measured on
# an H100, the tolerance is twice that. Greedy paths must agree on every
# frame whose top-2 logit margin exceeds twice the tolerance.
TOL_LOGITS = 0.1
MIN_SURE = 0.01  # share of frames that must clear that margin
# attention backward, elementwise, kernel vs plain on the same bf16 inputs.
# Both round q*scale, p (for dv) and ds (for dq, dk) to bf16 at the same
# points and the outputs once; float32 differences (exp2 of the stored lse
# vs exp/sum, summation order) can move a rounded p or ds by one ulp (2^-8
# relative). So with the magnitude terms m_dv = p^T |g|, m_dq = s |d| |k|,
# m_dk = |d|^T |q s|, m_dbias = sum_b |d|, |d| = p (|dp| + |delta|):
#   |kernel - plain| <= 2^-7 (|plain| + m)
ATTN_BWD_TOL = 2.0 ** -7
# Toeplitz reduce: float32 sums of up to T terms in another order (the
# kernel adds row-chunk partials with atomics): |err| <= T u sum|g|
# CTC: float32 log-space recursions over 750 frames in another order
TOL_CTC_LL = 1e-5      # |d ll| <= TOL (1 + |ll|)
# the gradient wrt a lattice log-prob is g exp(gamma), an occupancy, with
# gamma = alpha + beta - lp - ll a sum of log-domain values of magnitude up
# to |ll|, each carrying float32 rounding of |ll| 2^-24; with 64 such
# roundings, d(g e^gamma) = g e^gamma d gamma bounds each element:
#   |d grad| <= TOL_CTC_GRAD (1 + |ll|) |grad| + CTC_ABS |g|
# (the absolute term, 2^-24, is for occupancies that underflow on one side)
TOL_CTC_GRAD = 2.0 ** -18
CTC_ABS = 2.0 ** -24
# the training step, kernel model vs plain model on the card (bf16, 12
# layers, same weights, same mask, dropout 0). Measured on an H100: loss
# 9.6e-6 relative, every gradient's cosine >= 0.99945 and relative error
# <= 0.033; the loss tolerance is 10x, the gradients' 2x (the cosine's gap
# to 1). The control (relative bias zeroed) measured 2.6e-3, 0.46 and 2.0.
TOL_TRAIN_LOSS = 1e-4  # relative
TRAIN_MIN_COS = 0.9989  # every parameter's gradient, cosine to plain's
TRAIN_MAX_REL = 0.07   # and relative error ||g_k - g_p|| / ||g_p||
U_TOKENS = 64          # tokens per row, as the JAX package's benchmarks.py
TRAIN_WINDOWS, TRAIN_ITERS = 5, 2


# kernel-name patterns for the profile summary, first match wins
PROFILE_GROUPS = (
    ("logmel", ("logmel_",)),
    ("toeplitz", ("toeplitz_",)),
    ("attention_bwd", ("attn_bwd_",)),
    ("attention", ("attention_kernel",)),
    ("ctc", ("ctc_",)),
    ("optimizer", ("foreach", "multi_tensor")),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "sm90_")),
    ("conv", ("conv", "cudnn", "implicit")),
    ("layer_norm", ("layer_norm", "layernorm", "gammabeta")),
    ("memcpy", ("memcpy",)),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn over `iters` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, op_seconds: float, peaks: dict) -> tuple[float, str]:
    """(least time in ms, 'bytes' or 'operations'): the larger of the bytes
    over the memory rate and the operations over their peak rate (the
    slowest unit's, where several run concurrently)."""
    t_bytes = n_bytes / peaks["hbm_bytes_per_s"]
    if op_seconds > t_bytes:
        return op_seconds * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def speechlike(n_rows: int, n_samples: int, gen, dev) -> torch.Tensor:
    """Non-stationary test audio: 0.1 s segments, each a tone of its own
    pitch and level plus noise of its own level, so log-mel frames differ
    from one another as speech frames do. Stationary noise gives nearly
    equal frames, and nearly equal logits, behind which a wrong kernel hides.
    """
    seg = SR // 10
    n_seg = -(-n_samples // seg)
    u = lambda: torch.rand(n_rows, n_seg, 1, device=dev, generator=gen)
    pitch, tone, noise = 100 + 3900 * u(), 10 ** (2 * u() - 2), 10 ** (2 * u() - 3)
    t = torch.arange(seg, device=dev) / SR
    x = tone * torch.sin(2 * math.pi * pitch * t) + noise * torch.randn(
        n_rows, n_seg, seg, device=dev, generator=gen)
    return 0.3 * x.reshape(n_rows, -1)[:, :n_samples].contiguous()


def n_frames_of(n: int) -> int:
    return max(0, (n - WIN) // HOP + 1)


def grid_len(n: int, batch_frames: int) -> int:
    """The fewest samples >= n whose frame count is >= n's and has
    `batch_frames`' residue mod 4. Both stride-2 'SAME' subsampling
    convolutions pad by the parity of their input (as the JAX package's
    do), so a request answered alone sees the frame grid it sees in a
    padded batch only then."""
    f = n_frames_of(n)
    while f % 4 != batch_frames % 4:
        f += 1
    return max(n, WIN + HOP * (f - 1))


def heads_of(x: torch.Tensor, H: int) -> torch.Tensor:
    B, T, D = x.shape
    return x.reshape(B, T, H, D // H).transpose(1, 2).float()


def attn_bwd_magnitudes(q, k, v, bias, lens, g, H):
    """The magnitude terms of the attention backward's rounding bound (see
    ATTN_BWD_TOL), in float32: (m_dq, m_dk, m_dv, m_dbias)."""
    B, T, D = q.shape
    scale = (D // H) ** -0.5
    qs = (heads_of(q, H) * scale).to(q.dtype).float()
    kh, vh, gh = heads_of(k, H), heads_of(v, H), heads_of(g, H)
    sc = qs @ kh.transpose(-1, -2)
    if bias is not None:
        sc = sc + bias[None, :, :T, :T].float()
    key_ok = torch.arange(T, device=q.device)[None, :] < lens[:, None]
    sc = torch.where(key_ok[:, None, None, :], sc,
                     torch.full((), -1e30, device=q.device))
    e = torch.exp(sc - sc.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True).clamp_min(1e-30)
    del sc, e
    dp = gh @ vh.transpose(-1, -2)
    mag = p * (dp.abs() + (dp * p).sum(-1, keepdim=True).abs())
    del dp
    merge = lambda x: x.transpose(1, 2).reshape(B, T, D)
    m_dv = merge(p.transpose(-1, -2) @ gh.abs())
    m_dq = merge(mag @ kh.abs()) * scale
    m_dk = merge(mag.transpose(-1, -2) @ qs.abs())
    m_db = None
    if bias is not None:
        P = bias.shape[-1]
        m_db = torch.nn.functional.pad(mag.sum(0), (0, P - T, 0, P - T))
    return m_dq, m_dk, m_dv, m_db


def grad_stats(got: dict, want: dict) -> tuple[float, float, float, int]:
    """(min cosine, max relative error, median cosine, parameters compared)
    of two name -> gradient dicts, over the parameters whose plain gradient
    norm exceeds 1e-3 of the median norm (the key projections' biases have
    zero gradient in exact arithmetic and carry only rounding noise)."""
    norms = {k: float(w.float().norm()) for k, w in want.items()}
    floor = 1e-3 * statistics.median(norms.values())
    cos, rel = [], []
    for k, w in want.items():
        if norms[k] <= floor:
            continue
        a, b = got[k].float().flatten(), w.float().flatten()
        cos.append(float(torch.dot(a, b) / (a.norm() * b.norm())))
        rel.append(float((a - b).norm() / b.norm()))
    return min(cos), max(rel), statistics.median(cos), len(cos)


def profile_step(fn, iters: int):
    """torch.profiler over `iters` calls of fn after one warm call:
    (wall ms per call, {kernel: device ms per call}, launches per call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    kernel_ms, n_launch = {}, 0
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            t = getattr(ev, "self_device_time_total", None)
            if t is None:
                t = ev.self_cuda_time_total
            kernel_ms[ev.key] = t / 1e3 / iters
            n_launch += ev.count
    return wall_ms, kernel_ms, n_launch / iters


def print_profile(tag: str, wall_ms: float, kernel_ms: dict, n: float,
                  card: str) -> None:
    busy = sum(kernel_ms.values())
    groups = {}
    for key, t in kernel_ms.items():
        low = key.lower()
        grp = next((g for g, pats in PROFILE_GROUPS
                    if any(p in low for p in pats)), "other")
        groups[grp] = groups.get(grp, 0.0) + t
    print(f"{tag}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms (idle "
          f"share {1 - busy / wall_ms:.3f}), {n:.0f} device kernels; {card}")
    for grp, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"    {grp:13s} {t:8.3f} ms  {100 * t / max(busy, 1e-9):5.1f}%")
    for key, t in sorted(kernel_ms.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {t:8.3f} ms  {key[:110]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    from pytorch_end2end_speech_recognition_tpu_torch.configs.presets import (
        flagship_conformer,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.models.asr import AsrModel
    from pytorch_end2end_speech_recognition_tpu_torch.models.encoders import (
        RelPosBias,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops import _build
    from pytorch_end2end_speech_recognition_tpu_torch.ops import frontend as fe
    from pytorch_end2end_speech_recognition_tpu_torch.ops.attention_kernel import (
        attention_bwd,
        attention_bwd_plain,
        attention_fwd,
        attention_plain,
        fused_attention,
        toeplitz_expand,
        toeplitz_fwd,
        toeplitz_reduce,
        toeplitz_reduce_plain,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops.ctc import (
        ctc_greedy_decode,
        ctc_loss,
        lattice_inputs,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops.ctc_kernel import (
        ctc_alpha,
        ctc_alpha_plain,
        ctc_beta,
        ctc_beta_plain,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops.frontend_kernel import (
        logmel,
        logmel_plain,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.utils import device as dv
    from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
        FrontendConfig,
        resolve_device,
    )

    COUNTED = (logmel, toeplitz_fwd, attention_fwd, attention_bwd,
               toeplitz_reduce, ctc_alpha, ctc_beta)
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    dv.set_tf32(False)
    peaks = dv.H100_PEAKS
    card = dv.card_info()
    name = torch.cuda.get_device_name(0)
    print(f"[1] python {platform.python_version()} torch {torch.__version__} "
          f"cuda {torch.version.cuda} card '{name}' ({card})", flush=True)

    t0 = time.perf_counter()
    lib_path, log = _build.build()
    print(f"[2] built {lib_path} in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line or "error" in line:
            print("    " + line.strip())
    _build.load()

    cfg = resolve_device(flagship_conformer(), dev)
    fcfg, mcfg = cfg.frontend, cfg.model
    gen = torch.Generator(device=dev).manual_seed(0)
    Ts = int(SECONDS * SR)
    audio = speechlike(B, Ts, gen, dev)
    full_lens = torch.full((B,), Ts, dtype=torch.int64, device=dev)
    # the main path's batch: even rows full, odd rows from 1 s to 30 s
    audio_lens = full_lens.clone()
    audio_lens[1::2] = torch.randint(SR, Ts + 1, (B // 2,), device=dev,
                                     generator=gen)
    kernels = {}

    # ---- [3a] log-mel at the main path's shapes (bf16 DFT operands) and f32
    front = fe.Frontend(fcfg, dev)
    n_frames = front.n_frames(Ts)
    for dt in (torch.bfloat16, torch.float32):
        basis = (front.basis if dt == front.basis.dtype
                 else front.basis.to(dt).contiguous())
        for tag, al in (("ragged", audio_lens), ("full", full_lens)):
            flens = front.frame_lens(al)
            args = (audio, basis, front.basis_prev, front.mel_b, front.hop,
                    n_frames, flens)
            out = logmel(*args)
            ref = logmel_plain(*args)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            print(f"[3] logmel {str(dt)[6:]} {tag} lens: max |kernel - plain| "
                  f"= {err:.3e} (tol {TOL_LOGMEL})", flush=True)
            check(err <= TOL_LOGMEL and bool(torch.isfinite(out).all()),
                  f"logmel {dt} {tag} disagrees with its plain version ({err})")
            if dt != front.basis.dtype:
                continue
            kernels.setdefault("logmel", dict(name="logmel", max_abs_err=0.0))
            kernels["logmel"]["max_abs_err"] = max(
                err, kernels["logmel"]["max_abs_err"])
            if tag != "full":
                continue
            win, two_f = basis.shape
            n_valid = int(flens.sum())
            # the DFT on the tensor cores (bf16) and the mel product on the
            # CUDA cores run concurrently; the triangular filterbank has at
            # most 2 filters per bin, so the mel product's operations are
            # those of its nonzeros
            dft = 2.0 * n_valid * win * two_f
            mel_ops = 2.0 * n_valid * int((front.mel_b != 0).sum())
            dft_peak = peaks["bf16_flops"] if dt == torch.bfloat16 else \
                peaks["fp32_flops"]
            b_ms, b_by = bound(
                nbytes(audio, basis, front.basis_prev, front.mel_b, flens, out),
                max(dft / dft_peak, mel_ops / peaks["fp32_flops"]), peaks)
            kernels["logmel"].update(
                route="cuda", source=f"{PKG}/csrc/logmel.cu",
                replaces="pytorch_end2end_speech_recognition_tpu/ops/"
                         "frontend_pallas.py:138",
                ms=cuda_ms(lambda: logmel(*args)),
                plain_ms=cuda_ms(lambda: logmel_plain(*args)),
                bound_ms=b_ms, bound_by=b_by, library_ms=None)
        del out, ref

    # ---- [3b] Toeplitz expansion of all 12 layers x 4 heads
    T_enc = ((n_frames + 1) // 2 + 1) // 2
    P = -(-T_enc // 128) * 128
    table = torch.randn(mcfg.encoder_layers, mcfg.encoder_heads, 64,
                        device=dev, generator=gen) * BIAS_STD
    rel = RelPosBias(mcfg.encoder_layers, mcfg.encoder_heads).to(dev)
    with torch.no_grad():
        rel.table.copy_(table)
        diag = rel.diags(T_enc).reshape(-1, 2 * T_enc - 1).contiguous()
    for dt in (torch.bfloat16, torch.float32):
        out = toeplitz_fwd(diag, T_enc, P, dt)
        ref = toeplitz_expand(diag, P, P, T=T_enc).to(dt)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        print(f"[3] toeplitz {str(dt)[6:]}: max |kernel - plain| = {err:.3e} "
              f"(tol {TOL_TOEPLITZ})", flush=True)
        check(err <= TOL_TOEPLITZ, f"toeplitz {dt} disagrees ({err})")
        if dt == torch.bfloat16:
            b_ms, b_by = bound(nbytes(diag, out), 0.0, peaks)
            kernels["toeplitz"] = dict(
                name="toeplitz", route="cuda",
                source=f"{PKG}/csrc/toeplitz.cu",
                replaces="pytorch_end2end_speech_recognition_tpu/ops/"
                         "attention_pallas.py:424",
                max_abs_err=err,
                ms=cuda_ms(lambda: toeplitz_fwd(diag, T_enc, P, dt)),
                plain_ms=cuda_ms(
                    lambda: toeplitz_expand(diag, P, P, T=T_enc).to(dt)),
                bound_ms=b_ms, bound_by=b_by, library_ms=None)
        del out, ref
    # the first layer's (H, P, P) bias, std BIAS_STD
    bias = toeplitz_fwd(diag, T_enc, P, torch.bfloat16)[:mcfg.encoder_heads]

    # ---- [3c] attention: one layer's q/k/v at the main path's shape
    H, D = mcfg.encoder_heads, mcfg.encoder_dim
    Dh = D // H
    mk = lambda: torch.randn(B, T_enc, D, device=dev, generator=gen).to(
        torch.bfloat16)
    q, k, v = mk(), mk(), mk()
    full = torch.full((B,), T_enc, dtype=torch.int32, device=dev)
    ragged = torch.randint(1, T_enc + 1, (B,), device=dev, generator=gen,
                           dtype=torch.int32)
    ragged[0], ragged[1], ragged[2] = 1, 2, T_enc

    def attn_excess(out, lens, bias_ref=bias):
        """(max |out - plain| on valid rows, share of valid elements beyond
        the bf16 tolerance) against the plain version with `bias_ref`."""
        ref = attention_plain(q, k, v, bias_ref, lens, H).float()
        pv = attention_plain(q, k, v.abs(), bias_ref, lens, H).float()
        valid = (torch.arange(T_enc, device=dev)[None, :]
                 < lens[:, None])[..., None].expand_as(ref)
        diff = (out.float() - ref).abs()
        over = (diff > ATTN_RTOL * ref.abs() + ATTN_VTOL * pv) & valid
        return diff[valid].max().item(), over.sum().item() / valid.sum().item()

    attn_err = 0.0
    for tag, lens in (("ragged", ragged), ("full", full)):
        err, share = attn_excess(fused_attention(q, k, v, bias, lens, H), lens)
        attn_err = max(attn_err, err)
        print(f"[3] attention {tag} lens: max |kernel - plain| on valid rows "
              f"= {err:.3e}; share beyond 2^-7|o| + 2^-6 p.|v|: {share:.3e}",
              flush=True)
        check(share == 0.0, f"attention ({tag}) disagrees ({err}, {share})")
    # controls: a kernel that dropped the bias, or ignored the lengths, must
    # fail the same check
    for tag, out in (
            ("bias dropped", fused_attention(q, k, v, None, ragged, H)),
            ("lengths ignored", fused_attention(q, k, v, bias, full, H))):
        err, share = attn_excess(out, ragged)
        print(f"[3] attention control, {tag}: max |diff| {err:.3e}, share "
              f"beyond tolerance {share:.3e} (must be > 0)", flush=True)
        check(share > 0.0, f"attention control '{tag}' passed the check")
    qh, kh, vh = (t.view(B, T_enc, H, Dh).transpose(1, 2).contiguous()
                  for t in (q, k, v))
    key_ok = torch.arange(T_enc, device=dev)[None, :] < full[:, None]
    sdpa_mask = (bias[None, :, :T_enc, :T_enc].float()
                 + torch.where(key_ok, 0.0, float("-inf"))[:, None, None, :]
                 ).to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flops = 4.0 * H * T_enc * Dh * float(full.sum())
    b_ms, b_by = bound(  # q, k, v read, an output of q's shape written
        nbytes(q, k, v, q, full) + H * T_enc * T_enc * bias.element_size(),
        flops / peaks["bf16_flops"], peaks)
    kernels["attention"] = dict(
        name="attention", route="cuda", source=f"{PKG}/csrc/attention.cu",
        replaces="pytorch_end2end_speech_recognition_tpu/ops/"
                 "attention_pallas.py:82",
        max_abs_err=attn_err,
        ms=cuda_ms(lambda: attention_fwd(q, k, v, bias, full, H)),
        plain_ms=cuda_ms(lambda: attention_plain(q, k, v, bias, full, H)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: sdpa(qh, kh, vh, attn_mask=sdpa_mask)))
    del qh, kh, vh, sdpa_mask

    # ---- [3d] Toeplitz reduce: the cotangent of every layer's bias block,
    # bf16 with a zero pad band (as the attention backward leaves it)
    N = mcfg.encoder_layers * H
    g_bias = torch.zeros(N, P, P, device=dev, dtype=torch.bfloat16)
    g_bias[:, :T_enc, :T_enc] = torch.randn(N, T_enc, T_enc, device=dev,
                                            generator=gen).to(torch.bfloat16)
    red = toeplitz_reduce(g_bias, T_enc)
    red_ref = toeplitz_reduce_plain(g_bias, T_enc)
    red_tol = T_enc * 2.0 ** -24 * toeplitz_reduce_plain(g_bias.abs(), T_enc)
    torch.cuda.synchronize()
    err = (red - red_ref).abs()
    share = (err > red_tol).float().mean().item()
    print(f"[3] toeplitz reduce: max |kernel - plain| = {err.max().item():.3e}"
          f", share beyond T u sum|g|: {share:.3e}", flush=True)
    check(share == 0.0, f"toeplitz reduce disagrees ({share})")
    b_ms, b_by = bound(N * T_enc * T_enc * 2 + nbytes(red), 0.0, peaks)
    kernels["toeplitz_reduce"] = dict(
        name="toeplitz_reduce", route="cuda", source=f"{PKG}/csrc/toeplitz.cu",
        replaces="pytorch_end2end_speech_recognition_tpu/ops/"
                 "attention_pallas.py:458",
        max_abs_err=err.max().item(),
        ms=cuda_ms(lambda: toeplitz_reduce(g_bias, T_enc)),
        plain_ms=cuda_ms(lambda: toeplitz_reduce_plain(g_bias, T_enc)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    del g_bias, red, red_ref, red_tol, err

    # ---- [3e] attention backward at the main path's shape: ragged lens
    # with a pad row (lens 0) and full lens; the cotangent is zero past each
    # row's length, as on the training path
    ragged_b = ragged.clone()
    ragged_b[3] = 0
    g_out = torch.randn(B, T_enc, D, device=dev, generator=gen).to(
        torch.bfloat16)

    def masked_g(gg, lens):
        ok = torch.arange(gg.shape[1], device=dev)[None, :] < lens[:, None]
        return gg * ok[..., None].to(gg.dtype)

    def bwd_excess(qq, kk, vv, bb, lens, gg, HH, got, bias_ref="same",
                   lens_ref=None):
        """(max |kernel - plain|, share of elements beyond the bound) over
        dq, dk, dv and dbias, against the plain backward on `bias_ref` and
        `lens_ref` (default: the kernel's own)."""
        bias_ref = bb if bias_ref == "same" else bias_ref
        lens_ref = lens if lens_ref is None else lens_ref
        want = attention_bwd_plain(qq, kk, vv, bias_ref, lens_ref, gg, HH)
        mags = attn_bwd_magnitudes(qq, kk, vv, bias_ref, lens_ref, gg, HH)
        errs, over, total = [0.0], 0, 0
        for a, w, m in zip(got, want, mags):
            if a is None or w is None:
                continue
            d = (a.float() - w.float()).abs()
            errs.append(d.max().item())
            over += int((d > ATTN_BWD_TOL * (w.float().abs() + m)).sum())
            total += d.numel()
        return max(errs), over / total

    bwd_err = 0.0
    for tag, lens in (("ragged + pad row", ragged_b), ("full", full)):
        gg = masked_g(g_out, lens)
        _, lse = attention_fwd(q, k, v, bias, lens, H, with_lse=True)
        got = attention_bwd(q, k, v, bias, lens, gg, lse, H)
        err, share = bwd_excess(q, k, v, bias, lens, gg, H, got)
        bwd_err = max(bwd_err, err)
        print(f"[3] attention backward {tag} lens: max |kernel - plain| = "
              f"{err:.3e}; share beyond 2^-7 (|plain| + m): {share:.3e}",
              flush=True)
        check(share == 0.0, f"attention backward ({tag}) disagrees "
              f"({err}, {share})")
        del got
    gg = masked_g(g_out, ragged_b)
    for tag, bb, lens in (("bias dropped", None, ragged_b),
                          ("lengths ignored", bias, full)):
        _, lse = attention_fwd(q, k, v, bb, lens, H, with_lse=True)
        got = attention_bwd(q, k, v, bb, lens, gg, lse, H)
        err, share = bwd_excess(q, k, v, bb, lens, gg, H, got, bias_ref=bias,
                                lens_ref=ragged_b)
        print(f"[3] attention backward control, {tag}: max |diff| {err:.3e},"
              f" share beyond the bound {share:.3e} (must be > 0)", flush=True)
        check(share > 0.0, f"attention backward control '{tag}' passed")
        del got
    gg = g_out
    _, lse = attention_fwd(q, k, v, bias, full, H, with_lse=True)
    qh, kh, vh = (heads_of(t, H).to(torch.bfloat16).requires_grad_()
                  for t in (q, k, v))
    gh = heads_of(gg, H).to(torch.bfloat16)
    key_ok = torch.arange(T_enc, device=dev)[None, :] < full[:, None]
    lib_mask = (bias[None, :, :T_enc, :T_enc].float()
                + torch.where(key_ok, 0.0, float("-inf"))[:, None, None, :]
                ).to(torch.bfloat16).expand(B, H, T_enc, T_enc).contiguous()
    lib_mask.requires_grad_()

    def sdpa_fwd_bwd():
        o = sdpa(qh, kh, vh, attn_mask=lib_mask)
        return torch.autograd.grad(o, (qh, kh, vh, lib_mask), gh)

    flops = 10.0 * H * T_enc * Dh * float(full.sum())
    b_ms, b_by = bound(  # q, k, v, g read; dq, dk, dv written; bias core
        # read, dbias (H, P, P) written, lse read
        7 * nbytes(q) + H * T_enc * T_enc * 2 + nbytes(bias) + nbytes(lse),
        flops / peaks["bf16_flops"], peaks)
    kernels["attention_bwd"] = dict(
        name="attention_bwd", route="cuda", source=f"{PKG}/csrc/attention.cu",
        replaces="pytorch_end2end_speech_recognition_tpu/ops/"
                 "attention_pallas.py:281",
        max_abs_err=bwd_err,
        ms=cuda_ms(lambda: attention_bwd(q, k, v, bias, full, gg, lse, H)),
        plain_ms=cuda_ms(
            lambda: attention_bwd_plain(q, k, v, bias, full, gg, H), iters=5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(sdpa_fwd_bwd, iters=10))
    print("[3] attention backward library yardstick: SDPA forward + backward"
          " with the float bias as attn_mask requiring grad", flush=True)
    del q, k, v, qh, kh, vh, gh, lib_mask, g_out, gg, lse

    # ---- [3f] the same backward at rung 4's width (d512, H8, T 750), the
    # shape the JAX package routes through its head-split kernel (#5)
    H4, D4, B4 = 8, 512, 8
    mk4 = lambda *sh: torch.randn(*sh, device=dev, generator=gen).to(
        torch.bfloat16)
    q4, k4, v4 = mk4(B4, T_enc, D4), mk4(B4, T_enc, D4), mk4(B4, T_enc, D4)
    bias4 = torch.zeros(H4, P, P, device=dev, dtype=torch.bfloat16)
    bias4[:, :T_enc, :T_enc] = (mk4(H4, T_enc, T_enc).float() * BIAS_STD
                                ).to(torch.bfloat16)
    lens4 = torch.randint(1, T_enc + 1, (B4,), device=dev, generator=gen)
    lens4[0], lens4[1] = T_enc, 0
    g4 = masked_g(mk4(B4, T_enc, D4), lens4)
    _, lse4 = attention_fwd(q4, k4, v4, bias4, lens4, H4, with_lse=True)
    got4 = attention_bwd(q4, k4, v4, bias4, lens4, g4, lse4, H4)
    err, share = bwd_excess(q4, k4, v4, bias4, lens4, g4, H4, got4)
    print(f"[3] attention backward at rung 4's shape (B {B4}, T {T_enc}, "
          f"d{D4}, H{H4}): max |kernel - plain| {err:.3e}, share beyond the "
          f"bound {share:.3e}", flush=True)
    check(share == 0.0, f"attention backward at rung 4's shape ({share})")
    flops4 = 10.0 * H4 * T_enc * (D4 // H4) * float(lens4.sum())
    b_ms, b_by = bound(7 * nbytes(q4) + H4 * T_enc * T_enc * 2
                       + nbytes(bias4) + nbytes(lse4),
                       flops4 / peaks["bf16_flops"], peaks)
    ms4 = cuda_ms(lambda: attention_bwd(q4, k4, v4, bias4, lens4, g4, lse4,
                                        H4))
    plain4 = cuda_ms(lambda: attention_bwd_plain(q4, k4, v4, bias4, lens4,
                                                 g4, H4), iters=5)
    print(f"[3] attention backward at rung 4's shape: kernel {ms4:.4f} ms, "
          f"plain {plain4:.4f} ms, bound {b_ms:.4f} ms ({b_by}); {card}",
          flush=True)
    del q4, k4, v4, bias4, g4, lse4, got4

    # ---- [3g] CTC at the train step's shape: T' frames of the ragged
    # batch, U = 64 labels without repeats, vocab 64, one pad row
    V = mcfg.vocab_size
    nf_r = (audio_lens - WIN) // HOP + 1
    enc_lens_r = ((nf_r + 1) // 2 + 1) // 2
    c_logits = torch.randn(B, T_enc, V, device=dev, generator=gen)
    steps_ = torch.randint(1, V - 1, (B, U_TOKENS), device=dev, generator=gen)
    c_labels = 1 + torch.cumsum(steps_, 1) % (V - 1)   # never a repeat
    c_lens = torch.minimum(
        torch.randint(1, U_TOKENS + 1, (B,), device=dev, generator=gen),
        enc_lens_r // 2)
    c_lens[B - 1] = 0
    c_labels = c_labels * (torch.arange(U_TOKENS, device=dev)[None, :]
                           < c_lens[:, None])
    lat, skip, sok = lattice_inputs(c_logits, c_labels, c_lens)
    last = 2 * c_lens
    alpha, ll = ctc_alpha(lat, skip, sok, enc_lens_r, last)
    a_ref, ll_ref = ctc_alpha_plain(lat, skip, sok, enc_lens_r, last)
    g_ll = torch.randn(B, device=dev, generator=gen)
    cgrad = ctc_beta(lat, skip, sok, enc_lens_r, last, alpha, ll, g_ll)
    cgrad_ref = ctc_beta_plain(lat, skip, sok, enc_lens_r, last, a_ref,
                               ll_ref, g_ll)
    torch.cuda.synchronize()
    d_ll = (ll - ll_ref).abs()
    fin = a_ref > -1e29
    d_alpha = (alpha - a_ref).abs()[fin]
    d_grad = (cgrad - cgrad_ref).abs()

    def ctc_grad_excess(got, want, mag, ll_row, g_row):
        """(share of elements beyond TOL_CTC_GRAD (1 + |ll|) mag + CTC_ABS
        |g|, largest ratio of |got - want| to that bound)."""
        tol = (TOL_CTC_GRAD * (1 + ll_row.abs())[:, None, None] * mag
               + CTC_ABS * g_row.abs()[:, None, None])
        d = (got - want).abs()
        ratio = torch.where(d > 0, d / tol, torch.zeros_like(d))
        return (d > tol).float().mean().item(), ratio.max().item()

    check(bool((ll_ref > -1e29).all()), "ctc: a row no path can explain")
    share, worst = ctc_grad_excess(cgrad, cgrad_ref, cgrad_ref.abs(), ll_ref,
                                   g_ll)
    print(f"[3] ctc alpha: max |d ll| {d_ll.max().item():.3e}, max |d alpha| "
          f"on reachable states {d_alpha.max().item():.3e}; beta: max |d "
          f"grad| {d_grad.max().item():.3e}, share beyond the elementwise "
          f"bound {share:.3e} (largest ratio to it {worst:.3e})", flush=True)
    check(torch.equal(fin, alpha > -1e29), "ctc alpha: reachable states differ")
    check(bool((d_ll <= TOL_CTC_LL * (1 + ll_ref.abs())).all())
          and bool((d_alpha <= TOL_CTC_LL * (1 + a_ref.abs()[fin])).all()),
          "ctc alpha disagrees with its plain version")
    check(share == 0.0, "ctc beta disagrees with its plain version")
    # controls: a beta kernel without skip transitions (labels without
    # repeats use them), or one that starts a frame early, must fail
    for tag, sk, tl in (("skip transitions disabled", torch.zeros_like(skip),
                         enc_lens_r),
                        ("lengths one frame short", skip, enc_lens_r - 1)):
        bad = ctc_beta(lat, sk, sok, tl, last, alpha, ll, g_ll)
        share_c, _ = ctc_grad_excess(bad, cgrad_ref, cgrad_ref.abs(), ll_ref,
                                     g_ll)
        print(f"[3] ctc beta control, {tag}: share beyond the bound "
              f"{share_c:.3e} (must be > 0)", flush=True)
        check(share_c > 0.0, f"ctc beta control '{tag}' passed the check")
        del bad
    # against torch's CTC, forward and backward, rows with labels; the
    # gradient wrt a logit is p_v - occ_v (g = 1), each element held to the
    # bound above with mag = p_v + occ_v
    rows = c_lens > 0
    x = c_logits.clone().requires_grad_()
    loss_k = ctc_loss(x, enc_lens_r, c_labels, c_lens, impl="cuda")
    (loss_k * rows).sum().backward()
    y = c_logits.clone().requires_grad_()
    loss_t = torch.nn.functional.ctc_loss(
        torch.nn.functional.log_softmax(y, -1).transpose(0, 1), c_labels,
        enc_lens_r, c_lens, reduction="none", zero_infinity=True)
    (loss_t * rows).sum().backward()
    d_loss = (loss_k - loss_t).abs()[rows]
    p_v = torch.softmax(c_logits, -1)
    share, worst = ctc_grad_excess(x.grad, y.grad, p_v + (p_v - y.grad).abs(),
                                   loss_t.detach(), rows.float())
    print(f"[3] ctc kernels vs F.ctc_loss: max |d loss| "
          f"{d_loss.max().item():.3e} (loss up to "
          f"{loss_t[rows].max().item():.1f}), max |d grad| "
          f"{(x.grad - y.grad).abs().max().item():.3e}, share beyond the "
          f"elementwise bound {share:.3e} (largest ratio to it {worst:.3e})",
          flush=True)
    check(bool((d_loss <= TOL_CTC_LL * (1 + loss_t[rows].abs())).all())
          and share == 0.0, "ctc kernels disagree with F.ctc_loss")
    del p_v
    # control: without skip transitions the same labels (no repeats) must
    # give another likelihood
    _, ll_ctl = ctc_alpha(lat, torch.zeros_like(skip), sok, enc_lens_r, last)
    ctl = ((ll_ctl - ll_ref).abs() > TOL_CTC_LL * (1 + ll_ref.abs()))[rows]
    print(f"[3] ctc control, skip transitions disabled: {int(ctl.sum())}/"
          f"{int(rows.sum())} rows beyond the tolerance (must be > 0)",
          flush=True)
    check(bool(ctl.any()), "ctc control (no skips) passed the check")
    cells = lat.numel()
    lp_t = torch.nn.functional.log_softmax(c_logits, -1).transpose(0, 1)
    lp_t = lp_t.detach().requires_grad_()

    def torch_ctc():
        return torch.nn.functional.ctc_loss(lp_t, c_labels, enc_lens_r,
                                            c_lens, reduction="none",
                                            zero_infinity=True)

    def torch_ctc_fwd_bwd():
        return torch.autograd.grad(torch_ctc().sum(), lp_t)

    b_ms, b_by = bound(nbytes(lat, skip, sok, enc_lens_r, last, alpha, ll),
                       10.0 * cells / peaks["fp32_flops"], peaks)
    kernels["ctc_alpha"] = dict(
        name="ctc_alpha", route="cuda", source=f"{PKG}/csrc/ctc.cu",
        replaces="pytorch_end2end_speech_recognition_tpu/ops/ctc_pallas.py:160",
        max_abs_err=d_ll.max().item(),
        ms=cuda_ms(lambda: ctc_alpha(lat, skip, sok, enc_lens_r, last)),
        plain_ms=cuda_ms(
            lambda: ctc_alpha_plain(lat, skip, sok, enc_lens_r, last),
            iters=3, warmup=1),
        bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(torch_ctc))
    b_ms, b_by = bound(nbytes(lat, skip, sok, enc_lens_r, last, alpha, ll,
                              g_ll, cgrad),
                       12.0 * cells / peaks["fp32_flops"], peaks)
    kernels["ctc_beta"] = dict(
        name="ctc_beta", route="cuda", source=f"{PKG}/csrc/ctc.cu",
        replaces="pytorch_end2end_speech_recognition_tpu/ops/ctc_pallas.py:211",
        max_abs_err=d_grad.max().item(),
        ms=cuda_ms(lambda: ctc_beta(lat, skip, sok, enc_lens_r, last, alpha,
                                    ll, g_ll)),
        plain_ms=cuda_ms(
            lambda: ctc_beta_plain(lat, skip, sok, enc_lens_r, last, alpha,
                                   ll, g_ll), iters=3, warmup=1),
        bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(torch_ctc_fwd_bwd))
    print("[3] ctc library yardsticks: F.ctc_loss forward (alpha), forward "
          "+ backward (beta); the CTC bound counts bytes, but T' = "
          f"{T_enc} dependent steps set the floor", flush=True)
    del lat, skip, sok, alpha, ll, a_ref, ll_ref, cgrad, cgrad_ref, x, y
    del lp_t, c_logits

    # ---- [4] the main path, full width, bf16, through the kernels
    model = AsrModel(flagship_conformer(), device=dev, seed=0).eval()
    check(model.cfg.model.attn_impl == "cuda" and model.cfg.frontend.impl
          == "cuda" and model.cfg.model.dtype == "bfloat16",
          f"flagship did not resolve to the kernels in bf16: {model.cfg.model}")
    cfg_ref = flagship_conformer()
    cfg_ref.frontend.impl = "torch"
    cfg_ref.model.attn_impl = "torch"
    ref_model = AsrModel(cfg_ref, device=dev, seed=0).eval()
    with torch.no_grad():
        model.encoder.rel.table.copy_(table)
        ref_model.encoder.rel.table.copy_(table)

    def serve(m, a, al):
        enc, elens = m.encode(a, al)
        logits = m.ctc_logits(enc)
        tokens, tlens = ctc_greedy_decode(logits, elens)
        return enc, elens, logits, tokens, tlens

    def compare(tag, got, want, lens, need_sure=False):
        """Hold logits `got` to `want` (both (B, T, V) float32) on the
        frames t < lens[b]: max |d| <= TOL_LOGITS, and the argmax equal on
        every frame whose top-2 margin in `want` exceeds 2 * TOL_LOGITS."""
        valid = torch.arange(want.shape[1], device=dev)[None, :] < lens[:, None]
        err = (got - want).abs().amax(-1)[valid].max().item()
        top2 = want.topk(2, dim=-1).values
        sure = valid & ((top2[..., 0] - top2[..., 1]) > 2 * TOL_LOGITS)
        agree = got.argmax(-1) == want.argmax(-1)
        print(f"{tag}: max |dlogit| {err:.4f} (tol {TOL_LOGITS}, logit "
              f"std {want[valid].std().item():.3f}); argmax equal on "
              f"{float(agree[valid].float().mean()):.4f} of valid frames, on "
              f"{int(agree[sure].sum())}/{int(sure.sum())} frames with margin "
              f"> {2 * TOL_LOGITS} of {int(valid.sum())}", flush=True)
        check(err <= TOL_LOGITS, f"{tag}: logits differ by {err}")
        check(bool(agree[sure].all()), f"{tag}: argmax differs on a clear frame")
        if need_sure:
            share = float(sure.sum()) / float(valid.sum())
            check(share >= MIN_SURE, f"{tag}: only {share:.4f} of frames "
                  "have a clear margin to compare")
        return err

    def alone(row: torch.Tensor, n: int, batch_frames: int) -> torch.Tensor:
        """A batch of one: the first n samples of `row`, zero-padded to
        the batch's frame grid."""
        one = torch.zeros(1, grid_len(n, batch_frames), device=dev)
        one[0, :n] = row[:n]
        return one

    def same_tokens(tok_a, len_a, tok_b, len_b) -> int:
        return sum(int(torch.equal(tok_a[r, :int(len_a[r])],
                                   tok_b[r, :int(len_b[r])]))
                   for r in range(tok_a.shape[0]))

    for fn in COUNTED:
        fn.launches = 0
    with torch.inference_mode():
        enc, elens, logits, tokens, tlens = serve(model, audio, audio_lens)
    torch.cuda.synchronize()
    counts = {"logmel": logmel.launches, "toeplitz": toeplitz_fwd.launches,
              "attention": attention_fwd.launches}
    check(all(fn.launches == 0 for fn in COUNTED[3:]),
          "a backward kernel launched in the forward")
    print(f"[4] main path launches: {counts}", flush=True)
    check(counts == {"logmel": 1, "toeplitz": 1,
                     "attention": mcfg.encoder_layers},
          f"main path launch counts {counts}")
    for key, n in counts.items():
        kernels[key]["launches"] = n
    check(tuple(enc.shape) == (B, T_enc, D) and enc.dtype == torch.bfloat16,
          f"encoder output {tuple(enc.shape)} {enc.dtype}")
    check(tuple(logits.shape) == (B, T_enc, mcfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "logits not finite")
    nf = (audio_lens - WIN) // HOP + 1
    check(torch.equal(elens, ((nf + 1) // 2 + 1) // 2),
          f"encoder lengths {elens.tolist()}")

    with torch.inference_mode():
        _, _, ref_logits, ref_tokens, ref_tlens = serve(
            ref_model, audio, audio_lens)
    compare("[4] kernels vs plain torch (bf16, 12 L, ragged batch)", logits,
            ref_logits, elens, need_sure=True)
    print(f"[4] token sequences equal on "
          f"{same_tokens(tokens, tlens, ref_tokens, ref_tlens)}/{B} rows",
          flush=True)
    # control: the plain model without its relative bias must fail the same
    # comparison, or the tolerance could not see a kernel's bias error
    with torch.no_grad():
        ref_model.encoder.rel.table.zero_()
    with torch.inference_mode():
        ctl_logits = serve(ref_model, audio, audio_lens)[2]
    valid = torch.arange(T_enc, device=dev)[None, :] < elens[:, None]
    ctl = (logits - ctl_logits).abs().amax(-1)[valid].max().item()
    print(f"[4] control, plain model with the relative bias zeroed: max "
          f"|dlogit| {ctl:.4f} (must exceed {TOL_LOGITS})", flush=True)
    check(ctl > TOL_LOGITS, "the logit tolerance cannot see the bias")
    with torch.no_grad():
        ref_model.encoder.rel.table.copy_(table)

    # requests alone (on the batch's frame grid) vs in the ragged batch
    n_same = 0
    for i in ALONE_ROWS:
        n = int(audio_lens[i])
        with torch.inference_mode():
            _, one_elens, one_logits, one_tokens, one_tlens = serve(
                model, alone(audio[i], n, n_frames), audio_lens[i:i + 1])
        L = int(one_elens[0])
        check(L == int(elens[i]), f"request {i} alone: {L} frames")
        compare(f"[4] request {i} ({n / SR:.2f} s) alone vs in the batch",
                one_logits[:, :L], logits[i:i + 1, :L], elens[i:i + 1])
        n_same += same_tokens(one_tokens, one_tlens, tokens[i:i + 1],
                              tlens[i:i + 1])
    print(f"[4] token sequences equal alone and in the batch for "
          f"{n_same}/{len(ALONE_ROWS)} requests", flush=True)

    # the log-mel of one second against the port's numpy oracle (f32), on
    # white noise as in the JAX package's tests: the oracle applies the
    # preemphasis to the samples, the kernel folds it into the basis, and on
    # audio with the test signal's 60 dB of level range the two roundings
    # differ by more than 1e-3 in the quietest bins
    one_sec = 0.1 * torch.randn(SR, device=dev, generator=gen)
    f32_front = fe.Frontend(
        FrontendConfig(cmvn="none", dft_dtype="float32", impl="cuda"), dev)
    got = f32_front(one_sec[None], torch.tensor([SR], device=dev))[0][0]
    want = fe.logmel_np(one_sec.cpu().numpy(), f32_front.cfg)
    err_np = float(np.abs(got.cpu().numpy() - want).max())
    print(f"[4] log-mel kernel (f32) vs numpy oracle, 1 s: max err "
          f"{err_np:.3e} (tol {TOL_LOGMEL})", flush=True)
    check(err_np <= TOL_LOGMEL, f"log-mel vs numpy oracle ({err_np})")

    # ---- [5] a few ragged requests, padded into one batch
    Tr = max(REQUEST_LENS)
    req = torch.zeros(len(REQUEST_LENS), Tr, device=dev)
    for j, n in enumerate(REQUEST_LENS):
        req[j, :n] = audio[j, :n]
    req_lens = torch.tensor(REQUEST_LENS, device=dev)
    with torch.inference_mode():
        _, rlens, rlogits, rtok, rtl = serve(model, req, req_lens)
        _, _, plogits, ptok, ptl = serve(ref_model, req, req_lens)
    nf = (req_lens - WIN) // HOP + 1
    check(torch.equal(rlens, ((nf + 1) // 2 + 1) // 2)
          and bool(torch.isfinite(rlogits).all()), "ragged requests")
    compare("[5] requests vs plain torch", rlogits, plogits, rlens)
    print(f"[5] token sequences equal to plain torch's on "
          f"{same_tokens(rtok, rtl, ptok, ptl)}/{len(REQUEST_LENS)} requests")
    for j, n in enumerate(REQUEST_LENS):
        with torch.inference_mode():
            _, _, jl, jt, jtl = serve(model, alone(req[j], n, n_frames_of(Tr)),
                                      req_lens[j:j + 1])
        L = int(rlens[j])
        compare(f"[5] request {j} alone vs in the batch", jl[:, :L],
                rlogits[j:j + 1, :L], rlens[j:j + 1])
        toks = rtok[j, :int(rtl[j])].tolist()
        print(f"[5] request {j}: {n / SR:.2f} s -> {L} frames, {len(toks)} "
              f"tokens {toks[:16]}{' ...' if len(toks) > 16 else ''}; alone: "
              f"{'same' if same_tokens(jt, jtl, rtok[j:j + 1], rtl[j:j + 1]) else 'other'}"
              f" tokens")
    del ref_model

    # ---- [6] throughput: encode + CTC + greedy at B=32 x 30 s
    rates = []
    with torch.inference_mode():
        for _ in range(2):
            serve(model, audio, full_lens)
        torch.cuda.synchronize()
        for _ in range(WINDOWS):
            t0 = time.perf_counter()
            for _ in range(ITERS):
                out = serve(model, audio, full_lens)
            torch.cuda.synchronize()
            rates.append(B * SECONDS * ITERS / (time.perf_counter() - t0))
    print(f"[6] throughput: median {statistics.median(rates):.1f} audio-s/s "
          f"over {WINDOWS} windows of {ITERS} x (B={B} x {SECONDS:.0f} s) "
          f"(min {min(rates):.1f}, max {max(rates):.1f}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}; "
          f"{time.perf_counter() - t_start:.0f} s since start", flush=True)

    # ---- [7] where the device time goes in one forward (torch.profiler)
    with torch.inference_mode():
        wall_ms, kernel_ms, n = profile_step(
            lambda: serve(model, audio, full_lens), ITERS)
    print_profile("[7] profile of one forward", wall_ms, kernel_ms, n, card)
    del model

    # ---- [8] the training path at full width: the hybrid step
    from pytorch_end2end_speech_recognition_tpu_torch.data.dataset import Batch
    from pytorch_end2end_speech_recognition_tpu_torch.ops.specaugment import (
        spec_augment_mask,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.training.solver import (
        Solver,
    )

    tok = 1 + torch.cumsum(torch.randint(1, V - 1, (B, U_TOKENS), device=dev,
                                         generator=gen), 1) % (V - 1)
    tok_lens = torch.minimum(
        torch.randint(U_TOKENS // 2, U_TOKENS + 1, (B,), device=dev,
                      generator=gen), enc_lens_r // 2)
    tok = tok * (torch.arange(U_TOKENS, device=dev)[None, :]
                 < tok_lens[:, None])
    host = lambda t: t.cpu().numpy()
    batch = Batch(host(audio), host(audio_lens).astype(np.int32),
                  host(tok).astype(np.int32), host(tok_lens).astype(np.int32))
    spec_mask = spec_augment_mask(front.frame_lens(audio_lens), n_frames,
                                  fcfg.n_mels, fcfg, gen)

    def train_cfg(impl: str, dropout: float):
        c = flagship_conformer()
        c.model.encoder_dropout = c.model.decoder_dropout = dropout
        if impl == "torch":
            c.frontend.impl = "torch"
            c.model.attn_impl = c.model.ctc_impl = "torch"
        return c

    def solver_with_table(impl: str, tbl) -> "Solver":
        sv = Solver(train_cfg(impl, 0.0), V, device=dev)
        with torch.no_grad():
            sv.model.encoder.rel.table.copy_(tbl)
        return sv

    ks = solver_with_table("cuda", table)
    check(ks.cfg.model.ctc_impl == "cuda" and ks.cfg.model.attn_impl == "cuda"
          and ks.model.decoder is not None, "the train step is not on the "
          "kernels or has no decoder")
    for fn in COUNTED:
        fn.launches = 0
    km, kg = ks.grads(batch, spec_mask=spec_mask)
    torch.cuda.synchronize()
    step_counts = {"logmel": logmel.launches,
                   "toeplitz": toeplitz_fwd.launches,
                   "attention": attention_fwd.launches,
                   "attention_bwd": attention_bwd.launches,
                   "toeplitz_reduce": toeplitz_reduce.launches,
                   "ctc_alpha": ctc_alpha.launches,
                   "ctc_beta": ctc_beta.launches}
    print(f"[8] hybrid step launches: {step_counts}", flush=True)
    L = mcfg.encoder_layers
    check(step_counts == {"logmel": 1, "toeplitz": 1, "attention": L,
                          "attention_bwd": L, "toeplitz_reduce": 1,
                          "ctc_alpha": 1, "ctc_beta": 1},
          f"train step launch counts {step_counts}")
    for key in ("attention_bwd", "toeplitz_reduce", "ctc_alpha", "ctc_beta"):
        kernels[key]["launches"] = step_counts[key]
    kg = {n: g.detach() for n, g in zip(ks.names, kg)}
    check(all(bool(torch.isfinite(g).all()) for g in kg.values())
          and all(bool(torch.isfinite(v)) for v in km.values()),
          "kernel train step not finite")
    del ks
    ps = solver_with_table("torch", table)
    pm, pg = ps.grads(batch, spec_mask=spec_mask)
    pg = {n: g.detach() for n, g in zip(ps.names, pg)}
    torch.cuda.synchronize()
    d_loss = abs(float(km["loss"]) - float(pm["loss"])) / float(pm["loss"])
    cmin, rmax, cmed, n_cmp = grad_stats(kg, pg)
    print(f"[8] kernels vs plain torch, one hybrid step (B={B} x "
          f"{SECONDS:.0f} s ragged, U<={U_TOKENS}, bf16, 12 L): loss "
          f"{float(km['loss']):.5f} vs {float(pm['loss']):.5f} (ctc "
          f"{float(km['ctc_loss']):.4f} vs {float(pm['ctc_loss']):.4f}, att "
          f"{float(km['att_loss']):.4f} vs {float(pm['att_loss']):.4f}), "
          f"relative |d loss| {d_loss:.2e} (tol {TOL_TRAIN_LOSS}); gradients "
          f"of {n_cmp} parameters: cosine min {cmin:.5f} median {cmed:.5f} "
          f"(tol {TRAIN_MIN_COS}), relative error max {rmax:.4f} (tol "
          f"{TRAIN_MAX_REL})", flush=True)
    check(d_loss <= TOL_TRAIN_LOSS and cmin >= TRAIN_MIN_COS
          and rmax <= TRAIN_MAX_REL, "kernel train step disagrees with plain")
    # control: the plain model without its relative bias must fail
    with torch.no_grad():
        ps.model.encoder.rel.table.zero_()
    cm, cg = ps.grads(batch, spec_mask=spec_mask)
    cg = {n: g.detach() for n, g in zip(ps.names, cg)}
    c_loss = abs(float(cm["loss"]) - float(km["loss"])) / float(cm["loss"])
    cmin_c, rmax_c, cmed_c, _ = grad_stats(kg, cg)
    print(f"[8] control, plain model with the relative bias zeroed: relative "
          f"|d loss| {c_loss:.2e}, cosine min {cmin_c:.5f} median "
          f"{cmed_c:.5f}, relative error max {rmax_c:.4f} (must fail)",
          flush=True)
    check(c_loss > TOL_TRAIN_LOSS or cmin_c < TRAIN_MIN_COS
          or rmax_c > TRAIN_MAX_REL, "the train-step tolerance cannot see "
          "the bias")
    del ps, pg, cg, kg

    # five Solver steps on the kernels, dropout 0.1 and SpecAugment drawn
    # from the Solver's generator on the card
    solver = Solver(flagship_conformer(), V, device=dev)
    check(solver.cfg.model.encoder_dropout > 0
          and solver.cfg.frontend.spec_augment, "training draws are off")
    solver.cfg.train.log_every = 1
    solver.fit([batch] * 5, steps=5)
    losses = [r["loss"] for r in solver.log]
    print(f"[8] 5 Solver steps (dropout 0.1, SpecAugment on): loss "
          f"{[round(x, 4) for x in losses]}, grad_norm "
          f"{[round(r['grad_norm'], 3) for r in solver.log]}", flush=True)
    check(len(losses) == 5 and all(math.isfinite(x) for x in losses)
          and all(bool(torch.isfinite(p).all())
                  for p in solver.model.parameters()),
          "Solver steps not finite")

    # train throughput: full 30 s rows, audio-seconds per second
    full_batch = Batch(batch.audio, np.full(B, Ts, np.int32), batch.tokens,
                       batch.token_lens)
    solver.train_step(full_batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rates = []
    for _ in range(TRAIN_WINDOWS):
        t0 = time.perf_counter()
        for _ in range(TRAIN_ITERS):
            solver.train_step(full_batch)
        torch.cuda.synchronize()
        rates.append(B * SECONDS * TRAIN_ITERS / (time.perf_counter() - t0))
    print(f"[8] train throughput: median {statistics.median(rates):.1f} "
          f"audio-s/s over {TRAIN_WINDOWS} windows of {TRAIN_ITERS} steps x "
          f"(B={B} x {SECONDS:.0f} s, U={U_TOKENS}, hybrid lambda "
          f"{mcfg.ctc_weight}) (min {min(rates):.1f}, max {max(rates):.1f}); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB;"
          f" {card}; {time.perf_counter() - t_start:.0f} s since start",
          flush=True)
    wall_ms, kernel_ms, n = profile_step(
        lambda: solver.train_step(full_batch), TRAIN_ITERS)
    print_profile("[8] profile of one train step", wall_ms, kernel_ms, n,
                  card)

    order = ("logmel", "toeplitz", "attention", "attention_bwd",
             "toeplitz_reduce", "ctc_alpha", "ctc_beta")
    print(json.dumps({"kernels": [kernels[k] for k in order]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
