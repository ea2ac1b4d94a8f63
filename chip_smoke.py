"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases, every one of which must pass (the script exits non-zero otherwise):

1. versions, and the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from `csrc/` (parallel nvcc, ptxas -v printed);
3. each kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it, with kernel, plain, library and bound times, and
   for the attention kernel two controls (bias dropped, lengths ignored)
   that must fail the same check;
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
   device time by kernel group and by kernel.

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


# kernel-name patterns for the profile summary, first match wins
PROFILE_GROUPS = (
    ("logmel", ("logmel_",)),
    ("toeplitz", ("toeplitz_kernel",)),
    ("attention", ("attention_kernel",)),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "sm90_")),
    ("conv", ("conv", "cudnn", "implicit")),
    ("layer_norm", ("layer_norm", "layernorm")),
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
        attention_plain,
        fused_attention,
        toeplitz_dense,
        toeplitz_expand,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops.ctc import (
        ctc_greedy_decode,
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
        out = toeplitz_dense(diag, T_enc, P, dt)
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
                ms=cuda_ms(lambda: toeplitz_dense(diag, T_enc, P, dt)),
                plain_ms=cuda_ms(
                    lambda: toeplitz_expand(diag, P, P, T=T_enc).to(dt)),
                bound_ms=b_ms, bound_by=b_by, library_ms=None)
        del out, ref
    # the first layer's (H, P, P) bias, std BIAS_STD
    bias = toeplitz_dense(diag, T_enc, P, torch.bfloat16)[:mcfg.encoder_heads]

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
        ms=cuda_ms(lambda: fused_attention(q, k, v, bias, full, H)),
        plain_ms=cuda_ms(lambda: attention_plain(q, k, v, bias, full, H)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: sdpa(qh, kh, vh, attn_mask=sdpa_mask)))
    del q, k, v, qh, kh, vh, sdpa_mask

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

    for fn in (logmel, toeplitz_dense, fused_attention):
        fn.launches = 0
    with torch.inference_mode():
        enc, elens, logits, tokens, tlens = serve(model, audio, audio_lens)
    torch.cuda.synchronize()
    counts = {"logmel": logmel.launches, "toeplitz": toeplitz_dense.launches,
              "attention": fused_attention.launches}
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
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        serve(model, audio, full_lens)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(ITERS):
                serve(model, audio, full_lens)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / ITERS
    kernel_ms, n_launch = {}, 0
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            t = getattr(ev, "self_device_time_total", None)
            if t is None:
                t = ev.self_cuda_time_total
            kernel_ms[ev.key] = t / 1e3 / ITERS
            n_launch += ev.count
    busy = sum(kernel_ms.values())
    groups = {}
    for key, t in kernel_ms.items():
        low = key.lower()
        grp = next((g for g, pats in PROFILE_GROUPS if any(p in low for p in pats)),
                   "other")
        groups[grp] = groups.get(grp, 0.0) + t
    print(f"[7] profile of one forward: wall {wall_ms:.3f} ms, device busy "
          f"{busy:.3f} ms (idle share {1 - busy / wall_ms:.3f}), "
          f"{n_launch / ITERS:.0f} device kernels; {card}")
    for grp, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"    {grp:12s} {t:8.3f} ms  {100 * t / max(busy, 1e-9):5.1f}%")
    for key, t in sorted(kernel_ms.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {t:8.3f} ms  {key[:110]}")

    order = ("logmel", "toeplitz", "attention")
    print(json.dumps({"kernels": [kernels[k] for k in order]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
