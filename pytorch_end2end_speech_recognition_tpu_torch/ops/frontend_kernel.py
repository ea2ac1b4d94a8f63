"""Fused log-mel: the CUDA kernel (`csrc/logmel.cu`) and its plain version.

Counterpart of the JAX package's `ops/frontend_pallas.py`. Preemphasis
y[n] = x[n] - a*x[n-1] is linear, so the windowed DFT of y is a product of
the RAW samples with a modified basis (`preemph_dft_bases`); the kernel and
its plain version both read raw padded audio and return masked log-mel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

LOG_EPS = 1e-10


def preemph_dft_bases(cos_b: np.ndarray, sin_b: np.ndarray,
                      alpha: float) -> tuple[np.ndarray, np.ndarray]:
    """Fold preemphasis into the windowed-DFT bases (win, n_bins).

    Returns (basis (win, 2*n_bins) = [cos | sin] with row m carrying
    w[m]e[m,k] - alpha*w[m+1]e[m+1,k], basis_prev (1, 2*n_bins) =
    -alpha*w[0]e[0,k], the coefficient of the sample before the frame).
    Unlike the TPU version, rows and bins are not padded to lane multiples.
    """
    win = cos_b.shape[0]

    def ext(b):  # float32 arithmetic, as the JAX package folds it
        e = np.array(b, np.float32)
        e[: win - 1] -= np.float32(alpha) * b[1:].astype(np.float32)
        return e

    basis = np.concatenate([ext(cos_b), ext(sin_b)], axis=1)
    prev = np.float32(-alpha) * np.concatenate(
        [cos_b[:1], sin_b[:1]], axis=1).astype(np.float32)
    return basis, prev


def logmel_plain(audio: torch.Tensor, basis: torch.Tensor,
                 basis_prev: torch.Tensor, mel_b: torch.Tensor, hop: int,
                 n_frames: int, frame_lens: torch.Tensor) -> torch.Tensor:
    """(B, Ts) raw audio -> (B, n_frames, M) masked log-mel, float32.

    The same arithmetic as the kernel in plain torch: samples rounded to the
    basis dtype, float32 products and sums, the predecessor sample's term,
    power, mel product, log, and zeros at frames >= frame_lens."""
    B = audio.shape[0]
    win, two_f = basis.shape
    n_bins = two_f // 2
    if n_frames == 0:
        return audio.new_zeros((B, 0, mel_b.shape[1]), dtype=torch.float32)
    x = audio.to(basis.dtype).float()
    frames = x.unfold(1, win, hop)[:, :n_frames]                # (B, T, win)
    prev = F.pad(x[:, hop - 1:(n_frames - 1) * hop:hop], (1, 0))  # (B, T)
    reim = frames @ basis.float() + prev[..., None] * basis_prev.float()
    re, im = reim[..., :n_bins], reim[..., n_bins:]
    mel = (re * re + im * im) @ mel_b.float()
    out = torch.log(mel + LOG_EPS)
    valid = torch.arange(n_frames, device=audio.device)[None, :] < frame_lens[:, None]
    return torch.where(valid[..., None], out, torch.zeros((), device=out.device))


BAND_CHUNK = 32  # bins per chunk of the tensor-core kernel


def mel_band_ranges(mel_b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Each band's nonzero bin range of the filterbank mel_b (n_bins, M):
    (lo, hi), int64 (M,), the first and the last bin with a nonzero weight;
    a band without one gets the empty range (n_bins, -1). Computed from the
    matrix given: no triangle, order or shape is assumed."""
    n_bins = mel_b.shape[0]
    nz = mel_b != 0
    idx = torch.arange(n_bins, device=mel_b.device)[:, None]
    lo = torch.where(nz, idx, n_bins).amin(0)
    hi = torch.where(nz, idx, -1).amax(0)
    return lo, hi


def mel_plan(mel_b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """What the tensor-core kernel reads of the filterbank mel_b (n_bins,
    M), on its device, with no host sync: (bands, mel_b transposed to (M,
    n_bins), contiguous: a band's bins adjacent). bands is int32 (2 + 2M,):
    k_lo (the first bin any band reads), the number of BAND_CHUNK-bin
    chunks from k_lo to the last such bin (0 when every weight is 0), then
    `mel_band_ranges`' lo and hi."""
    lo, hi = mel_band_ranges(mel_b)
    k_lo = lo.amin().clamp(max=mel_b.shape[0] - 1)
    n_ch = torch.div(hi.amax() - k_lo + BAND_CHUNK, BAND_CHUNK,
                     rounding_mode="floor").clamp(min=0)
    bands = torch.cat([k_lo[None], n_ch[None], lo, hi]).to(torch.int32)
    return bands, mel_b.t().contiguous()


def mel_ranged(power: torch.Tensor, mel_b: torch.Tensor, lo: torch.Tensor,
               hi: torch.Tensor) -> torch.Tensor:
    """power (..., n_bins) @ mel_b as the kernel sums it: band m adds
    power[..., k] mel_b[k, m] for k = lo[m], ..., hi[m] in ascending order,
    in float32. Equal to the full product wherever [lo, hi] covers every
    nonzero weight (the terms left out are exact zeros)."""
    power, mel_b = power.float(), mel_b.float()
    out = power.new_zeros((*power.shape[:-1], mel_b.shape[1]))
    for k in range(mel_b.shape[0]):
        w = torch.where((lo <= k) & (k <= hi), mel_b[k], 0.0)
        out = out + power[..., k:k + 1] * w
    return out


def logmel(audio: torch.Tensor, basis: torch.Tensor, basis_prev: torch.Tensor,
           mel_b: torch.Tensor, hop: int, n_frames: int,
           frame_lens: torch.Tensor,
           plan: tuple[torch.Tensor, torch.Tensor] | None = None
           ) -> torch.Tensor:
    """The log-mel kernel on CUDA tensors; the plain version on CPU tensors.

    audio (B, Ts) float32, basis (win, 2F) float32 or bfloat16, basis_prev
    (1, 2F) float32, mel_b (F, M) float32, frame_lens (B,) integer; plan
    `mel_plan(mel_b)` where the caller keeps it (`Frontend` does), else it
    is computed here. Runs as the operator `asr_port::logmel`, so that an
    exported program (`serving/export.py`) calls the kernel too."""
    bands, mel_t = (None, None) if plan is None else plan
    return logmel_op(audio, basis, basis_prev, mel_b, hop, n_frames,
                     frame_lens, bands, mel_t)


logmel.launches = 0


@torch.library.custom_op(
    "asr_port::logmel", mutates_args=(), device_types="cpu",
    schema="(Tensor audio, Tensor basis, Tensor basis_prev, Tensor mel_b, "
           "int hop, int n_frames, Tensor frame_lens, Tensor? bands, "
           "Tensor? mel_t) -> Tensor")
def logmel_op(audio, basis, basis_prev, mel_b, hop, n_frames, frame_lens,
              bands, mel_t):
    """The operator's CPU version: `logmel_plain` (the plan is not read)."""
    return logmel_plain(audio, basis, basis_prev, mel_b, hop, n_frames,
                        frame_lens)


@logmel_op.register_fake
def _logmel_fake(audio, basis, basis_prev, mel_b, hop, n_frames, frame_lens,
                 bands, mel_t):
    return audio.new_empty((audio.shape[0], n_frames, mel_b.shape[1]),
                           dtype=torch.float32)


@logmel_op.register_kernel("cuda")
def _logmel_cuda(audio, basis, basis_prev, mel_b, hop, n_frames, frame_lens,
                 bands, mel_t):
    """The operator's CUDA version: checks what the kernel takes, launches
    it and counts the launch on `logmel.launches`."""
    from pytorch_end2end_speech_recognition_tpu_torch.ops import _build

    plan = None if bands is None else (bands, mel_t)
    B, Ts = audio.shape
    win, two_f = basis.shape
    n_bins, M = mel_b.shape
    for name, t in (("basis", basis), ("basis_prev", basis_prev),
                    ("mel_b", mel_b), ("frame_lens", frame_lens)):
        if t.device != audio.device:
            raise ValueError(f"logmel: {name} on {t.device}, audio on "
                             f"{audio.device}")
    if audio.dtype != torch.float32:
        raise TypeError(f"logmel: audio must be float32, got {audio.dtype}")
    if basis.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"logmel: basis must be float32 or bfloat16, got "
                        f"{basis.dtype}")
    if basis_prev.dtype != torch.float32 or mel_b.dtype != torch.float32:
        raise TypeError("logmel: basis_prev and mel_b must be float32")
    if two_f != 2 * n_bins or basis_prev.shape != (1, two_f):
        raise ValueError(f"logmel: basis {tuple(basis.shape)}, basis_prev "
                         f"{tuple(basis_prev.shape)} and mel_b "
                         f"{tuple(mel_b.shape)} disagree")
    if basis.dtype == torch.bfloat16 and (win % 8 or win > 448 or M > 128
                                          or n_bins > 512):
        raise ValueError(f"logmel tensor-core kernel needs win a multiple of "
                         f"8 and at most 448, at most 128 mels and 512 bins "
                         f"(win={win}, hop={hop}, mels={M}, bins={n_bins})")
    if basis.dtype == torch.float32 and (win % 4 or hop % 4 or n_bins > 512):
        raise ValueError(f"logmel kernel needs win and hop multiples of 4 "
                         f"and at most 512 bins (win={win}, hop={hop}, "
                         f"bins={n_bins})")
    if n_frames < 0 or (n_frames > 0 and (n_frames - 1) * hop + win > Ts):
        raise ValueError(f"logmel: {n_frames} frames do not fit {Ts} samples")
    out = torch.empty((B, n_frames, M), dtype=torch.float32,
                      device=audio.device)
    if B == 0 or n_frames == 0:
        return out
    audio = audio.contiguous()
    basis_prev, mel_b = basis_prev.contiguous(), mel_b.contiguous()
    flens = frame_lens.to(torch.int32).contiguous()
    lib = _build.load()
    stream = torch.cuda.current_stream(audio.device).cuda_stream
    if basis.dtype == torch.bfloat16:
        # the tensor-core kernel reads the basis bin-major, (2F, win); a basis
        # stored that way (as `Frontend` keeps it) passes without a copy
        bands, mel_t = mel_plan(mel_b) if plan is None else plan
        if (bands.dtype != torch.int32 or bands.shape != (2 + 2 * M,)
                or bands.device != audio.device
                or mel_t.shape != (M, n_bins) or mel_t.device != audio.device
                or mel_t.dtype != torch.float32):
            raise ValueError(f"logmel: plan must be int32 ({2 + 2 * M},) "
                             f"bands and float32 ({M}, {n_bins}) mel_t on "
                             f"{audio.device}")
        basis_t, bands = basis.t().contiguous(), bands.contiguous()
        mel_t = mel_t.contiguous()
        vec4 = int(audio.data_ptr() % 16 == 0 and Ts % 4 == 0 and hop % 4 == 0)
        err = lib.logmel_bf16_launch(
            audio.data_ptr(), basis_t.data_ptr(), basis_prev.data_ptr(),
            mel_t.data_ptr(), bands.data_ptr(), flens.data_ptr(),
            out.data_ptr(), B, Ts, n_frames, hop, win, n_bins, M, vec4,
            stream)
    else:
        basis = basis.contiguous()
        err = lib.logmel_f32_launch(
            audio.data_ptr(), basis.data_ptr(), basis_prev.data_ptr(),
            mel_b.data_ptr(), flens.data_ptr(), out.data_ptr(), B, Ts,
            n_frames, hop, win, n_bins, M, stream)
    _build.check(err, "logmel")
    logmel.launches += 1
    return out
