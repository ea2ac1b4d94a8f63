"""What every family's plain reference shares: the precision switch of
its matrix products, float32 without TF32, and the log-mel front end with
per-utterance CMVN (its own DFT basis and mel filterbank).

Every matrix product goes through `Prec.q`, so one switch runs a whole
model with its operands rounded to float8 (e4m3, one scale a tensor): the
lower-precision control that the correctness limits are set against. With
`Prec("fp32")` nothing is rounded; the caller turns TF32 off (`no_tf32`).
Plain PyTorch and NumPy; imports nothing of the measured program.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

LOG_EPS = 1e-10
FP8_MAX = 448.0


class Prec:
    """The precision of every matrix product's operands: 'fp32' (as they
    are) or 'fp8' (rounded to float8 e4m3 with one scale a tensor; the
    gradient passes straight through the rounding)."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def q(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        if self.kind == "fp32":
            return t
        scale = FP8_MAX / t.detach().abs().amax().clamp(min=1e-30)
        r = (t.detach() * scale).to(torch.float8_e4m3fn).float() / scale
        return t + (r - t.detach())


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: both TF32 switches off, then restored."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


# ------------------------------------------------------------ front end
def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filterbank(n_mels: int, n_fft: int, sr: int, fmin: float,
                   fmax: float | None) -> np.ndarray:
    """HTK-scale triangular filters, (n_fft // 2 + 1, n_mels), unnormalized."""
    fmax = fmax or sr / 2.0
    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                n_mels + 2))
    fb = np.zeros((freqs.size, n_mels))
    for i in range(n_mels):
        lo, c, hi = hz[i], hz[i + 1], hz[i + 2]
        up = (freqs - lo) / max(c - lo, 1e-10)
        down = (hi - freqs) / max(hi - c, 1e-10)
        fb[:, i] = np.maximum(0.0, np.minimum(up, down))
    return fb


def dft_basis(n_fft: int, win: int) -> np.ndarray:
    """(win, 2 * (n_fft // 2 + 1)): the periodic Hann window times cos and
    -sin of the real DFT, so frames @ basis gives (Re | Im)."""
    n = np.arange(win)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(win) / win)
    ang = 2 * np.pi * n * k / n_fft
    return np.concatenate([w[:, None] * np.cos(ang),
                           -w[:, None] * np.sin(ang)], axis=1)


def frame_count(samples, fe: dict):
    """Frames of `samples` (int or tensor), no centring."""
    win = round(fe["sample_rate"] * fe["win_ms"] / 1000)
    hop = round(fe["sample_rate"] * fe["hop_ms"] / 1000)
    if isinstance(samples, torch.Tensor):
        return torch.clamp((samples - win) // hop + 1, min=0)
    return max(0, (int(samples) - win) // hop + 1)


def logmel(audio: torch.Tensor, lens: torch.Tensor, fe: dict,
           prec: Prec) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, Ts) audio, (B,) samples -> (log-mel (B, N, M) with per-utterance
    CMVN over the valid frames and zeros past them, frame lengths)."""
    sr = fe["sample_rate"]
    win = round(sr * fe["win_ms"] / 1000)
    hop = round(sr * fe["hop_ms"] / 1000)
    a = fe["preemphasis"]
    x = audio.float()
    y = torch.cat([x[:, :1], x[:, 1:] - a * x[:, :-1]], dim=1)
    N = frame_count(x.shape[1], fe)
    frames = y.unfold(1, win, hop)[:, :N]
    basis = torch.tensor(dft_basis(fe["n_fft"], win), dtype=torch.float32,
                         device=x.device)
    reim = torch.matmul(prec.q(frames), prec.q(basis))
    nb = basis.shape[1] // 2
    power = reim[..., :nb] ** 2 + reim[..., nb:] ** 2
    fb = torch.tensor(mel_filterbank(fe["n_mels"], fe["n_fft"], sr,
                                     fe["fmin"], fe["fmax"]),
                      dtype=torch.float32, device=x.device)
    feats = torch.log(torch.matmul(prec.q(power), prec.q(fb)) + LOG_EPS)
    flens = frame_count(lens, fe)
    valid = (torch.arange(N, device=x.device)[None, :] < flens[:, None])[
        ..., None]
    if fe["cmvn"] != "utt":
        raise ValueError("the reference implements cmvn='utt' only")
    d = torch.where(valid, feats, 0.0).double()
    n = flens.clamp(min=1).double()[:, None, None]
    mean = d.sum(1, keepdim=True) / n
    var = (torch.where(valid, d - mean, 0.0) ** 2).sum(1, keepdim=True) / n
    out = ((d - mean) / torch.sqrt(var + 1e-8)).float()
    return torch.where(valid, out, 0.0), flens
