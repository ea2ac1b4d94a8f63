"""Feature front-end: preemphasis -> framing -> DFT -> log-mel -> CMVN.

The port of the JAX package's `ops/frontend.py`. The DFT is a matrix
product against [cos | sin] bases with the Hann window (and preemphasis)
folded in, the mel projection another product. `Frontend` keeps the bases
as buffers and runs the fused kernel (`ops/frontend_kernel.py`) when its
implementation is 'cuda', the same arithmetic in plain torch when 'torch'.
HTK mel scale, triangular filters, no normalization. `logmel_np` is the
numpy oracle for tests, and `compute_global_cmvn` runs it over a manifest
to write the statistics that `cmvn='global'` reads.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn

from pytorch_end2end_speech_recognition_tpu_torch.ops.frontend_kernel import (
    logmel,
    logmel_plain,
    mel_plan,
    preemph_dft_bases,
)
from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
    FrontendConfig,
)

LOG_EPS = 1e-10


# ---------------------------------------------------------------- mel basis
def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filterbank(
    n_mels: int, n_fft: int, sample_rate: int, fmin: float = 0.0,
    fmax: float | None = None,
) -> np.ndarray:
    """Triangular HTK mel filterbank, shape (n_fft//2 + 1, n_mels)."""
    fmax = fmax or sample_rate / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fb = np.zeros((n_bins, n_mels), np.float64)
    for m in range(n_mels):
        lo, c, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (fft_freqs - lo) / max(c - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - c, 1e-10)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb.astype(np.float32)


def dft_bases(n_fft: int, win_length: int) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT as matmul: (win_length, n_bins) cos and -sin bases with the
    Hann window folded in. frames @ cos_b, frames @ sin_b give Re/Im."""
    n_bins = n_fft // 2 + 1
    window = np.hanning(win_length + 1)[:-1].astype(np.float64)  # periodic Hann
    n = np.arange(win_length)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = -2.0 * np.pi * n * k / n_fft
    cos_b = (window[:, None] * np.cos(ang)).astype(np.float32)
    sin_b = (window[:, None] * np.sin(ang)).astype(np.float32)
    return cos_b, sin_b


def num_frames(n_samples, win_length: int, hop_length: int):
    """Frame count for center=False framing; works on ints or tensors."""
    if isinstance(n_samples, torch.Tensor):
        return torch.clamp((n_samples - win_length) // hop_length + 1, min=0)
    return max(0, (int(n_samples) - win_length) // hop_length + 1)


# ---------------------------------------------------------------- numpy oracle
def logmel_np(x: np.ndarray, cfg: FrontendConfig) -> np.ndarray:
    """Numpy reference: (T_samples,) -> (T_frames, n_mels). Test oracle."""
    win, hop = cfg.win_length, cfg.hop_length
    x = np.asarray(x, np.float32)
    x = np.concatenate([x[:1], x[1:] - cfg.preemphasis * x[:-1]])
    T = max(0, (len(x) - win) // hop + 1)
    frames = np.stack([x[t * hop : t * hop + win] for t in range(T)]) if T else (
        np.zeros((0, win), np.float32)
    )
    cos_b, sin_b = dft_bases(cfg.n_fft, win)
    re, im = frames @ cos_b, frames @ sin_b
    power = re * re + im * im
    mel = power @ mel_filterbank(
        cfg.n_mels, cfg.n_fft, cfg.sample_rate, cfg.fmin, cfg.fmax
    )
    return np.log(mel + LOG_EPS).astype(np.float32)


# ---------------------------------------------------------------- torch module
class Frontend(nn.Module):
    """Log-mel front-end with its static bases as buffers.

    `cfg` must be resolved (`utils.config.resolve_device`): impl 'cuda' or
    'torch', dft_dtype 'float32' or 'bfloat16'."""

    def __init__(self, cfg: FrontendConfig, device=None):
        super().__init__()
        from pytorch_end2end_speech_recognition_tpu_torch.utils import device as dv

        dev = dv.resolve(device)
        if cfg.impl not in ("torch", "cuda") or cfg.dft_dtype not in (
                "float32", "bfloat16"):
            raise ValueError(
                f"unresolved frontend config (impl={cfg.impl!r}, dft_dtype="
                f"{cfg.dft_dtype!r}); pass it through resolve_device first")
        if cfg.impl == "cuda" and dev.type != "cuda":
            raise ValueError("frontend impl 'cuda' needs a CUDA device")
        self.cfg = dataclasses.replace(cfg)
        self.win = cfg.win_length
        self.hop = cfg.hop_length
        cos_b, sin_b = dft_bases(cfg.n_fft, self.win)
        basis, basis_prev = preemph_dft_bases(cos_b, sin_b, cfg.preemphasis)
        bdt = torch.bfloat16 if cfg.dft_dtype == "bfloat16" else torch.float32
        basis = torch.from_numpy(basis).to(dev, bdt)
        if bdt == torch.bfloat16:
            # a (win, 2F) view of bin-major (2F, win) storage: the layout the
            # tensor-core kernel reads, so no forward transposes the basis
            basis = basis.t().contiguous().t()
        self.register_buffer("basis", basis)
        self.register_buffer("basis_prev", torch.from_numpy(basis_prev).to(dev))
        self.register_buffer("mel_b", torch.from_numpy(mel_filterbank(
            cfg.n_mels, cfg.n_fft, cfg.sample_rate, cfg.fmin, cfg.fmax)).to(dev))
        # what the tensor-core kernel reads of the filterbank
        bands, mel_t = mel_plan(self.mel_b)
        self.register_buffer("mel_bands", bands, persistent=False)
        self.register_buffer("mel_t", mel_t, persistent=False)
        mean = std = None
        if cfg.cmvn == "global":
            if not cfg.cmvn_stats_path or not Path(cfg.cmvn_stats_path).exists():
                raise FileNotFoundError(
                    "cmvn='global' needs cmvn_stats_path: a JSON file with "
                    "'mean' and 'std' lists of n_mels values")
            d = json.loads(Path(cfg.cmvn_stats_path).read_text())
            mean = torch.tensor(d["mean"], dtype=torch.float32, device=dev)
            std = torch.tensor(d["std"], dtype=torch.float32, device=dev)
        elif cfg.cmvn not in ("utt", "none"):
            raise ValueError(f"unknown cmvn mode {cfg.cmvn!r}")
        self.register_buffer("global_mean", mean)
        self.register_buffer("global_std", std)

    def n_frames(self, n_samples: int) -> int:
        return num_frames(n_samples, self.win, self.hop)

    def frame_lens(self, audio_lens: torch.Tensor) -> torch.Tensor:
        return num_frames(audio_lens, self.win, self.hop)

    @torch.no_grad()
    def forward(self, audio: torch.Tensor, audio_lens: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, Ts), (B,) -> log-mel (B, T, n_mels) float32, frame_lens (B,).
        Frames past each row's length are exact zeros."""
        T = self.n_frames(audio.shape[1])
        flens = self.frame_lens(audio_lens)
        args = (audio.float(), self.basis, self.basis_prev, self.mel_b,
                self.hop, T, flens)
        feats = (logmel(*args, plan=(self.mel_bands, self.mel_t))
                 if self.cfg.impl == "cuda" else logmel_plain(*args))
        if self.cfg.cmvn == "utt":
            feats = cmvn_utt(feats, flens)
        elif self.cfg.cmvn == "global":
            mask = (torch.arange(T, device=feats.device)[None, :]
                    < flens[:, None])[..., None]
            feats = (feats - self.global_mean) / self.global_std
            feats = torch.where(mask, feats, torch.zeros((), device=feats.device))
        return feats, flens


def compute_global_cmvn(manifest_path: str, cfg: FrontendConfig,
                        out_path: str, max_utts: int = 2000) -> dict:
    """Log-mel mean and std over the frames of a manifest's first
    `max_utts` utterances, computed on the host with `logmel_np`, written
    as the JSON {mean, std, frames} that `cmvn='global'` reads."""
    from pytorch_end2end_speech_recognition_tpu_torch.data.audio import (
        load_audio,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.data.manifest import (
        read_manifest,
    )

    s0, s1, s2 = 0, None, None
    for u in read_manifest(manifest_path)[:max_utts]:
        f = logmel_np(load_audio(u.audio, cfg.sample_rate), cfg)
        if s1 is None:
            s1 = f.sum(axis=0)
            s2 = (f ** 2).sum(axis=0)
        else:
            s1 += f.sum(axis=0)
            s2 += (f ** 2).sum(axis=0)
        s0 += f.shape[0]
    mean = s1 / max(s0, 1)
    std = np.sqrt(np.maximum(s2 / max(s0, 1) - mean ** 2, 1e-8))
    stats = {"mean": mean.tolist(), "std": std.tolist(), "frames": int(s0)}
    Path(out_path).write_text(json.dumps(stats))
    return stats


def cmvn_utt(feats: torch.Tensor, frame_lens: torch.Tensor) -> torch.Tensor:
    """Per-utterance mean/variance normalization over valid frames only.

    One pass for both moments, taken of `feats - feats[:, 0]` (the first
    frame as a per-row shift): raw E[x^2]-E[x]^2 on log-mels with means near
    -23 cancels to ~mean^2*eps, so near-silent rows would hit the variance
    floor; shifting keeps E[d^2] the size of the variance itself."""
    T = feats.shape[1]
    mask = (torch.arange(T, device=feats.device)[None, :]
            < frame_lens[:, None])[..., None]
    n = torch.clamp(frame_lens[:, None, None].to(feats.dtype), min=1.0)
    off = feats[:, :1, :]  # valid whenever frame_lens > 0
    zero = torch.zeros((), dtype=feats.dtype, device=feats.device)
    d = torch.where(mask, feats - off, zero)
    s1 = d.sum(dim=1, keepdim=True)
    s2 = (d * d).sum(dim=1, keepdim=True)
    mean_c = s1 / n
    var = torch.clamp(s2 / n - mean_c * mean_c, min=0.0)
    out = (d - mean_c) * torch.rsqrt(var + 1e-8)
    return torch.where(mask, out, zero)
