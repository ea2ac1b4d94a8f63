"""SpecAugment frequency and time masking (the port of the JAX package's
`ops/specaugment.py`), on the features' device.

Policy (Park et al. 2019, as the reference draws it): `n_freq_masks` bands of
width w ~ U[0, F_param] starting in [0, max(F - w, 1)); `n_time_masks` spans
of width min(U[0, T_param], max_t), max_t = min(T_param, max(int(len *
ratio), 1)), starting in [0, max(len - w, 1)) so they stay inside the
row's frames. The draws come from an explicit `torch.Generator` (the JAX
package's keys give other numbers); a caller may pass the mask instead,
which is how the tests hold the port to the reference. Time warp (off by
default, `time_warp_param=0`) is not ported yet.
"""

from __future__ import annotations

import torch

from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
    FrontendConfig,
)


def _uniform_int(high: torch.Tensor, gen, shape) -> torch.Tensor:
    """Integers uniform in [0, high) per row; high (B, 1) >= 1."""
    u = torch.rand(shape, generator=gen, device=high.device)
    return torch.minimum((u * high).long(), high - 1)


def spec_augment_mask(frame_lens: torch.Tensor, T: int, F: int,
                      cfg: FrontendConfig, generator: torch.Generator | None,
                      dtype=torch.float32) -> torch.Tensor:
    """A (B, T, F) mask of 0s (masked) and 1s drawn from `generator`."""
    if cfg.time_warp_param > 0:
        raise NotImplementedError("SpecAugment time warp is not ported yet "
                                  "(set frontend.time_warp_param=0)")
    B = frame_lens.shape[0]
    dev = frame_lens.device
    lens = frame_lens.long()[:, None]
    t_idx = torch.arange(T, device=dev)[None, :]
    f_idx = torch.arange(F, device=dev)[None, :]
    keep_f = torch.ones((B, F), dtype=torch.bool, device=dev)
    for _ in range(cfg.n_freq_masks):
        w = _uniform_int(torch.full((B, 1), cfg.freq_mask_param + 1,
                                    device=dev), generator, (B, 1))
        start = _uniform_int(torch.clamp(F - w, min=1), generator, (B, 1))
        keep_f &= ~((f_idx >= start) & (f_idx < start + w))
    max_t = torch.clamp((frame_lens * cfg.time_mask_ratio).long(), min=1)
    max_t = torch.clamp(max_t, max=cfg.time_mask_param)[:, None]
    keep_t = torch.ones((B, T), dtype=torch.bool, device=dev)
    for _ in range(cfg.n_time_masks):
        w = _uniform_int(torch.full((B, 1), cfg.time_mask_param + 1,
                                    device=dev), generator, (B, 1))
        w = torch.minimum(w, max_t)
        start = _uniform_int(torch.clamp(lens - w, min=1), generator, (B, 1))
        keep_t &= ~((t_idx >= start) & (t_idx < start + w))
    return (keep_t[:, :, None] & keep_f[:, None, :]).to(dtype)


def spec_augment(feats: torch.Tensor, frame_lens: torch.Tensor,
                 cfg: FrontendConfig, generator: torch.Generator | None = None,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """feats (B, T, F) times a SpecAugment mask: `mask` when given (e.g.
    the reference's, for a test), else one drawn from `generator`."""
    B, T, F = feats.shape
    if mask is None:
        mask = spec_augment_mask(frame_lens, T, F, cfg, generator, feats.dtype)
    return feats * mask.to(feats.dtype)
