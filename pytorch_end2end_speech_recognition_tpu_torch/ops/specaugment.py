"""SpecAugment: time warp, frequency and time masking (the port of the JAX
package's `ops/specaugment.py`), on the features' device.

Policy (Park et al. 2019, as the reference draws it): time warp (when
`time_warp_param` W > 0) moves an anchor in [W, len - W) by w ~ U[-W, W]
and stretches both segments linearly; `n_freq_masks` bands of
width w ~ U[0, F_param] starting in [0, max(F - w, 1)); `n_time_masks` spans
of width min(U[0, T_param], max_t), max_t = min(T_param, max(int(len *
ratio), 1)), starting in [0, max(len - w, 1)) so they stay inside the
row's frames. The draws come from an explicit `torch.Generator` (the JAX
package's keys give other numbers), the warp's before the masks'; a caller
may pass the warp's two draws and the mask instead, which is how the tests
hold the port to the reference.
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


def time_warp(feats: torch.Tensor, frame_lens: torch.Tensor, W: int,
              generator: torch.Generator | None = None,
              draws: tuple[torch.Tensor, torch.Tensor] | None = None
              ) -> torch.Tensor:
    """SpecAugment time warp of feats (B, T, F): the anchor `center` (B, 1)
    in [W, len - W) moves to center + w, w (B, 1) in [-W, W], and both
    segments stretch linearly, read by linear interpolation between frames.
    Rows shorter than 2W + 2 frames pass unchanged, and so do padded
    frames. `draws` = (center, w) replaces the two draws from
    `generator`, center = W + (r mod max(len - 2W, 1)) with r ~ U[0, T)."""
    B, T, F = feats.shape
    dev = feats.device
    lens_i = frame_lens.to(dev).long()[:, None]
    if draws is None:
        if generator is None:
            raise ValueError("time warp needs a generator or its draws")
        r = torch.randint(0, T, (B, 1), generator=generator, device=dev)
        w = torch.randint(-W, W + 1, (B, 1), generator=generator, device=dev)
        draws = (W + r % torch.clamp(lens_i - 2 * W, min=1), w)
    center, w = (d.to(dev, torch.float32).reshape(B, 1) for d in draws)
    lens = lens_i.float()
    ok = lens_i >= 2 * W + 2
    warped = center + w                                      # in [1, len-W]
    t = torch.arange(T, device=dev, dtype=torch.float32)[None, :]
    one = torch.ones((), device=dev)
    left = t * center / torch.maximum(warped, one)
    right = center + (t - warped) * (lens - 1 - center) / torch.maximum(
        lens - 1 - warped, one)
    src = torch.where(t < warped, left, right)
    src = torch.minimum(torch.maximum(src, torch.zeros((), device=dev)),
                        lens - 1)
    src = torch.where(ok & (t < lens), src, t)               # identity o.w.
    lo = torch.floor(src).long()
    hi = torch.clamp(lo + 1, max=T - 1)
    frac = (src - lo.float())[:, :, None].to(feats.dtype)
    g_lo = torch.gather(feats, 1, lo[:, :, None].expand(B, T, F))
    g_hi = torch.gather(feats, 1, hi[:, :, None].expand(B, T, F))
    return g_lo * (1.0 - frac) + g_hi * frac


def spec_augment_mask(frame_lens: torch.Tensor, T: int, F: int,
                      cfg: FrontendConfig, generator: torch.Generator | None,
                      dtype=torch.float32) -> torch.Tensor:
    """A (B, T, F) mask of 0s (masked) and 1s drawn from `generator`."""
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
                 mask: torch.Tensor | None = None,
                 warp: tuple[torch.Tensor, torch.Tensor] | None = None
                 ) -> torch.Tensor:
    """feats (B, T, F), time-warped when time_warp_param > 0 (by the draws
    `warp` when given, else drawn from `generator`), times a SpecAugment
    mask: `mask` when given (e.g. the reference's, for a test), else one
    drawn from `generator`."""
    if cfg.time_warp_param > 0:
        feats = time_warp(feats, frame_lens, cfg.time_warp_param, generator,
                          warp)
    B, T, F = feats.shape
    if mask is None:
        mask = spec_augment_mask(frame_lens, T, F, cfg, generator, feats.dtype)
    return feats * mask.to(feats.dtype)
