"""Length masks, shared by the models and the kernels' plain versions."""

from __future__ import annotations

import torch


def length_mask(lens: torch.Tensor, T: int) -> torch.Tensor:
    """(B, T) bool: position t of row b is below lens[b]."""
    return torch.arange(T, device=lens.device)[None, :] < lens[:, None]


def masked(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero x where mask (broadcast from the left over x's leading dims)."""
    return torch.where(mask, x, torch.zeros((), dtype=x.dtype, device=x.device))
