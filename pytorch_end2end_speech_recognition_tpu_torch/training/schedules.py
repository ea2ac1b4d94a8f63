"""LR schedules, global-norm clipping and the optimizers (the port of the
JAX package's `training/schedules.py`), with optax's semantics rather than
`torch.optim`'s:

- the schedule is evaluated at optax's count, 0 on the first update;
- `clip_by_global_norm` scales by max_norm / norm when norm >= max_norm,
  with no epsilon (`clip_grad_norm_` adds 1e-6);
- adamw: b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias
  correction by the update count, decoupled weight decay applied to every
  parameter (biases and LayerNorm scales included), then times -lr.
Updates are in place on the parameters, with `torch._foreach_*` ops.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from pytorch_end2end_speech_recognition_tpu_torch.utils.config import TrainConfig


def make_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """lr as a function of optax's update count (0, 1, ...)."""
    lr, warmup = cfg.lr, cfg.warmup_steps
    if cfg.schedule == "noam":
        # lr * warmup^0.5 * min(s^-0.5, s * warmup^-1.5), s = count + 1
        def noam(count: int) -> float:
            s = float(count + 1)
            return lr * warmup ** 0.5 * min(s ** -0.5, s * warmup ** -1.5)
        return noam
    if cfg.schedule == "cosine":
        # optax.warmup_cosine_decay_schedule(0, lr, warmup, cfg.steps)
        decay = cfg.steps - warmup

        def cosine(count: int) -> float:
            if count < warmup:
                return lr * count / warmup
            c = min(count - warmup, decay)
            return lr * 0.5 * (1.0 + math.cos(math.pi * c / decay))
        return cosine
    if cfg.schedule in ("constant", "plateau"):
        # plateau decays through Solver.lr_scale, driven by evaluation
        return lambda count: lr
    raise ValueError(f"unknown schedule {cfg.schedule}")


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, a 0-dim float32."""
    norms = torch._foreach_norm(grads)
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float,
                        norm: torch.Tensor) -> list[torch.Tensor]:
    """optax's clip: g unchanged when norm < max_norm, else (g / norm) *
    max_norm. Decided on the device (no host sync)."""
    under = norm < max_norm
    den = torch.where(under, torch.ones_like(norm), norm)
    num = torch.where(under, torch.ones_like(norm),
                      torch.full_like(norm, max_norm))
    return torch._foreach_mul(torch._foreach_div(grads, den), num)


class Adam:
    """optax.adam / optax.adamw (weight_decay > 0) with optax's defaults,
    behind a global-norm clip, over a fixed list of float32 parameters."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params: list[torch.Tensor],
                 schedule: Callable[[int], float], weight_decay: float,
                 max_norm: float):
        self.params = list(params)
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.max_norm = max_norm
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor], lr_scale: float = 1.0
             ) -> torch.Tensor:
        """One update from `grads` (one per parameter, None for zero);
        returns the global norm of the gradients before the clip."""
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        norm = global_norm(grads)
        grads = clip_by_global_norm(grads, self.max_norm, norm)
        b1, b2 = self.B1, self.B2
        # mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1.0 - b2))
        count = self.count + 1
        mu_hat = torch._foreach_div(self.mu, 1.0 - b1 ** count)
        nu_hat = torch._foreach_div(self.nu, 1.0 - b2 ** count)
        den = torch._foreach_add(torch._foreach_sqrt(nu_hat), self.EPS)
        upd = torch._foreach_div(mu_hat, den)
        if self.weight_decay:
            torch._foreach_add_(upd, torch._foreach_mul(self.params,
                                                        self.weight_decay))
        step = -self.schedule(self.count) * lr_scale
        torch._foreach_add_(self.params, torch._foreach_mul(upd, step))
        self.count = count
        return norm


def make_optimizer(cfg: TrainConfig, params: list[torch.Tensor]) -> Adam:
    sched = make_schedule(cfg)
    if cfg.grad_accum_steps > 1:
        raise NotImplementedError("gradient accumulation is not ported yet "
                                  "(set train.grad_accum_steps=1)")
    if cfg.optimizer == "adamw":
        return Adam(params, sched, cfg.weight_decay, cfg.grad_clip)
    if cfg.optimizer == "adam":
        return Adam(params, sched, 0.0, cfg.grad_clip)
    if cfg.optimizer == "adadelta":
        raise NotImplementedError("adadelta is not ported yet")
    raise ValueError(f"unknown optimizer {cfg.optimizer}")
