"""LR schedules, global-norm clipping and the optimizers (the port of the
JAX package's `training/schedules.py`), with optax's semantics rather than
`torch.optim`'s:

- the schedule is evaluated at optax's count, 0 on the first update;
- `clip_by_global_norm` scales by max_norm / norm when norm >= max_norm,
  with no epsilon (`clip_grad_norm_` adds 1e-6);
- adamw: b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias
  correction by the update count, decoupled weight decay applied to every
  parameter (biases and LayerNorm scales included), then times -lr;
- adadelta: `scale_by_adadelta(rho=0.9, eps=1e-6)`, then times -lr;
- `train.grad_accum_steps` k > 1 is `optax.MultiSteps(every_k_schedule=k)`
  with its default `use_grad_mean`: the micro-batches' gradients are kept
  as a running mean, acc + (g - acc) / (n + 1), and the clip and the inner
  optimizer run on that mean every k-th micro-step only (optax computes the
  inner update on every micro-step and discards it; the numbers are the
  same). Its count advances only then, and the parameters do not move in
  between.
Updates are in place on the parameters, with `torch._foreach_*` ops.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from pytorch_end2end_speech_recognition_tpu_torch.parallel.collectives import (
    all_reduce_,
)
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


def global_norm(grads: list[torch.Tensor], sharded: torch.Tensor | None = None,
                group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, a 0-dim float32. Under
    tensor parallelism (`group`, the 'model' group), the gradients marked
    in `sharded` (bool, one a gradient) are this rank's slices: their
    squares are summed over the group, and a replicated one counts once."""
    norms = torch._foreach_norm(grads)
    if group is None:
        return torch.linalg.vector_norm(torch.stack(norms))
    sq = torch.stack(norms).float() ** 2
    mask = sharded.to(sq.device)
    part = all_reduce_(torch.where(mask, sq, 0.0).sum(), group)
    return torch.sqrt(part + torch.where(mask, 0.0, sq).sum())


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float,
                        norm: torch.Tensor) -> list[torch.Tensor]:
    """optax's clip: g unchanged when norm < max_norm, else (g / norm) *
    max_norm. Decided on the device (no host sync)."""
    under = norm < max_norm
    den = torch.where(under, torch.ones_like(norm), norm)
    num = torch.where(under, torch.ones_like(norm),
                      torch.full_like(norm, max_norm))
    return torch._foreach_mul(torch._foreach_div(grads, den), num)


class Optimizer:
    """clip_by_global_norm -> adam, adamw (weight_decay > 0) or adadelta ->
    the schedule, optionally inside MultiSteps(k), over a fixed list of
    float32 parameters."""

    B1, B2, EPS = 0.9, 0.999, 1e-8          # adam
    RHO, EPS_ADADELTA = 0.9, 1e-6           # adadelta

    def __init__(self, params: list[torch.Tensor],
                 schedule: Callable[[int], float], kind: str,
                 weight_decay: float, max_norm: float, accum_steps: int = 1):
        if kind not in ("adam", "adadelta"):
            raise ValueError(f"unknown optimizer {kind}")
        self.params = list(params)
        self.schedule = schedule
        self.kind = kind
        self.weight_decay = weight_decay
        self.max_norm = max_norm
        self.accum_steps = accum_steps
        zeros = lambda: [torch.zeros_like(p) for p in self.params]  # noqa: E731
        # adam: the first and second moments; adadelta: E[g^2] and E[u^2]
        self.m1, self.m2 = zeros(), zeros()
        self.count = 0
        self.acc = zeros() if accum_steps > 1 else None
        self.mini_step = 0
        # (sharded mask, 'model' group) under tensor parallelism
        self.shards: tuple = (None, None)

    def state_dict(self) -> dict:
        """The state as tensors and ints (no reference to the parameters)."""
        return {"count": self.count, "m1": list(self.m1), "m2": list(self.m2),
                "acc": list(self.acc or []), "mini_step": self.mini_step}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        if len(state["m1"]) != len(self.params) or (
                len(state["acc"]) != len(self.acc or [])):
            raise ValueError("optimizer state does not match the parameters "
                             "or train.grad_accum_steps")
        for dst, src in zip(self.m1 + self.m2 + (self.acc or []),
                            state["m1"] + state["m2"] + state["acc"]):
            dst.copy_(src)
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])

    def _adam(self, grads):
        b1, b2 = self.B1, self.B2
        # mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(self.m1, b1)
        torch._foreach_add_(self.m1, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(self.m2, b2)
        torch._foreach_add_(self.m2, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1.0 - b2))
        count = self.count + 1
        mu_hat = torch._foreach_div(self.m1, 1.0 - b1 ** count)
        nu_hat = torch._foreach_div(self.m2, 1.0 - b2 ** count)
        den = torch._foreach_add(torch._foreach_sqrt(nu_hat), self.EPS)
        upd = torch._foreach_div(mu_hat, den)
        if self.weight_decay:
            torch._foreach_add_(upd, torch._foreach_mul(self.params,
                                                        self.weight_decay))
        return upd

    def _adadelta(self, grads):
        rho, eps = self.RHO, self.EPS_ADADELTA
        # e_g = (1 - rho) g^2 + rho e_g; u = sqrt(e_x + eps) / sqrt(e_g + eps)
        # g; e_x = (1 - rho) u^2 + rho e_x (e_x before this update in u)
        torch._foreach_mul_(self.m1, rho)
        torch._foreach_add_(self.m1, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1.0 - rho))
        upd = torch._foreach_mul(torch._foreach_div(
            torch._foreach_sqrt(torch._foreach_add(self.m2, eps)),
            torch._foreach_sqrt(torch._foreach_add(self.m1, eps))), grads)
        torch._foreach_mul_(self.m2, rho)
        torch._foreach_add_(self.m2, torch._foreach_mul(
            torch._foreach_mul(upd, upd), 1.0 - rho))
        return upd

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor], lr_scale: float = 1.0
             ) -> torch.Tensor:
        """One micro-step from `grads` (one per parameter, None for zero);
        returns the global norm of these gradients before the clip. The
        parameters move by lr_scale times the update (the Solver's plateau
        factor) when no accumulation is pending."""
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        norm = global_norm(grads, *self.shards)
        inner_norm = norm
        if self.acc is not None:
            n = self.mini_step
            torch._foreach_add_(self.acc, torch._foreach_div(
                torch._foreach_sub(grads, self.acc), float(n + 1)))
            self.mini_step = (n + 1) % self.accum_steps
            if self.mini_step:
                return norm
            grads = self.acc
            inner_norm = global_norm(grads, *self.shards)
        grads = clip_by_global_norm(grads, self.max_norm, inner_norm)
        upd = self._adam(grads) if self.kind == "adam" else self._adadelta(
            grads)
        step = -self.schedule(self.count) * lr_scale
        torch._foreach_add_(self.params, torch._foreach_mul(upd, step))
        self.count += 1
        if self.acc is not None:
            torch._foreach_zero_(self.acc)
        return norm


def make_optimizer(cfg: TrainConfig, params: list[torch.Tensor]
                   ) -> Optimizer:
    if cfg.optimizer not in ("adamw", "adam", "adadelta"):
        raise ValueError(f"unknown optimizer {cfg.optimizer}")
    kind = "adadelta" if cfg.optimizer == "adadelta" else "adam"
    wd = cfg.weight_decay if cfg.optimizer == "adamw" else 0.0
    return Optimizer(params, make_schedule(cfg), kind, wd, cfg.grad_clip,
                     cfg.grad_accum_steps)
