"""Pipeline parallelism: a GPipe pipeline of the encoder's blocks over the
'model' group (the port of the JAX package's `parallel/pp.py`).

The N identical blocks split into S stages of N/S consecutive blocks, one
stage a rank of the group (its index is the rank's place in the group).
The batch splits into M microbatches. At each of M + S - 1 steps every
stage applies its blocks to the activation in flight and passes the result
to the next stage (`ring_shift`, the JAX `ppermute` i -> i + 1); stage 0
injects microbatch t, stage S - 1 collects microbatch t - S + 1. As in the
JAX package every stage computes at every step, the bubble steps on
whatever it holds, and the result is broadcast from the last stage by a
masked sum over the group. Everything is differentiable, so the same code
trains:

- the input (and the blocks' relative biases) enter through one `copy_to`,
  so that each one's gradient, which only the stages that read it hold,
  is summed over the group;
- the broadcast's backward is the identity (`reduce_from`): every rank
  computes the same loss from the replicated result, and the last stage
  takes its gradient once, not S times;
- a stage's own blocks get their gradients on its rank alone. The caller
  sums them over the group before the optimizer (`sum_stage_grads`, which
  the Solver calls), so the replicated block parameters stay alike.

There is no `stack_block_params`: the JAX package stacks the blocks' states
on a leading stage axis so that `shard_map` can hand each device its
stage's slice. A torch rank is its stage, and runs its slice of
`enc.blocks` straight from the module list.

`pipeline_blocks` copies two traits of the JAX path: the blocks draw no
dropout (the JAX blocks get no key, even in training), and the relative
bias travels dense, one (H, T, T) block a layer.
"""

from __future__ import annotations

import torch

from pytorch_end2end_speech_recognition_tpu_torch.parallel.collectives import (
    all_reduce_,
    copy_to,
    group_rank,
    reduce_from,
    ring_shift,
    size,
)


def _enter(group, *ts: torch.Tensor) -> list[torch.Tensor]:
    """`ts` through one `copy_to` (one all-reduce of their gradients in the
    backward, in the same place on every rank)."""
    if group is None:
        return list(ts)
    flat = copy_to(torch.cat([t.reshape(-1) for t in ts]), group)
    return [f.view_as(t) for f, t in
            zip(flat.split([t.numel() for t in ts]), ts)]


def _run(group, fn, params, x: torch.Tensor, n_micro: int) -> torch.Tensor:
    S, sid = size(group), group_rank(group)
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} does not split into {n_micro} "
                         "microbatches")
    M = n_micro
    xm = x.reshape((M, B // M) + tuple(x.shape[1:]))
    first = torch.tensor(sid == 0, device=x.device)
    last = torch.tensor(sid == S - 1, device=x.device)
    cur = torch.zeros_like(xm[0])
    outs = []
    for t in range(M + S - 1):
        # every stage reads both, so that every rank runs the same shifts'
        # backwards (a received activation no rank used would leave its
        # sender's gradient waiting)
        y = fn(params, torch.where(first, xm[min(t, M - 1)], cur))
        if t >= S - 1:
            outs.append(y)  # microbatch t - S + 1, on the last stage
        if t < M + S - 2:
            cur = ring_shift(y, group)
    out = torch.where(last, torch.stack(outs), 0.0)
    return reduce_from(out, group).reshape(x.shape)


def pipeline_apply(group, fn, stage_params, x: torch.Tensor,
                   n_micro: int) -> torch.Tensor:
    """Run `fn(stage_params[s], x_micro) -> y_micro` (y of x_micro's
    shape) as an S-stage pipeline over `group` (S its size). x: (B, ...)
    alike on every rank, B divisible by n_micro. Returns the whole result
    on every rank. `stage_params` is indexed by stage: this rank uses its
    own entry alone (see the module's docstring for the gradients)."""
    x, = _enter(group, x)
    return _run(group, fn, stage_params[group_rank(group)], x, n_micro)


def pipeline_blocks(group, blocks, x: torch.Tensor, mask: torch.Tensor,
                    n_micro: int, biases: torch.Tensor | None = None):
    """The blocks (`TransformerBlock` or `ConformerBlock`, each called as
    blk(x, mask, bias, ...)) as a pipeline over `group`: len(blocks)
    divisible by its size S, stage s applying blocks [s N/S, (s+1) N/S).
    x: (B, T, D); mask: (B, T), microbatched with x as an extra feature
    plane; biases: (N, H, T, T) dense relative biases, one a layer, or
    None."""
    S, sid = size(group), group_rank(group)
    N = len(blocks)
    if N % S:
        raise ValueError(f"{N} blocks do not divide into {S} stages")
    per = N // S
    x_aug = torch.cat([x, mask.to(x.dtype)[..., None]], dim=-1)
    if biases is None:
        x_aug, = _enter(group, x_aug)
        mine = [None] * per
    else:
        x_aug, biases = _enter(group, x_aug, biases)
        mine = biases[sid * per:(sid + 1) * per].unbind(0)
    stage = list(zip(blocks[sid * per:(sid + 1) * per], mine))

    def fn(layers, xi):
        h, m = xi[..., :-1], xi[..., -1] > 0.5
        for blk, bias in layers:
            h = blk(h, m, bias, None, False, None)  # no dropout draws
        return torch.cat([h, xi[..., -1:]], dim=-1)

    return _run(group, fn, stage, x_aug, n_micro)[..., :-1]


def sum_stage_grads(grads: list, params: list, owned: list[bool],
                    group) -> list:
    """The gradients of the pipelined blocks' parameters (`owned`) summed
    over `group` by one all-reduce (each stage holds its own blocks'; the
    other ranks have None or zeros); the rest as they are."""
    if group is None or not any(owned):
        return grads
    idx = [i for i, o in enumerate(owned) if o]
    full = [torch.zeros_like(params[i]) if grads[i] is None else grads[i]
            for i in idx]
    flat = all_reduce_(torch.cat([g.reshape(-1) for g in full]), group)
    grads = list(grads)
    for i, f, g in zip(idx, flat.split([g.numel() for g in full]), full):
        grads[i] = f.view_as(g)
    return grads
