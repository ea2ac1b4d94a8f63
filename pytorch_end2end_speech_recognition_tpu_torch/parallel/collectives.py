"""Collectives with gradients, for tensor and sequence parallelism, and the
host-side gathers of the checkpoint and the decoder.

Each differentiable collective is an autograd Function of its own, with the
backward that its use needs (Megatron-LM's pairs):

- `copy_to` (identity; the backward all-reduces) before a column-parallel
  linear, whose ranks each produce a part of the input's gradient;
- `reduce_from` (all-reduce; identity backward) after a row-parallel one;
- `sum_both` (all-reduce both ways) for statistics summed over shards and
  then used by every shard (the conv module's channel LayerNorm);
- `gather_time` (all-gather along time; reduce-scatter backward) and
  `reduce_scatter_time` (the converse): sequence parallelism's pair around
  the column- and row-parallel linears;
- `split_time` (this rank's time slice; all-gather backward) and
  `gather_time_replicated` (all-gather; the backward keeps this rank's
  slice) where the residual stream enters and leaves the time-sharded
  region from and to work that every rank does alike; `split_features`
  and `gather_features` are the same pair over the last dimension
  (context parallelism under tensor parallelism: the heads);
- `ring_shift` (send to the next rank of the group, receive from the
  previous one: the JAX package's `ppermute` i -> i+1; the backward
  shifts the gradient the other way) for ring attention and the
  pipeline, and `all_to_all` (tiled: split one dimension over the ranks,
  concatenate what arrives along another; the backward is the inverse
  exchange) for Ulysses attention.

`torch.distributed.nn.functional` is not used: its `all_reduce` also
all-reduces the gradient, which scales a loss that every rank computes
alike by the group's size. A group of None stands for an axis of size 1:
every function is then the identity and runs no collective.
"""

from __future__ import annotations

import pickle

import torch
import torch.distributed as dist


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over `group` (no gradient); returns t."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    parts = [p.contiguous() for p in x.chunk(size(group), dim=dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out


def _slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x.chunk(size(group), dim=dim)[group_rank(group)].contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, replicated):
        ctx.group, ctx.dim, ctx.replicated = group, dim, replicated
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.replicated:
            return _slice(g, ctx.group, ctx.dim), None, None, None
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None, None


class _ReduceScatterTime(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_scatter(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, 1), None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _slice(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send x to the rank `step` places on in the group, receive the one
    sent from `step` places back (one batched send/recv pair)."""
    n, r = size(group), group_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    peer = lambda i: dist.get_global_rank(group, i % n)  # noqa: E731
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, peer(r + step), group),
        dist.P2POp(dist.irecv, out, peer(r - step), group)])
    for req in reqs:
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def _exchange(x: torch.Tensor, group, split: int, cat: int) -> torch.Tensor:
    """Tiled all-to-all: x's `split` dimension in n parts, part j to rank
    j; the parts received, in rank order, concatenated along `cat`."""
    parts = [p.contiguous() for p in x.chunk(size(group), dim=split)]
    got = [torch.empty_like(parts[0]) for _ in parts]
    dist.all_to_all(got, parts, group=group)
    return torch.cat(got, dim=cat)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split, cat):
        ctx.group, ctx.split, ctx.cat = group, split, cat
        return _exchange(x, group, split, cat)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, ctx.cat, ctx.split), None, None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFrom.apply(x, group)


def sum_both(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _SumBoth.apply(x, group)


def gather_time(x: torch.Tensor, group) -> torch.Tensor:
    """(B, T/n, ...) -> (B, T, ...) before a column-parallel linear."""
    return x if group is None else _Gather.apply(x, group, 1, False)


def gather_time_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """(B, T/n, ...) -> (B, T, ...) where every rank goes on alike."""
    return x if group is None else _Gather.apply(x, group, 1, True)


def gather_features(x: torch.Tensor, group) -> torch.Tensor:
    """(..., F/n) -> (..., F) where every rank goes on alike."""
    return x if group is None else _Gather.apply(x, group, -1, True)


def reduce_scatter_time(x: torch.Tensor, group) -> torch.Tensor:
    """(B, T, ...) partial sums -> this rank's (B, T/n, ...) of their sum."""
    return x if group is None else _ReduceScatterTime.apply(x, group)


def split_time(x: torch.Tensor, group) -> torch.Tensor:
    """(B, T, ...) alike on every rank -> this rank's (B, T/n, ...)."""
    return x if group is None else _Split.apply(x, group, 1)


def split_features(x: torch.Tensor, group) -> torch.Tensor:
    """(..., F) alike on every rank -> this rank's (..., F/n)."""
    return x if group is None else _Split.apply(x, group, -1)


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """The previous rank's x (rank i's goes to i + 1, the last's to 0)."""
    return x if group is None else _RingShift.apply(x, group)


def all_to_all(x: torch.Tensor, group, split: int, cat: int) -> torch.Tensor:
    """Tiled all-to-all: `split` divided over the ranks, what arrives
    concatenated along `cat` (Ulysses: (B, T/n, H, D) -> (B, T, H/n, D)
    with split 2, cat 1)."""
    return x if group is None else _AllToAll.apply(x, group, split, cat)


# ---------------------------------------------------------------- host side
def all_gather_host(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's `t` (same shape and dtype on all), gathered as CPU
    tensors: the host copy keeps this working where the backend moves CUDA
    tensors only by all-reduce and broadcast (gloo)."""
    t = t.detach().cpu().contiguous()
    if group is None:
        return [t]
    parts = [torch.empty_like(t) for _ in range(size(group))]
    dist.all_gather(parts, t, group=group)
    return parts


def all_gather_objects(obj, group) -> list:
    """Every rank's picklable `obj`, in rank order, on every rank, through
    host tensors."""
    if group is None:
        return [obj]
    data = torch.frombuffer(bytearray(pickle.dumps(obj)), dtype=torch.uint8)
    lens = all_gather_host(torch.tensor([data.numel()]), group)
    n = int(max(int(x) for x in lens))
    buf = torch.zeros(n, dtype=torch.uint8)
    buf[:data.numel()] = data
    parts = all_gather_host(buf, group)
    return [pickle.loads(p[:int(k)].numpy().tobytes())
            for p, k in zip(parts, lens)]
