"""Numerical and distributed sanity guards (the port of the JAX package's
`utils/debugging.py`).

- `finite_check` / `assert_all_finite`: NaN/Inf guards over a dict (or
  nested dicts and lists) of tensors, on the host.
- `debug_assert_finite`: where the JAX package's version is an in-jit
  callback, the port's is a host check, made where it is called (at a step
  boundary, say): it reads the tensor's finiteness back from the device,
  so it syncs, and prints instead of raising, as the JAX callback does.
- `sharding_fingerprint` + `check_collective_consistency`: a hash of every
  leaf's path, shape, dtype and shard spec, all-gathered across ranks once
  the train state is sharded: a rank whose layout differs (another config,
  other rules) fails on every rank before a collective can hang on it.
"""

from __future__ import annotations

import hashlib

import torch

from pytorch_end2end_speech_recognition_tpu_torch.parallel.collectives import (
    all_gather_host,
)


def _leaves(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


def finite_check(tree) -> dict[str, bool]:
    """Host-side: map of leaf path -> all finite (True for non-float
    leaves)."""
    return {k: bool(torch.isfinite(v).all())
            if isinstance(v, torch.Tensor) and v.is_floating_point() else True
            for k, v in _leaves(tree)}


def assert_all_finite(tree, what: str = "tree") -> None:
    bad = [k for k, ok in finite_check(tree).items() if not ok]
    if bad:
        raise FloatingPointError(
            f"non-finite values in {what}: {bad[:10]}"
            + ("..." if len(bad) > 10 else ""))


def debug_assert_finite(x: torch.Tensor, name: str = "x") -> torch.Tensor:
    """Print a line when x holds non-finite values (a host check; see the
    module's docstring); returns x."""
    if not bool(torch.isfinite(x).all()):
        print(f"[nan-guard] non-finite values in {name}: "
              f"min={x.min().item()} max={x.max().item()}")
    return x


def sharding_fingerprint(tree, specs: dict | None = None) -> str:
    """Stable hash of (path, shape, dtype, shard spec) of every leaf;
    `specs` maps a leaf's path to its spec (replicated when absent)."""
    specs = specs or {}
    h = hashlib.sha256()
    for key, leaf in _leaves(tree):
        h.update(key.encode())
        h.update(str(tuple(getattr(leaf, "shape", ()))).encode())
        h.update(str(getattr(leaf, "dtype", None)).encode())
        h.update(repr(specs.get(key, ())).encode())
    return h.hexdigest()


def check_collective_consistency(tree, tag: str = "train_state",
                                 specs: dict | None = None,
                                 group=None) -> None:
    """All-gather the fingerprint over `group` (every rank of the process
    group when None and one exists) and raise on every rank on a mismatch.
    A no-op on one rank. Call once after sharding the train state."""
    import torch.distributed as dist

    if group is None:
        if not dist.is_initialized() or dist.get_world_size() == 1:
            return
        group = dist.group.WORLD
    fp = sharding_fingerprint(tree, specs)
    bits = torch.tensor([int(fp[:15], 16)], dtype=torch.int64)
    got = torch.cat(all_gather_host(bits, group))
    if not bool((got == got[0]).all()):
        raise RuntimeError(
            f"collective-consistency check failed for '{tag}': sharding "
            f"fingerprints differ across ranks ({got.tolist()})")
