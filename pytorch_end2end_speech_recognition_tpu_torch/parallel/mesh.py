"""The ('data', 'model') mesh over `torch.distributed` and multi-host
bring-up (the port of the JAX package's `parallel/mesh.py`).

One process is one rank. Rank r sits at (r // tp, r % tp) of a dp x tp
mesh, as the JAX package's `reshape(dp, tp)` of its devices: the ranks of
one 'model' group (one row) hold the shards of one replica and read the
same loader shard; the ranks of one 'data' group (one column) hold the
same shard of every replica and sum their gradients. The process group's
backend is the caller's choice (`initialize_multihost`), never picked
silently: 'cpu:gloo,cuda:nccl' by default on a machine with a card, 'gloo'
without one.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from pytorch_end2end_speech_recognition_tpu_torch.utils import device as dv

DATA_AXIS = "data"
MODEL_AXIS = "model"
TIMEOUT_S = 600  # a collective that waits longer fails instead of hanging


def default_backend() -> str:
    return "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         backend: str | None = None,
                         timeout_s: float = TIMEOUT_S) -> None:
    """`init_process_group` with an explicit timeout: `tcp://` at
    `coordinator_address` (host:port of process 0; a URL such as
    `file:///shared/rdzv` is used as it is) with `num_processes` and
    `process_id`, else `env://` (RANK, WORLD_SIZE, MASTER_ADDR and
    MASTER_PORT, as `torchrun` sets them). `backend` defaults to
    `default_backend()`."""
    init_method = "env://"
    if coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes "
                             "and process_id")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    dist.init_process_group(
        backend or default_backend(), init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
        timeout=datetime.timedelta(seconds=timeout_s))


def world() -> tuple[int, int]:
    """(rank, world size): (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def local_device(device=None) -> torch.device:
    """This rank's device: `device` when it names one ('cpu', 'cuda:0'),
    else the card `cuda:LOCAL_RANK` (LOCAL_RANK as `torchrun` sets it, else
    the rank), which must exist: several ranks share a card only when the
    caller names it."""
    dev = dv.resolve(device)
    if dev.type == "cuda" and dev.index is None:
        idx = int(os.environ.get("LOCAL_RANK", world()[0]))
        if idx >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {world()[0]} takes cuda:{idx} (LOCAL_RANK), but this "
                f"machine has {torch.cuda.device_count()} card(s); name the "
                "device (e.g. cuda:0) to share one")
        dev = torch.device("cuda", idx)
    return dev


@dataclass(eq=False)
class Mesh:
    """A dp x tp mesh of ranks: this rank's place, its device, and the
    process groups of its 'data' column and 'model' row (None where the
    axis has size 1: no collective runs over it)."""

    dp: int
    tp: int
    rank: int
    device: torch.device
    data_group: object = None
    model_group: object = None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.dp, MODEL_AXIS: self.tp}

    @property
    def data_rank(self) -> int:
        return self.rank // self.tp

    @property
    def model_rank(self) -> int:
        return self.rank % self.tp

    @property
    def world_group(self):
        """Every rank's group (None for one rank)."""
        return dist.group.WORLD if self.dp * self.tp > 1 else None

    @property
    def sharded(self) -> bool:
        """The JAX package's test for the fused FFN's gate: an axis > 1."""
        return self.dp > 1 or self.tp > 1


def make_mesh(dp: int | None = None, tp: int = 1, device=None) -> Mesh:
    """The ('data', 'model') mesh over every rank of the process group (one
    rank without one); dp defaults to world // tp. Every rank must call it,
    in the same order as its other collectives: it creates the groups."""
    rank, n = world()
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp={dp * tp} != world size {n}")
    rows = [[i * tp + j for j in range(tp)] for i in range(dp)]
    cols = [[i * tp + j for i in range(dp)] for j in range(tp)]
    model_group = data_group = None
    if tp > 1:
        model_group, _ = dist.new_subgroups_by_enumeration(rows)
    if dp > 1:
        data_group, _ = dist.new_subgroups_by_enumeration(cols)
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(dp, tp, rank, dev, data_group, model_group)


def require_mesh(mesh) -> None:
    """Refuse a mesh that is not this package's (a JAX one, say)."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError("mesh must be a parallel.mesh.Mesh (make_mesh), got "
                        f"{type(mesh).__name__}")


def host_shard_info(mesh: Mesh | None = None) -> tuple[int, int]:
    """(shard_index, num_shards) of this rank's loader: (data rank, dp) on
    a mesh, so that the ranks of one 'model' group read the same shard;
    without one, (rank, world size)."""
    if mesh is not None:
        return mesh.data_rank, mesh.dp
    return world()


def abort() -> None:
    """Tear this rank's process group down: at the end of a run, and after
    a failure, so that the peers' collectives fail instead of waiting out
    the timeout."""
    if dist.is_initialized():
        dist.destroy_process_group()
