"""The process mesh over a ``torch.distributed`` group (port of
``pygat_tpu/parallel/mesh.py``).

Axes, as in the JAX package:

* ``data``: the graph-partition / batch axis. The transductive ring
  partitions the nodes and edges of the whole graph over it, the inductive
  loop deals PPI batches over it;
* ``model``: the head axis. Every ``[H, ...]`` parameter whose H divides
  by ``n_model`` is split over it (:mod:`~pygat_tpu_torch.parallel.
  sharding`), each rank holding, updating and computing its own heads.

Where the JAX package arranges the chips of one program into a device
grid, the port runs one process per rank, each on its own device
(``cuda:LOCAL_RANK``, or the CPU when asked), joined by a process group:
NCCL on CUDA, gloo on the CPU. :func:`initialize_distributed` brings the
group up from a launcher's environment (``torchrun``); :func:`make_mesh`
describes it and makes its subgroups.

The layout is the JAX ``make_mesh``'s ``reshape(n_data, n_model)``: global
rank ``r`` sits at data index ``r // n_model`` and model index ``r %
n_model``, so a model group is ``n_model`` consecutive ranks (one host's
NVLink peers under ``torchrun``), and a data group is the ranks of one
model index.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
# what a group waits for a peer before it raises, unless the caller says
GROUP_TIMEOUT = datetime.timedelta(seconds=600)
_LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


class Mesh(NamedTuple):
    """This rank's view of a ``(data, model)`` process mesh: the group's
    size, this process's rank and its device, and its two subgroups:
    ``data_group``, the ranks of its model index (None: the whole world,
    as at ``n_model == 1``), and ``model_group``, the ranks of its data
    index (None at ``n_model == 1``: no model collective runs)."""

    n_data: int
    n_model: int
    rank: int
    world_size: int
    device: torch.device
    data_group: Any = None
    model_group: Any = None

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def is_main(self) -> bool:
        """Whether this rank writes what one process writes (checkpoints,
        logs)."""
        return self.rank == 0


def local_device(cpu: bool = False) -> torch.device:
    """The device of this process: the CPU when asked, else
    ``cuda:LOCAL_RANK`` (``cuda:0`` without a launcher)."""
    if cpu:
        return torch.device("cpu")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def initialize_distributed(*, cpu: bool = False,
                           timeout: datetime.timedelta = GROUP_TIMEOUT
                           ) -> bool:
    """Bring up the default process group from the launcher's environment
    (torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``): NCCL on CUDA (after setting this process's device to
    ``cuda:LOCAL_RANK``), gloo with ``cpu``, each peer waited for at most
    ``timeout``.

    Returns True when a group is (now) up, also one the caller brought up
    before; False for a plain single-process run with no launcher
    environment, as the JAX package's returns False with no coordinator.
    A partial environment and any failure of the rendezvous raise."""
    if dist.is_initialized():
        return True
    present = [v for v in _LAUNCHER_VARS if os.environ.get(v)]
    if not present:
        return False
    if len(present) != len(_LAUNCHER_VARS):
        missing = sorted(set(_LAUNCHER_VARS) - set(present))
        raise RuntimeError(f"the launcher environment lacks {missing}")
    if cpu:
        backend = "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --no-cuda to "
                               "run the group on the CPU (gloo)")
        torch.cuda.set_device(local_device())
        backend = "nccl"
    dist.init_process_group(backend, init_method="env://", timeout=timeout,
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return True


def make_mesh(n_data: int, n_model: int = 1, *,
              device: torch.device | str | None = None) -> Mesh:
    """The mesh of the default process group, which must be up and hold
    ``n_data * n_model`` ranks (raises otherwise). ``device``: this rank's
    device (default ``cuda:LOCAL_RANK``).

    With ``n_model > 1`` every rank creates every data group and every
    model group, in one order (``dist.new_group`` is collective: a rank
    that skipped one would hang the others), and makes one all-reduce on
    each of its own two, so that NCCL builds their communicators here and
    not at a first call inside a CUDA-graph capture. The groups of a
    ``(n_data, n_model)`` shape are made once per default group and shared
    by later calls."""
    if n_data < 1 or n_model < 1:
        raise ValueError(f"a {n_data}x{n_model} mesh needs n_data and "
                         "n_model of at least 1")
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {n_data}x{n_model} mesh needs a process group of "
            f"{n_data * n_model} ranks: launch with torchrun "
            "--nproc-per-node D*M (or call initialize_distributed)")
    world = dist.get_world_size()
    if world != n_data * n_model:
        raise RuntimeError(f"a {n_data}x{n_model} mesh needs "
                           f"{n_data * n_model} ranks, the group has {world}")
    dev = torch.device(device) if device is not None else local_device()
    rank = dist.get_rank()
    data_group = model_group = None
    if n_model > 1:
        data_group, model_group = _subgroups(n_data, n_model, rank, dev)
    return Mesh(n_data=n_data, n_model=n_model, rank=rank, world_size=world,
                device=dev, data_group=data_group, model_group=model_group)


# (default group, n_data, n_model) -> this rank's (data group, model group)
_GROUPS: dict = {}


def _subgroups(n_data: int, n_model: int, rank: int, dev: torch.device):
    key = (dist.group.WORLD, n_data, n_model)
    if key not in _GROUPS:
        for k in list(_GROUPS):  # groups of a destroyed default group
            if k[0] is not dist.group.WORLD:
                del _GROUPS[k]
        mine = [None, None]
        for m in range(n_model):
            g = dist.new_group([d * n_model + m for d in range(n_data)])
            if m == rank % n_model:
                mine[0] = g
        for d in range(n_data):
            g = dist.new_group([d * n_model + m for m in range(n_model)])
            if d == rank // n_model:
                mine[1] = g
        one = torch.ones(1, device=dev)
        for g in mine:
            dist.all_reduce(one, group=g)
        _GROUPS[key] = tuple(mine)
    return _GROUPS[key]
