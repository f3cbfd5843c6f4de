"""Meshes: a named grid of ranks.

The reference builds ``jax.make_mesh`` meshes.  Here a :class:`Mesh` is the
grid's shape and axis names, with the ``torch.distributed`` ``DeviceMesh``
over the ranks of the running process group when one is up (else ``None``:
an abstract mesh, on which the rules resolve but nothing is placed, or the
one device of a process that was not launched as a rank).  Rank ``r`` sits
at the row-major coordinate ``r`` of the grid, as device ``r`` does in the
reference's meshes.  Functions, not module-level constants: importing this
module starts no process group.

``start_ranks`` starts the group of a job launched as ranks, from the
variables a launcher sets (``torchrun``, or ``srun`` with them exported):
one process per GPU over NCCL, or gloo ranks on the CPU.  Without them it
starts nothing, and ``make_host_mesh`` is (1, 1).
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
import socket
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


RANK_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class Ranks:
    """This process's place in a group started by ``start_ranks``."""

    rank: int
    world: int
    local_rank: int
    backend: str
    device: torch.device


def start_ranks(device="cuda", timeout_s: float = 600.0) -> Optional[Ranks]:
    """Join the process group that the launcher's environment describes
    (``RANK_VARS``; ``init_method="env://"``) with a collective timeout of
    ``timeout_s``: NCCL on ``cuda:LOCAL_RANK`` for a CUDA ``device``, gloo
    on the CPU.  With none of the variables set it starts nothing and
    returns ``None``.  A CUDA rank needs a GPU of its own: ``LOCAL_RANK``
    past the visible GPUs, no GPU at all, or two ranks of one host on one
    GPU (NCCL puts no two ranks of a communicator on one device) fail with a
    message; a rank never falls back to the CPU."""
    env = {k: os.environ.get(k) for k in RANK_VARS}
    if all(v is None for v in env.values()):
        return None
    missing = [k for k, v in env.items() if v is None]
    if missing:
        raise RuntimeError(f"a rank needs all of {', '.join(RANK_VARS)}; "
                           f"{', '.join(missing)} not set")
    rank, world, local = int(env["RANK"]), int(env["WORLD_SIZE"]), int(env["LOCAL_RANK"])
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: no CUDA device found; pass --device cpu "
                               "for gloo ranks on the CPU")
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank}: LOCAL_RANK {local} has no GPU of its own "
                f"({torch.cuda.device_count()} visible): start one rank per GPU")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    if backend == "nccl":
        _refuse_shared_gpus(rank, world, dev)
    return Ranks(rank, world, local, backend, dev)


def _refuse_shared_gpus(rank: int, world: int, dev: torch.device) -> None:
    """Through the group's store (no NCCL call): fail where two ranks of one
    host hold one GPU."""
    store = dist.distributed_c10d._get_default_store()
    gpu = getattr(torch.cuda.get_device_properties(dev), "uuid", None) or dev.index
    mine = f"{socket.gethostname()}/{gpu}"
    store.set(f"repro_gpu/{rank}", mine)
    holders = [store.get(f"repro_gpu/{r}").decode() for r in range(world)]
    shared = [r for r, h in enumerate(holders) if h == mine and r != rank]
    if shared:
        dist.destroy_process_group()
        raise RuntimeError(f"rank {rank} shares {dev} with ranks {shared}: NCCL puts no two "
                           "ranks on one GPU; start one rank per GPU")


def stop_ranks() -> None:
    """Leave the process group, where one is up."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _names(shape: Sequence[int]) -> tuple:
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


class Mesh:
    """``shape`` and ``axis_names`` of a grid of ranks, its ``DeviceMesh``
    (or ``None``) and the device this rank computes on."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device_mesh=None, device="cpu"):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axis_names)} "
                             "differ in rank")
        self.shape = tuple(int(n) for n in shape)
        self.axis_names = tuple(axis_names)
        self.device_mesh = device_mesh
        self.device = torch.device(device)
        self._groups: dict = {}

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def coordinate(self) -> tuple:
        """This rank's coordinate on the grid; all zeros on a mesh of one."""
        if self.device_mesh is not None:
            return tuple(self.device_mesh.get_coordinate())
        if self.size != 1:
            raise ValueError(f"the abstract mesh {self} has no rank of this process")
        return (0,) * len(self.shape)

    def coordinate_of(self, rank: int) -> tuple:
        """The coordinate on the grid of the group's ``rank``."""
        if self.device_mesh is None:
            return self.coordinate
        where = np.argwhere(self.device_mesh.mesh.cpu().numpy() == rank)
        return tuple(int(i) for i in where[0])

    def group(self, axes: Sequence[str]):
        """The process group of the ranks that differ from this one only along
        ``axes`` (their grid order is the group's rank order), or ``None``
        when those axes hold a single rank."""
        sizes = dict(zip(self.axis_names, self.shape))
        axes = tuple(a for a in axes if sizes.get(a, 1) > 1)   # an axis of one rank adds none
        if not axes:
            return None
        if self.device_mesh is None:
            raise ValueError(f"the abstract mesh {self} has no process groups")
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        if axes not in self._groups:
            # every rank enumerates every group of the partition, in one order
            ranks = self.device_mesh.mesh.cpu().numpy()
            dims = [self.axis_names.index(a) for a in axes]
            rest = [d for d in range(len(self.shape)) if d not in dims]
            rows = np.transpose(ranks, rest + dims).reshape(-1, math.prod(sizes[a] for a in axes))
            self._groups[axes], _ = dist.new_subgroups_by_enumeration(
                [r.tolist() for r in rows])
        return self._groups[axes]

    def __repr__(self) -> str:
        kind = "abstract" if self.device_mesh is None else str(self.device)
        return f"Mesh({dict(zip(self.axis_names, self.shape))}, {kind})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh, (16, 16) or (2, 16, 16), with no
    devices: the rules resolve on it, nothing is placed."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    return Mesh(shape, _names(shape))


def make_mesh(shape: Sequence[int], device="cpu") -> Mesh:
    """A mesh of ``shape`` over every rank of the running process group (its
    size must be the world's), or of one rank where no group is up; its axes
    ("data", "model"), or ("pod", "data", "model") for three dimensions."""
    names = _names(shape)
    size = math.prod(shape)
    if not (dist.is_available() and dist.is_initialized()):
        if size != 1:
            raise ValueError(f"a mesh of {size} ranks needs a process group")
        return Mesh(shape, names, None, device)
    world = dist.get_world_size()
    if size != world:
        raise ValueError(f"mesh {tuple(shape)} does not cover the {world} ranks")
    from torch.distributed.device_mesh import DeviceMesh

    device = torch.device(device)
    dm = DeviceMesh(device.type, torch.arange(world).reshape(tuple(shape)),
                    mesh_dim_names=names)
    return Mesh(shape, names, dm, device)


def make_host_mesh(device="cpu") -> Mesh:
    """The ranks of the running process group as a (world, 1) ("data",
    "model") mesh; with no group up, (1, 1) on ``device``, and no group is
    started."""
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    return make_mesh((world, 1), device)
