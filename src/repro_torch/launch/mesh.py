"""Meshes: a named grid of ranks.

The reference builds ``jax.make_mesh`` meshes.  Here a :class:`Mesh` is the
grid's shape and axis names, with the ``torch.distributed`` ``DeviceMesh``
over the ranks of the running process group when one is up (else ``None``:
an abstract mesh, on which the rules resolve but nothing is placed, or the
one device of a process that was not launched as a rank).  Rank ``r`` sits
at the row-major coordinate ``r`` of the grid, as device ``r`` does in the
reference's meshes.  Functions, not module-level constants: importing this
module starts no process group.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist


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
