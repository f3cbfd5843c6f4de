"""Topology virtualization — elastic (MxN) restart.

DMTCP virtualizes PIDs/fds so a restarted process keeps working on a
different node.  The framework analogue: checkpoints never record mesh
coordinates — a leaf is (path, global shape, dtype) — and the layout is
*re-derived* from the logical-axis rules against whatever mesh the restarted
job has.  A checkpoint taken on (4, 2) ranks restores onto (2, 4), (8, 1),
(2, 2, 2) or one card unchanged.

``place_tree`` is the single entry point: host tree -> tree of tensors laid
out for the current mesh (``parallel/mesh_rules.py``).  Every rank holds
the whole host tree (each reads the checkpoint), so placing a leaf is
taking this rank's block of it: no communication.  A serving cache moves
between meshes the same way: ``cut_tree`` takes a whole tree to this rank's
blocks as plain tensors (what the engine computes on), ``whole_tree``
gathers them back, so a snapshot is mesh-free.
"""
from __future__ import annotations

import torch

from repro_torch.checkpoint.serialization import host_array, to_torch
from repro_torch.parallel.mesh_rules import named_axes
from repro_torch.utils.tree import (flatten_with_names, tree_map, tree_map_with_path,
                                    unflatten_like)


def cut_over(rules, x, axes, over, shape=None):
    """``x``, a leaf of logical ``axes``, cut to this rank's block along the
    dims that ``rules`` split over mesh axes among ``over``, whole along the
    others; ``x`` itself where no such dim is split.  ``shape``: the whole
    leaf's, where ``x`` is already a block along other dims (default: x's)."""
    shape = tuple(x.shape if shape is None else shape)
    sl = tuple(s if a and set(a) <= set(over) and rules.shard_count(a) > 1 else slice(None)
               for s, a in zip(rules.local_slices(axes, shape), rules.dim_axes(axes, shape)))
    return x if all(s == slice(None) for s in sl) else x[sl]


def cut_tree(whole, axes_tree, rules, model_blocks=None):
    """A tree of whole tensors (every rank holds it) -> this rank's block of
    each leaf under ``rules``, as plain contiguous tensors: the leaves
    named in ``model_blocks`` (every leaf where it is ``None``) as the rules
    lay them out, the others over the mesh's other axes only, whole over
    "model" (their modules compute whole).  A leaf the mesh does not split
    is returned as it is; a cut leaf is a copy, so writing it leaves
    ``whole`` as it was.  No communication."""
    axes = dict(named_axes(axes_tree))
    names = rules.mesh.axis_names

    def cut(name, x):
        over = names if model_blocks is None or name in model_blocks else \
            [a for a in names if a != "model"]
        y = cut_over(rules, x, axes[name], over)
        return x if y is x else y.clone(memory_format=torch.contiguous_format)

    return tree_map_with_path(cut, whole)


def whole_tree(blocks, axes_tree, rules, shapes: dict, model_blocks=None):
    """The inverse of ``cut_tree``: each leaf of ``blocks`` (this rank's,
    laid out as ``cut_tree`` lays out a leaf of whole shape ``shapes[path]``)
    gathered whole from every rank's block (a collective: every rank
    calls).  On a mesh of one rank every leaf is returned as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    axes = dict(named_axes(axes_tree))
    names = rules.mesh.axis_names

    def whole(name, x):
        shape = tuple(shapes[name])
        dims = [tuple(a for a in d if model_blocks is None or name in model_blocks
                      or a != "model") for d in rules.dim_axes(axes[name], shape)]
        if all(rules.shard_count(d) == 1 for d in dims):
            return x
        placements = [Replicate() for _ in names]
        for d, mesh_axes in enumerate(dims):
            for a in mesh_axes:
                placements[names.index(a)] = Shard(d)
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(x.contiguous(), rules.mesh.device_mesh, placements,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=stride).full_tensor()

    return tree_map_with_path(whole, blocks)


def _tensor(arr, device):
    """A host array as a tensor on ``device``; a ``meta`` tensor (an abstract
    leaf) as a new meta tensor of its shape, so no two leaves share one."""
    if isinstance(arr, torch.Tensor) and arr.is_meta:
        return torch.empty(arr.shape, dtype=arr.dtype, device="meta")
    return to_torch(arr, device)


def place_tree(host_tree, axes_tree, rules, device):
    """Host (numpy) tree -> tree of tensors on ``device``: a leaf that its
    logical axes (``axes_tree``) split over ``rules``' mesh becomes a
    ``DTensor`` of the rules' placements, built from this rank's block; a
    leaf they replicate (every leaf on a mesh of one rank) stays a plain
    tensor.  bfloat16 leaves become torch.bfloat16 with the same bits.  A
    tree of ``meta`` tensors (``launch/specs.py``) is placed as meta
    blocks, with no storage: the dry run's."""
    axes = dict(named_axes(axes_tree))

    def place(name, arr):
        shape = tuple(arr.shape)
        ax = axes[name]
        if rules.is_replicated(ax, shape):
            return _tensor(arr, device)
        from torch.distributed.tensor import DTensor

        local = _tensor(arr[rules.local_slices(ax, shape)], device)
        return DTensor.from_local(local, rules.mesh.device_mesh, rules.placements(ax, shape),
                                  run_check=False)

    return tree_map_with_path(place, host_tree)


def full_tensor(x):
    """A leaf whole on this rank: a ``DTensor`` gathered from its blocks
    (every rank of its mesh must call), anything else as it is."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def gather_over(x, mesh_axes):
    """A leaf gathered over the named mesh axes only (a ``DTensor``: every
    rank of those axes' groups must call), as a plain tensor: this rank's
    block along every other axis (the "model" block, where ``mesh_axes`` are
    the others); anything else as it is."""
    if not hasattr(x, "redistribute"):
        return x
    from torch.distributed.tensor import Replicate

    names = x.device_mesh.mesh_dim_names
    return x.redistribute(placements=[Replicate() if n in mesh_axes else pl
                                      for n, pl in zip(names, x.placements)]).to_local()


def owned_tree(device_tree, axes_tree, rules, rank: int, world: int):
    """The leaves this rank writes in a checkpoint of ``world`` workers (leaf
    ``i``, in ``flatten_with_names`` order, belongs to worker ``i % world``,
    as ``checkpoint/manager.py`` lays a save out): each of them whole, and
    an empty placeholder in place of every other leaf (the manager reads
    only its own).  A leaf the mesh splits (a ``DTensor``) is gathered to
    its owner alone, one leaf at a time (``dist.gather`` of the blocks:
    every rank calls, leaf by leaf), so no rank holds a leaf whole that it
    does not write.  On one rank: ``device_tree`` itself."""
    if world == 1:
        return device_tree
    import torch.distributed as dist

    axes = dict(named_axes(axes_tree))
    named = flatten_with_names(device_tree)
    out = {}
    for i, (name, x) in enumerate(named):
        owner = i % world
        if hasattr(x, "to_local"):
            local = x.to_local().contiguous()
            blocks = [torch.empty_like(local) for _ in range(world)] if rank == owner else None
            dist.gather(local, blocks, dst=owner)
            if rank == owner:
                shape = tuple(x.shape)
                whole = torch.empty(shape, dtype=local.dtype, device=local.device)
                for r, block in enumerate(blocks):
                    sl = rules.local_slices(axes[name], shape, rules.mesh.coordinate_of(r))
                    whole[sl] = block
                x = whole
            del local, blocks
        out[name] = x if rank == owner else torch.empty(0, dtype=x.dtype)
    return unflatten_like(device_tree, out)


def fetch_tree(device_tree):
    """Tree of tensors -> host (numpy) tree, each ``DTensor`` gathered whole
    first (a collective: every rank calls), bfloat16 as its raw 2-byte
    payload (``serialization.host_array``)."""
    return tree_map(lambda x: host_array(full_tensor(x)), device_tree)
