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
taking this rank's block of it: no communication.
"""
from __future__ import annotations

import torch

from repro_torch.checkpoint.serialization import host_array, to_torch
from repro_torch.parallel.mesh_rules import named_axes
from repro_torch.utils.tree import tree_map, tree_map_with_path


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


def fetch_tree(device_tree):
    """Tree of tensors -> host (numpy) tree, each ``DTensor`` gathered whole
    first (a collective: every rank calls), bfloat16 as its raw 2-byte
    payload (``serialization.host_array``)."""
    return tree_map(lambda x: host_array(full_tensor(x)), device_tree)
