"""Topology virtualization: host tree <-> device tree.

DMTCP virtualizes PIDs/fds so a restarted process keeps working on a
different node.  The framework analogue: checkpoints never record where a
leaf lived — a leaf is (path, global shape, dtype) — so a restore can place
it wherever the restarted job runs.  The reference re-derives a sharding
per leaf from logical-axis rules against its mesh; the port trains on one
card, so ``place_tree`` takes the target device instead (the mesh rules
come with the parallelism slice).
"""
from __future__ import annotations

from repro_torch.checkpoint.serialization import host_array, to_torch
from repro_torch.utils.tree import tree_map


def place_tree(host_tree, device):
    """Host (numpy) tree -> tree of torch tensors on ``device``; bfloat16
    leaves become torch.bfloat16 with the same bits."""
    return tree_map(lambda a: to_torch(a, device), host_tree)


def fetch_tree(device_tree):
    """Tree of tensors -> host (numpy) tree, bfloat16 as its raw 2-byte
    payload (``serialization.host_array``)."""
    return tree_map(host_array, device_tree)
