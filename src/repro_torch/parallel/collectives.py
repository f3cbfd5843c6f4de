"""Sums over the ranks of a process group that hold other slices of a batch."""
from __future__ import annotations

import torch
import torch.distributed as dist


def group_sum(x: torch.Tensor, group) -> torch.Tensor:
    """A copy of ``x`` summed over the ranks of ``group`` (``None``: ``x``
    itself, one rank); no gradient flows through the sum."""
    if group is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=group)
    return x
