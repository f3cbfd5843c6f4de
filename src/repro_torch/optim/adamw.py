"""AdamW with a configurable moment dtype and a cosine/warmup schedule, as
``repro/optim/adamw.py``, on torch tensors.

The state trees are nested dicts of tensors with the reference's names.
``apply_updates`` writes the new params and moments INTO the tensors it is
given (the reference returns new arrays): a second copy of a 5.9 GB train
state is not needed, and the checkpoint plane reads the state synchronously
at step boundaries, so nothing reads a tensor while it is being updated.
The arithmetic is the reference's, expression for expression, in float32.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.models.layers import torch_dtype
from repro_torch.utils.tree import flatten_with_names, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10000
    min_lr_ratio: float = 0.1
    moment_dtype: str = "float32"


def init_opt_state(params, oc: OptConfig) -> dict:
    dt = torch_dtype(oc.moment_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def schedule(oc: OptConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.float()
    warm = torch.clamp(step / max(oc.warmup_steps, 1), max=1.0)
    decay_span = max(oc.decay_steps - oc.warmup_steps, 1)
    prog = torch.clamp((step - oc.warmup_steps) / decay_span, 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return oc.lr * warm * (oc.min_lr_ratio + (1 - oc.min_lr_ratio) * cos)


def global_norm(tree, *, counted=None, group=None) -> torch.Tensor:
    """The l2 norm of every leaf of ``tree``.  Over a mesh, where ``tree``
    holds this rank's blocks: ``counted``, the names of the leaves whose
    square sums this rank adds (one of the ranks that hold the same block),
    and ``group``, the ranks whose sums make the whole (default: this one)."""
    named = flatten_with_names(tree)
    sums = [torch.sum(torch.square(x.float())) for n, x in named
            if counted is None or n in counted]
    total = (torch.sum(torch.stack(sums)) if sums
             else torch.zeros((), device=named[0][1].device))
    if group is not None:
        dist.all_reduce(total, group=group)
    return torch.sqrt(total)


# elements of a leaf updated at a time: the update's float32 temporaries
# (g, m, v, their bias-corrected forms, the step) then take a few GB at most,
# where a whole 10^9-element expert leaf would take ~30 GB of them; every
# operation is elementwise, so the values do not depend on the slicing
UPDATE_SLICE = 1 << 26


@torch.no_grad()
def apply_updates(params, grads, opt, step: torch.Tensor, oc: OptConfig, *,
                  grad_norm=None):
    """Updates ``params`` and ``opt`` in place; returns (params, opt,
    {"grad_norm", "lr"}) with the same tensors.  ``grad_norm``: the norm to
    clip by, where ``grads`` hold only this rank's blocks of the gradients
    (default: ``global_norm(grads)``)."""
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    clip = torch.clamp(oc.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(oc, step)
    b1, b2 = oc.b1, oc.b2
    t = step.float() + 1.0
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)

    def upd(p, g, m, v):
        g32 = g.float() * clip
        m32 = m.float() * b1 + g32 * (1 - b1)
        v32 = v.float() * b2 + torch.square(g32) * (1 - b2)
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + oc.eps) + oc.weight_decay * p.float()
        newp = p.float() - lr * delta
        p.copy_(newp)
        m.copy_(m32)
        v.copy_(v32)

    flat_g = dict(flatten_with_names(grads))
    flat_m = dict(flatten_with_names(opt["m"]))
    flat_v = dict(flatten_with_names(opt["v"]))
    for name, p in flatten_with_names(params):
        flat = [x.view(-1) for x in (p, flat_g[name].contiguous(), flat_m[name], flat_v[name])]
        for i in range(0, p.numel(), UPDATE_SLICE):
            upd(*(x[i:i + UPDATE_SLICE] for x in flat))
    return params, opt, {"grad_norm": gnorm, "lr": lr}
