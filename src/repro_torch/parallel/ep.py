"""Expert parallelism: the MoE experts on the mesh axes the rules give "expert".

The reference places the experts' leaves (``wi_gate``, ``wi_up`` as
``("expert", "embed", "mlp")``, ``wo`` as ``("expert", "mlp", "embed")``)
by its rules: "expert" on ("pod", "data") or ("data",) where the expert
count divides it, "mlp" on "model".  GSPMD then moves the dispatched tokens
from their routing groups to the experts' ranks with an all-to-all over
those axes, computes each rank's experts on its block of ``moe_d_ff`` and
moves the outputs back with a second all-to-all.  The port does the same
explicitly (``models/moe.py``):

  ``to_experts``    (G, E, C, D) -> (P G, E/P, C, D): every rank of the
                    expert group sends each rank the slots of that rank's
                    experts, and receives its own experts' slots of every
                    rank's groups, in rank order; int8 values and their
                    per-slot scales where the dispatch is 8-bit
  ``from_experts``  the inverse, (P G, E/P, C, D) -> (G, E, C, D)

Each is an all-to-all whose backward is the reverse all-to-all of the
gradient (an int8 dispatch's gradient passes straight through, in the
compute dtype).  The group is that of the ambient rules
(``parallel/context.current_rules``) over the expert axes; where it is
``None`` (the rules do not split the experts over several ranks: the card's
(1, 1) mesh, granite-moe's 40 experts on 16 ranks) the MoE layer calls
neither, and no all-to-all runs.
``expert_block`` holds an expert leaf to its spec: whole, this rank's
experts, this rank's "model" block of ``moe_d_ff``, or both.
``COUNTS["all_to_all"]`` counts the all-to-alls run, backward ones included.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.parallel.context import current_rules

COUNTS = {"all_to_all": 0}


def expert_axes(rules, spec) -> tuple:
    """The mesh axes that ``rules`` give the "expert" dim of the expert leaf
    ``spec`` (a ``ParamSpec``), where they hold several ranks; () otherwise
    (no rules, or the expert count does not split)."""
    if rules is None or "expert" not in spec.axes:
        return ()
    axes = rules.dim_axes(spec.axes, spec.shape)[spec.axes.index("expert")]
    return tuple(axes) if rules.shard_count(axes) > 1 else ()


def expert_group(spec):
    """The process group of the ambient rules' expert axes of ``spec``, or
    ``None``."""
    rules = current_rules()
    axes = expert_axes(rules, spec)
    return rules.mesh.group(axes) if axes else None


def expert_rank_size(spec) -> tuple[int, int]:
    """(this rank's index in the expert group of ``spec``, the group's
    size); (0, 1) with no group."""
    group = expert_group(spec)
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def expert_block(w: torch.Tensor, spec) -> tuple[bool, bool]:
    """(whether ``w`` holds this rank's experts only, whether it holds this
    rank's "model" block of ``moe_d_ff``) of the expert leaf ``spec``
    declares, under the ambient rules.  Any shape but the whole leaf, its
    expert block, its "model" block or both raises ``ValueError``."""
    from repro_torch.parallel import tp

    shape, got = tuple(spec.shape), tuple(w.shape)
    e, m = spec.axes.index("expert"), spec.axes.index("mlp")
    _, ne = expert_rank_size(spec)
    mdims = tp.block_dims(spec.axes, spec.shape)
    nm = tp.model_rank_size()[1] if m in mdims else 1
    for ex in (False, True) if ne > 1 else (False,):
        for mb in (False, True) if nm > 1 else (False,):
            want = list(shape)
            want[e] //= ne if ex else 1
            want[m] //= nm if mb else 1
            if got == tuple(want):
                return ex, mb
    raise ValueError(f"an expert weight of shape {got} is neither the leaf {shape} nor "
                     "its block over the expert axes or 'model' under the rules")


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    """All-to-all along dim 0: block j of ``x`` goes to rank j, and block j
    of the result came from rank j."""
    COUNTS["all_to_all"] += 1
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def quantize(x: torch.Tensor):
    """int8 values and per-slot (last dim) absmax scales in ``x``'s dtype:
    the 8-bit dispatch's rounding (``moe.quant_transport``)."""
    x32 = x.float()
    amax = torch.amax(torch.abs(x32), dim=-1, keepdim=True)
    scale = (torch.clamp(amax, min=1e-6) / 127.0).to(x.dtype)
    q = torch.clamp(torch.round(x32 / scale.float()), -127, 127).to(torch.int8)
    return q, scale


class _AllToAll(torch.autograd.Function):
    """(P, ...) blocks exchanged over ``group``; 8-bit where ``quant``: the
    int8 values and their scales travel and are multiplied out after.  The
    backward is the reverse exchange of the gradient, in its own dtype."""

    @staticmethod
    def forward(ctx, x, group, quant):
        ctx.group = group
        if not quant:
            return _exchange(x, group)
        q, scale = quantize(x)
        return _exchange(q, group).to(x.dtype) * _exchange(scale, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None, None


def to_experts(xe: torch.Tensor, spec, quant: bool = False) -> torch.Tensor:
    """The dispatched slots ``xe`` (G, E, C, D) of this rank's groups to the
    ranks of their experts: (P G, E/P, C, D), this rank's E/P experts'
    slots of the groups of every rank of the expert group of ``spec`` (which
    must split the experts), in rank order; 8-bit where ``quant``."""
    group = expert_group(spec)
    n = dist.get_world_size(group)
    G, E, C, D = xe.shape
    blocks = xe.reshape(G, n, E // n, C, D).transpose(0, 1)
    return _AllToAll.apply(blocks, group, quant).reshape(n * G, E // n, C, D)


def from_experts(ye: torch.Tensor, spec) -> torch.Tensor:
    """The inverse of ``to_experts``: (P G, E/P, C, D) -> (G, E, C, D), each
    group's slots back on its rank."""
    group = expert_group(spec)
    n = dist.get_world_size(group)
    PG, El, C, D = ye.shape
    back = _AllToAll.apply(ye.reshape(n, PG // n, El, C, D), group, False)
    return back.transpose(0, 1).reshape(PG // n, n * El, C, D)
