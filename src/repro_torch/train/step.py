"""Train step: microbatched (gradient accumulation as the reference's), over a mesh.

The state is a plain dict ``{params, opt{m,v}, step}`` with the reference's
tree and names (``repro/train/step.py``), so the checkpoint plane saves it
as it saves the reference's; ``state_logical_axes`` annotates it for the
mesh rules.  ``make_train_step`` returns a function ``step(state, batch) ->
(state, metrics)`` that differentiates ``models.model.loss_fn`` with
autograd and updates the params and moments in place
(``optim.adamw.apply_updates``); ``step`` is a new 0-d tensor.

Over a mesh of several ranks (``core.virtualization.place_tree`` lays the
state out; a leaf the rules split is a ``DTensor``), each rank takes its
rows of the global batch by the batch's placement.  The leaves of the
tensor-parallel modules (``models.model.tp_leaves``: the embedding, the
head, GQA and MLA attention, the dense SwiGLU, the MoE layers, the MTP
block's, zamba2's shared block's, Mamba2's ``out_proj`` and RWKV6's heads'
and channel-mix products) are gathered over their non-"model" axes only, the MoE experts
(``models.model.ep_leaves``) over the axes other than "model" and their
expert axes, and those modules compute on this rank's blocks of them
(``parallel/tp.py``, ``parallel/ep.py``; the step decides this once, where
the "model" axis has several ranks or the rules split the experts over
several, and runs under ``tp.computing_on_blocks``), as the reference's
GSPMD splits their products; every other leaf is gathered whole.  Each
gradient is cut to its "model" block, summed over the batch ranks (an
expert block's over those outside its expert axes only: the all-to-all
brought it every token of its group of ranks) and cut to this rank's
block (one reduce-scatter where the leaf's other split lies along the
batch ranks' axes); AdamW then updates each rank's own blocks of the params and
moments, clipped by the norm of the whole gradient (each block's square
sum counted once, summed over the mesh).  With ``impl="ring"`` the "model"
axis carries the ring's sequence, and every leaf is gathered whole.  On a
mesh of one rank every leaf is a plain tensor, and the step is the
one-device step.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core.virtualization import cut_over, full_tensor, gather_over
from repro_torch.kernels import costs
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.optim import adamw
from repro_torch.parallel import ep, tp
from repro_torch.parallel.collectives import group_sum
from repro_torch.parallel.context import use_mesh_context
from repro_torch.parallel.mesh_rules import Rules, batch_logical_axes, named_axes
from repro_torch.utils.tree import flatten_with_names, tree_map, unflatten_like


def state_logical_axes(cfg: ModelConfig) -> dict:
    pax = M.param_logical_axes(cfg)
    return {"params": pax, "opt": {"m": pax, "v": pax}, "step": ()}


def predump_boundary(step: int, interval: int, lead: int = 1) -> bool:
    """True when ``step`` is inside the pre-dump window before an interval
    checkpoint: EVERY step in the ``lead`` steps before each boundary fires
    a ``CheckpointManager.precommit`` (iterative pre-copy, CRIU-style).
    Each pre-dump uses the previous one as its fingerprint reference, so
    lead N-1 re-hashes only what dirtied since lead N-2 and the save at the
    boundary pays only for the last step's churn.  ``lead=1`` reproduces
    the single-pre-dump schedule exactly.  ``lead >= interval`` would
    pre-dump a state staler than the previous checkpoint — clamped to
    ``interval - 1``.
    """
    if interval <= 1 or step < 0:
        return False            # interval=1: every step saves; nothing to overlap
    lead = max(1, min(lead, interval - 1))
    r = (-step) % interval      # steps until the next boundary
    return 1 <= r <= lead


def effective_microbatches(global_batch: int, requested: int, batch_shards: int) -> int:
    """Largest M <= requested such that B % M == 0 and each microbatch still
    covers the batch shards (no half-empty DP shards)."""

    def ok(m):
        return global_batch % m == 0 and (global_batch // m) >= min(batch_shards, global_batch)

    for m in range(max(1, min(requested, global_batch)), 0, -1):
        if ok(m):
            return m
    return 1


def abstract_train_state(cfg: ModelConfig, oc: adamw.OptConfig) -> dict:
    """The state's tree as tensors on the ``meta`` device (the template a
    restore fills)."""
    p = M.abstract_params(cfg)
    mdt = L.torch_dtype(oc.moment_dtype)
    mom = tree_map(lambda s: torch.empty(s.shape, dtype=mdt, device="meta"), p)
    return {"params": p, "opt": {"m": mom, "v": mom},
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def init_train_state(cfg: ModelConfig, oc: adamw.OptConfig, seed: int, device) -> dict:
    """Fresh params from ``seed`` (``layers.materialize``), zero moments,
    step 0, all on ``device``."""
    params = L.materialize(M.param_specs(cfg), seed, L.torch_dtype(cfg.param_dtype), device)
    return {
        "params": params,
        "opt": adamw.init_opt_state(params, oc),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def loss_and_grads(params: dict, cfg: ModelConfig, batch: dict, *, impl=None,
                   z_loss: float = 1e-4, moe_groups: int = 1, batch_group=None):
    """(loss, metrics, grads) of ``loss_fn`` at ``params``; grads is a tree
    like ``params``, each leaf in its parameter's dtype: zeros for a leaf
    the loss does not use (a segment of 0 layers, as ``jax.grad`` gives).
    The params are read, never written.  MoE layers route with
    ``moe_groups`` groups: the train step passes the reference's, its batch
    shard count (1 on one device; ``loss_fn``'s own default, 16, is
    serving's), over this rank's share.  ``batch_group``: as ``loss_fn``'s,
    the loss and the gradients are then this rank's shares.

    A segment's stacked leaves are differentiated one layer at a time (a
    leaf per layer, a view of the stacked tensor) and each stacked
    gradient is assembled afterwards, one leaf at a time: through
    ``unbind``'s backward every layer's gradient and their stack would be
    held at once, twice the gradients' size (27 GB for granite-moe)."""
    named = flatten_with_names(params)
    counts = {f"seg{i}": seg.count for i, seg in enumerate(M.layer_plan(cfg))}
    wrt = []                                # (name, leaf): one a layer in a segment
    flat = {}
    for n, p in named:
        if n.split("/")[0] not in counts:
            flat[n] = p.detach().requires_grad_(True)
            wrt.append((n, flat[n]))
        else:
            flat[n] = p
    tree = unflatten_like(params, flat)
    for key, count in counts.items():
        seg_named = flatten_with_names(params[key])
        layers = []
        for j in range(count):
            views = {n: x[j].detach().requires_grad_(True) for n, x in seg_named}
            wrt.extend((f"{key}/{n}", v) for n, v in views.items())
            layers.append(unflatten_like(params[key], views))
        tree[key] = layers
    with torch.enable_grad():
        loss, metrics = M.loss_fn(tree, cfg, batch, moe_groups=moe_groups, impl=impl,
                                  z_loss=z_loss, batch_group=batch_group)
        grads = list(torch.autograd.grad(loss, [t for _, t in wrt], allow_unused=True))
    pieces: dict = {}
    for (n, t), g in zip(wrt, grads):
        pieces.setdefault(n, []).append(torch.zeros_like(t) if g is None else g)
    del grads
    out = {}
    for n, p in named:
        parts = pieces.pop(n, None)
        if parts is None:                   # a segment of 0 layers
            out[n] = torch.zeros_like(p)
        elif n.split("/")[0] in counts:
            out[n] = torch.stack(parts)
        else:
            out[n] = parts[0]
        del parts                           # this leaf's pieces go before the next stack
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten_like(params, out))


def shard_batch(rules: Rules, batch: dict) -> tuple[dict, tuple]:
    """(this rank's rows of a global batch by the batch's placement, the mesh
    axes its rows are split over)."""
    axes = batch_logical_axes(batch)
    tok = batch["tokens"]
    mesh_axes = rules.dim_axes(axes["tokens"], tuple(tok.shape))[0]
    local = {k: x[rules.local_slices(axes[k], tuple(x.shape))] for k, x in batch.items()}
    return local, mesh_axes


def _reduce_scatter(g, dim: int, group, rest) -> torch.Tensor:
    """``g`` summed over ``group`` and cut to this rank's block along
    ``dim`` (the group's rank order is the blocks'), then summed over
    ``rest`` (``None``: no other ranks)."""
    n = dist.get_world_size(group)
    x = g.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=group)
    if rest is not None:
        dist.all_reduce(out, group=rest)
    return out.movedim(0, dim)


def own_block(rules: Rules, g, shape, axes, batch_axes) -> torch.Tensor:
    """A gradient (whole, or the block its module computed) summed over the
    batch ranks (split over ``batch_axes``) and cut to this rank's block of
    the leaf of ``shape`` and logical ``axes``.  A gradient computed whole
    is cut to its "model" block first, the same on every "model" rank, so
    none is summed whole.  A gradient that is already this rank's block
    along another dim (an expert leaf's experts, whose all-to-all brought
    every token of their group of ranks here) is complete over that dim's
    axes: it is summed over the batch axes outside them only.  Where the
    leaf's other split lies along the batch ranks' axes, the sum and the cut
    are one reduce-scatter (and an all-reduce over the batch axes left)."""
    if tuple(g.shape) == tuple(shape):
        g = cut_over(rules, g, axes, ("model",), shape).contiguous()
    dims = rules.dim_axes(axes, shape)
    owned = {a for d, axs in enumerate(dims) if axs != ("model",) and g.shape[d] != shape[d]
             for a in axs}
    batch_axes = [a for a in batch_axes if a not in owned]
    split = [(d, a) for d, a in enumerate(dims)
             if a and a != ("model",) and not owned & set(a) and rules.shard_count(a) > 1]
    group = rules.mesh.group(batch_axes)
    if group is not None and len(split) == 1 and set(split[0][1]) <= set(batch_axes):
        d, a = split[0]
        return _reduce_scatter(g, d, rules.mesh.group(a),
                               rules.mesh.group([x for x in batch_axes if x not in a]))
    if group is not None:
        dist.all_reduce(g, group=group)
    others = [a for a in rules.mesh.axis_names if a != "model" and a not in owned]
    return cut_over(rules, g, axes, others, shape).contiguous()


def make_train_step(cfg: ModelConfig, oc: adamw.OptConfig, *,
                    rules: Optional[Rules] = None, microbatches: int = 1,
                    impl: Optional[str] = None, z_loss: float = 1e-4):
    """The reference's train step over ``rules``' mesh (default: the rules
    of ``launch.mesh.make_host_mesh`` on the device of the first state the
    step is given, one rank unless a process group is up).  MoE layers
    route with the batch shard count as their group count, as the
    reference's (1 on one rank).  Microbatch gradients (each summed over
    the batch ranks) are summed in bfloat16 for bfloat16 params, else in
    float32, divided by the microbatch count in that dtype, then cast to
    float32, as the reference's default ``accum_dtype`` does.  The step's
    metrics are the reference's (``loss``, ``ce`` and the optimiser's) plus
    the loss's ``aux`` and ``mtp_ce`` (mean over the microbatches), which
    the reference computes but does not return; each is the whole batch's."""
    adt = torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32
    param_axes = dict(named_axes(state_logical_axes(cfg)["params"]))
    # where the "model" axis carries the ring's sequence, every module computes whole
    blocks = set() if (impl or cfg.attn_impl) == "ring" else M.tp_leaves(cfg)
    specs = dict(flatten_with_names(M.param_specs(cfg)))
    shapes = {n: tuple(s.shape) for n, s in specs.items()}
    experts = M.ep_leaves(cfg) & blocks

    def grads_of(params: dict, mb: dict):
        local, batch_axes = shard_batch(rules, mb)
        if experts:
            MOE.check_rows(cfg, rules, batch_axes)
        group, shards = rules.mesh.group(batch_axes), rules.shard_count(batch_axes)
        moe_groups = rules.axis_group_size("batch")
        if moe_groups % shards:
            raise ValueError(f"{moe_groups} routing groups do not split over the "
                             f"batch's {shards} slices")
        loss, mets, grads = loss_and_grads(params, cfg, local, impl=impl, z_loss=z_loss,
                                           moe_groups=moe_groups // shards,
                                           batch_group=group)
        if rules.mesh.size > 1:
            with costs.section("grads"):
                grads = unflatten_like(grads, {
                    n: own_block(rules, g, shapes[n], param_axes[n], batch_axes)
                    for n, g in flatten_with_names(grads)})
        if group is not None:
            loss = group_sum(loss, group)
            mets = {k: group_sum(v, group) for k, v in mets.items() if k != "tokens"}
        return loss, mets, grads

    def counted(params: dict) -> set:
        """The leaves whose blocks' square sums this rank adds to the norm:
        of the ranks that hold one block, the one at coordinate 0 on every
        axis that does not split the leaf."""
        coord = dict(zip(rules.mesh.axis_names, rules.mesh.coordinate))
        out = set()
        for n, x in flatten_with_names(params):
            split = {a for d in rules.dim_axes(param_axes[n], tuple(x.shape)) for a in d}
            if all(coord[a] == 0 for a in rules.mesh.axis_names if a not in split):
                out.add(n)
        return out

    def local(tree):
        return tree_map(lambda x: x.to_local() if hasattr(x, "to_local") else x, tree)

    def train_step(state: dict, batch: dict):
        nonlocal rules
        if rules is None:
            rules = Rules(make_host_mesh(state["step"].device))
        # the modules compute on "model" and expert blocks, or all whole:
        # decided once a step
        on_blocks = bool(blocks) and (rules.mesh.group(("model",)) is not None
                                      or MOE.splits_experts(cfg, rules))
        with use_mesh_context(rules.mesh, rules), \
                (tp.computing_on_blocks() if on_blocks else contextlib.nullcontext()):
            return _step(state, batch, on_blocks)

    def _step(state: dict, batch: dict, on_blocks: bool):
        params = state["params"]
        if on_blocks:
            others = [a for a in rules.mesh.axis_names if a != "model"]

            def over(n):
                if n not in experts:
                    return others
                ex = ep.expert_axes(rules, specs[n])
                return [a for a in others if a not in ex]

            compute = unflatten_like(params, {
                n: gather_over(x, over(n)) if n in blocks else full_tensor(x)
                for n, x in flatten_with_names(params)})
        else:
            compute = tree_map(full_tensor, params)
        batch = tree_map(full_tensor, batch)        # a placed batch is taken whole
        B = batch["tokens"].shape[0]
        mb_count = effective_microbatches(B, microbatches, rules.axis_group_size("batch"))
        if mb_count == 1:
            loss, metrics, grads = grads_of(compute, batch)
        else:
            gsum = lsum = None
            msum: dict = {}
            for i in range(mb_count):
                mb = {k: x[i * (B // mb_count):(i + 1) * (B // mb_count)]
                      for k, x in batch.items()}
                l, mets, g = grads_of(compute, mb)
                if gsum is None:
                    gsum, lsum = tree_map(lambda x: x.to(adt), g), l
                else:
                    gsum = tree_map(lambda a, b: a + b.to(adt), gsum, g)
                    lsum = lsum + l
                for k in ("ce", "aux", "mtp_ce"):
                    if k in mets:
                        msum[k] = msum[k] + mets[k] if k in msum else mets[k]
            grads = tree_map(lambda g: (g / mb_count).float(), gsum)
            loss = lsum / mb_count
            metrics = {k: v / mb_count for k, v in msum.items()}
        del compute
        # each rank's blocks, clipped by the norm of the whole gradient (on one
        # rank: the whole leaves and their own norm)
        if rules.mesh.size > 1:
            norm = adamw.global_norm(grads, counted=counted(params),
                                     group=rules.mesh.group(rules.mesh.axis_names))
        else:
            norm = adamw.global_norm(grads)
        _, _, om = adamw.apply_updates(local(params), grads, local(state["opt"]),
                                       state["step"], oc, grad_norm=norm)
        new_state = {"params": params, "opt": state["opt"], "step": state["step"] + 1}
        extra = {k: metrics[k] for k in ("aux", "mtp_ce") if k in metrics}
        return new_state, {"loss": loss, "ce": metrics.get("ce", loss), **om, **extra}

    return train_step
