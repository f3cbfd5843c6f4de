"""Tensor-parallel operations over the mesh's "model" axis.

The reference's step is one ``jax.jit`` with the rules' shardings, and GSPMD
splits its products over "model" ("heads", "kv_heads", "mlp" and "vocab"
lie on it).  The port computes on each rank's "model" block explicitly, with
Megatron's pair of operations around each split product:

  ``copy_to_model``     identity forward, all-reduce backward: the input of
                        a column-parallel product (a block of the output)
  ``reduce_from_model`` all-reduce forward, identity backward: the output of
                        a row-parallel product (a block of the input)
  ``gather_from_model`` all-gather forward, this rank's slice backward: a
                        block made whole where the computation after it runs
                        on every rank alike
  ``scatter_to_model``  this rank's slice forward, all-gather backward: a
                        whole activation cut to the block of a row-parallel
                        product

so that an activation every "model" rank holds whole has the same, whole
gradient on every rank, and a leaf every rank holds whole (a norm's scale, a
module computed whole) has the same gradient on every rank.
``vocab_parallel_embed`` and ``vocab_parallel_ce`` are the embedding and the
cross entropy on a block of the vocabulary.

The group is that of the ambient rules (``parallel/context.current_rules``)
over "model"; where it is ``None`` (one rank on the axis, no rules: the
card's (1, 1) mesh) every operation is the identity, or the plain form.

Whether the modules compute on blocks is decided once a step: the train
step enters ``computing_on_blocks`` where the "model" axis has several
ranks and it gathered the leaves of ``models.model.tp_leaves`` as blocks.
Only there do the modules read their weights' specs, and ``block_dim`` (or
``vocab_start``, the same rule) holds each weight to its spec under the
rules: the whole leaf, or this rank's block of it.  Elsewhere (serving, the
card, one rank) they take the plain path.  ``COUNTS["block_products"]``
counts the products that ran on a block (``layers.linear`` and the logits).
"""
from __future__ import annotations

from contextvars import ContextVar
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.parallel.context import current_rules

COUNTS = {"block_products": 0}
_ON_BLOCKS = ContextVar("repro_torch_tp_on_blocks", default=False)


class computing_on_blocks:
    """The modules compute on the "model" blocks of ``tp_leaves`` inside
    this context (the train step's, over a "model" axis of several ranks)."""

    def __enter__(self):
        self._tok = _ON_BLOCKS.set(True)
        return self

    def __exit__(self, *exc):
        _ON_BLOCKS.reset(self._tok)


def on_blocks() -> bool:
    return _ON_BLOCKS.get()


def model_group():
    """The process group of the ambient rules' "model" axis, or ``None``."""
    rules = current_rules()
    return None if rules is None else rules.mesh.group(("model",))


def model_rank_size() -> tuple[int, int]:
    """(this rank's index on the "model" axis, the axis' size); (0, 1) with
    no group."""
    group = model_group()
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def block_dim(w: torch.Tensor, spec) -> Optional[int]:
    """The dim of ``w`` along which it is this rank's "model" block of the
    leaf ``spec`` declares (a ``ParamSpec``: the whole leaf's shape and
    logical axes), or ``None`` where ``w`` is the whole leaf."""
    if tuple(w.shape) == tuple(spec.shape):
        return None
    rules = current_rules()
    _, size = model_rank_size()
    dims = [] if rules is None else [
        d for d, a in enumerate(rules.dim_axes(spec.axes, spec.shape)) if a == ("model",)]
    if size == 1 or len(dims) != 1 or w.shape[dims[0]] * size != spec.shape[dims[0]]:
        raise ValueError(f"a weight of shape {tuple(w.shape)} is neither the leaf "
                         f"{tuple(spec.shape)} nor its block over 'model' under the rules")
    return dims[0]


def vocab_start(table: torch.Tensor, spec) -> Optional[int]:
    """The first vocabulary entry of ``table`` (the embedding's rows, the
    head's columns) where it is this rank's "model" block of the leaf
    ``spec`` declares (``block_dim``), ``None`` where it is whole."""
    d = block_dim(table, spec)
    return None if d is None else model_rank_size()[0] * table.shape[d]


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((n * xm.shape[0],) + tuple(xm.shape[1:]))
    dist.all_gather_into_tensor(out, xm, group=group)
    return out.movedim(0, dim).contiguous()


def _own_slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    return x.chunk(n, dim=dim)[r]


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, ctx.dim, ctx.group).contiguous(), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _own_slice(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    group = model_group()
    return x if group is None else _Copy.apply(x, group)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    group = model_group()
    return x if group is None else _Reduce.apply(x, group)


def gather_from_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    group = model_group()
    return x if group is None else _Gather.apply(x, dim, group)


def scatter_to_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    group = model_group()
    return x if group is None else _Scatter.apply(x, dim, group)


def vocab_parallel_embed(table: torch.Tensor, ids: torch.Tensor,
                         vocab_start: int) -> torch.Tensor:
    """Rows of the embedding for ``ids`` (any shape) from ``table``, this
    rank's block of the vocabulary (rows ``vocab_start`` on): an id outside
    the block looks up zeros, and the blocks' rows are summed over "model".
    ``index_select``, whose backward (``index_add``) is deterministic on
    CUDA, does the lookup.  Returns (*ids.shape, D) in the table's dtype."""
    n = table.shape[0]
    local = ids.reshape(-1).long() - vocab_start
    inside = (local >= 0) & (local < n)
    h = torch.index_select(table, 0, torch.where(inside, local, torch.zeros_like(local)))
    h = h * inside[:, None].to(h.dtype)
    return reduce_from_model(h).reshape(*ids.shape, table.shape[-1])


class _VocabCE(torch.autograd.Function):
    """(sum of masked cross entropies, sum of masked logsumexp^2) of logits
    split over the vocabulary; the backward is softmax minus one-hot (and
    the z term's 2 lse softmax) on this rank's block."""

    @staticmethod
    def forward(ctx, logits, labels, mask, vocab_start, group):
        n = logits.shape[-1]
        m = logits.detach().amax(dim=-1)
        if group is not None:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        e = torch.exp(logits - m[..., None])
        local = labels.long() - vocab_start
        inside = (local >= 0) & (local < n)
        local = torch.where(inside, local, torch.zeros_like(local))
        gold = torch.gather(logits, -1, local[..., None])[..., 0] * inside.to(logits.dtype)
        sums = torch.stack([e.sum(dim=-1), gold])
        if group is not None:
            dist.all_reduce(sums, group=group)
        lse = torch.log(sums[0]) + m
        ce = (lse - sums[1]) * mask
        zl = torch.square(lse) * mask
        ctx.save_for_backward(e / sums[0][..., None], local, inside, mask, lse)
        return torch.sum(ce), torch.sum(zl)

    @staticmethod
    def backward(ctx, g_ce, g_z):
        p, local, inside, mask, lse = ctx.saved_tensors
        d = p * ((g_ce + 2.0 * g_z * lse) * mask)[..., None]
        d.scatter_add_(-1, local[..., None],
                       (-g_ce * mask * inside.to(mask.dtype))[..., None].to(d.dtype))
        return d, None, None, None, None


def vocab_parallel_ce(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                      vocab_start: int):
    """``models/model.py::_ce_from_logits`` on ``logits`` (..., V / tp), this
    rank's block of the vocabulary from ``vocab_start``: the max and the
    sum of exponentials are all-reduced over "model" to give the logsumexp,
    the gold logit comes from the rank whose block holds the label, and the
    z term is the logsumexp squared.  Returns (ce_sum, z_sum), the same on
    every "model" rank."""
    return _VocabCE.apply(logits, labels, mask, vocab_start, model_group())
