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
module computed whole) has the same gradient on every rank.  Two rules
follow from that for a module that computes on this rank's share of its
heads or channels:

  ``sum_over_model``    a statistic summed over the split channels (Mamba2's
                        gated RMSNorm over all of its inner width) is
                        all-reduced in both directions: every rank uses the
                        sum in its own channels
  ``own_part``          a whole tensor that a rank reads only in part (a
                        whole leaf sliced to its heads, the fused in-
                        projection's columns of its heads) enters through
                        ``copy_to_model``, so its partial gradients are
                        summed: the step cuts a whole-shaped gradient to its
                        "model" block without summing it
``vocab_parallel_embed`` and ``vocab_parallel_ce`` are the embedding and the
cross entropy on a block of the vocabulary; ``gather_logits`` makes a block
of the logits whole for serving's argmax.

Serving holds a KV (or MLA latent) cache as the rules give it: this rank's
kv heads (``kv_heads_dim`` on "model"), or, where the kv heads do not split,
this rank's block of positions (``cache_seq``, ``seq_block``).  Decode over
a block of positions attends to ``local_kv_len`` of them, and
``merge_over_model`` merges the ranks' outputs by their log-sum-exps, as the
reference's partitioned softmax does; ``write_owned`` writes the new entry
into the block that holds position ``t``.  ``t`` stays on the device in all
of them: a decode step never syncs the host.

The group is that of the ambient rules (``parallel/context.current_rules``)
over "model"; where it is ``None`` (one rank on the axis, no rules: the
card's (1, 1) mesh) every operation is the identity, or the plain form.

Whether the modules compute on blocks is decided once a step: the train
step enters ``computing_on_blocks`` where the "model" axis has several
ranks (or the rules split the MoE experts over several, ``parallel/ep.py``)
and it gathered the leaves of ``models.model.tp_leaves`` as blocks.
Only there do the modules read their weights' specs, and ``block_dim`` (or
``vocab_start``, the same rule) holds each weight to its spec under the
rules: the whole leaf, or this rank's block of it.  Serving decides it the
same way (``serve/engine.py``).  Elsewhere (the card, one rank) they take
the plain path.  ``COUNTS["block_products"]``
counts the products that ran on a block (``layers.linear``, MLA's per-head
up-projections, the experts', the logits, and the SSM mixers' and zamba2's
``shared_in``'s on this rank's share of a whole weight).
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


def block_dims(axes, shape) -> list:
    """The dims of a leaf of logical ``axes`` and whole ``shape`` that the
    ambient rules split over "model" (where it has several ranks); [] with
    no group."""
    rules = current_rules()
    if model_group() is None:
        return []
    return [d for d, a in enumerate(rules.dim_axes(axes, shape)) if a == ("model",)]


def block_shape(axes, shape) -> tuple:
    """The shape of this rank's "model" block of such a leaf."""
    _, n = model_rank_size()
    dims = block_dims(axes, shape)
    return tuple(s // n if d in dims else s for d, s in enumerate(shape))


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


def sum_over_model(x: torch.Tensor) -> torch.Tensor:
    """``x``, this rank's partial sum of a statistic, summed over "model" in
    both directions: the forward all-reduces the partial sums, and, since
    every rank uses the sum in its own share of the computation (a norm's
    statistic over channels split over "model"), the backward all-reduces
    the gradient too.  ``reduce_from_model`` alone would leave each rank's
    gradient its own share."""
    return reduce_from_model(copy_to_model(x))


def own_part(w: torch.Tensor, dim: int, parts) -> torch.Tensor:
    """The ``parts`` ((start, length) along ``dim``, concatenated in order)
    of ``w``, a tensor every "model" rank holds whole (a whole leaf, or an
    activation computed alike on every rank) and reads only in part for its
    share of a split computation.  ``w`` enters through ``copy_to_model``,
    so each rank's partial gradient of it is summed over "model": the
    gradient reduction cuts a whole-shaped gradient to its block without
    summing it."""
    w = copy_to_model(w)
    return torch.cat([w.narrow(dim, a, n) for a, n in parts], dim=dim)


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


def gather_logits(logits: torch.Tensor) -> torch.Tensor:
    """A block of the logits along the vocabulary (the last dim) made whole
    on every "model" rank, for serving's argmax; no grad."""
    group = model_group()
    return logits if group is None else _all_gather(logits, logits.ndim - 1, group)


# ----------------------------------------------------------------------------------
# A cache split over "model" by position (the rules' ``cache_seq``)
# ----------------------------------------------------------------------------------


def seq_block(S: int) -> tuple[int, int]:
    """(first position, length) of this rank's block of a cache of ``S``
    positions split over "model": ``[r S/P, (r+1) S/P)``; (0, S) with no
    group.  Raises where P does not divide S."""
    r, n = model_rank_size()
    if S % n:
        raise ValueError(f"a cache of {S} positions does not split over {n} 'model' ranks")
    return r * (S // n), S // n


def local_kv_len(t: torch.Tensor, S: int) -> torch.Tensor:
    """The positions of this rank's block (``seq_block(S)``) that a query at
    position ``t`` (a 0-d int32 on the device) attends to, ``clamp(t + 1 -
    start, 0, S / P)``, as a 0-d int32 on ``t``'s device: computed there, so
    the host never waits."""
    start, n = seq_block(S)
    return torch.clamp(t.reshape(()) + 1 - start, 0, n).to(torch.int32)


def write_owned(cache: torch.Tensor, entry: torch.Tensor, t: torch.Tensor, S: int) -> None:
    """Write ``entry`` (the new position's, (B, 1, ...)) into ``cache``, this
    rank's block of a cache of ``S`` positions (dim 1), at ``t`` where the
    block holds ``t``; elsewhere the block is written with its own values.
    A masked ``index_copy_`` on the device: no ``.item()``."""
    start, n = seq_block(S)
    local = t.reshape(1).long() - start
    inside = (local >= 0) & (local < n)
    idx = torch.where(inside, local, torch.zeros_like(local))
    old = cache.index_select(1, idx)
    cache.index_copy_(1, idx, torch.where(inside, entry.to(cache.dtype), old))


def merge_partials(outs, lses) -> torch.Tensor:
    """The merge of attention outputs over disjoint blocks of the keys, in
    the order given: ``outs`` (B,1,H,Dv) each, ``lses`` their float32
    log-sum-exps (B,1,H).  ``lse* = max lse_r``, ``w_r = exp(lse_r - lse*)``
    (0 for a block with no key, ``-inf``), ``out = sum w_r out_r / sum w_r``
    in float32, zeros where no block has a key; in the outputs' dtype."""
    m = lses[0]
    for lse in lses[1:]:
        m = torch.maximum(m, lse)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    num = den = None
    for out, lse in zip(outs, lses):
        w = torch.exp(lse - m)
        term = out.float() * w[..., None]
        num, den = (term, w) if num is None else (num + term, den + w)
    merged = num / torch.where(den > 0, den, torch.ones_like(den))[..., None]
    return merged.to(outs[0].dtype)


def merge_over_model(out: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """Attention over this rank's block of positions (``out`` (B,1,H,Dv) and
    its ``lse`` (B,1,H)) merged with every "model" rank's: one all-gather of
    both, then ``merge_partials`` in rank order, so every rank holds the
    same bytes.  ``out`` itself with no group; no grad."""
    group = model_group()
    if group is None:
        return out
    both = torch.cat([out.float(), lse[..., None]], dim=-1)
    parts = _all_gather(both[None], 0, group)
    return merge_partials([p[..., :-1].to(out.dtype) for p in parts],
                          [p[..., -1] for p in parts])
