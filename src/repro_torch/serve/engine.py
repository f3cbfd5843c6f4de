"""A batched generation engine with checkpointable generation state.

The ``Engine`` drives batched greedy generation on one device and exposes
its cache as checkpointable state: the paper's "pause, migrate, resume"
applied to serving (``launch/serve.py --snapshot-at`` snapshots a
half-generated batch and resumes it in a fresh engine).  PyTorch runs
eagerly, so there is no step factory to lower: ``prefill`` and ``generate``
call the model's functions directly, and attention on a CUDA tensor goes
through the hand-written kernels.  As the reference's step factories do,
the engine runs under its mesh and rules (``parallel.context``), and MoE
layers route with the batch axis's shard count as their group count (1 on
one card).

Over a mesh of several ranks each rank serves its rows of the batch (the
rules' "batch" placement), and where the "model" axis has several ranks, or
the rules split the MoE experts over several, the modules compute on this
rank's blocks (``tp.computing_on_blocks``), as the train step does: each
leaf of ``models.model.tp_leaves`` is this rank's "model" block of it (the
experts also their block over their expert axes), and every other leaf
whole (``serving_params``).  Decode routes the whole batch as one group,
as the reference's does (``moe.moe_ffn``'s ``row_axes``).  The cache is
then the rules' blocks from prefill on (``models.model.serving_blocks``:
the attention caches on ``kv_heads_dim`` or ``cache_seq``, the SSM
states on ``ssm_heads_dim``; every other leaf rows only).  A snapshot
holds the whole cache (``core.virtualization.whole_tree``), with the
one-rank engine's paths, shapes and dtypes, and ``restore`` cuts it to this
engine's blocks, so a snapshot taken on one mesh restores on any other.
``prefill_step`` and ``decode_step`` are the steps the engine runs, and the
dry run walks (``launch/dryrun.py``).  On a mesh of one rank every one of
these is the identity: the engine computes on the tree it was given.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.virtualization import (cut_over, cut_tree, full_tensor, gather_over,
                                             whole_tree)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.parallel import ep, tp
from repro_torch.parallel.context import use_mesh_context
from repro_torch.parallel.mesh_rules import Rules, batch_logical_axes, named_axes
from repro_torch.serve.weight_sync import ParamHandle
from repro_torch.utils.tree import flatten_with_names, tree_map, unflatten_like


def _device_of(params) -> torch.device:
    tree = params.tree if isinstance(params, M.LM) else params
    return next(x for _, x in flatten_with_names(tree)).device


def computes_on_blocks(cfg: ModelConfig, rules: Rules, impl: Optional[str] = None) -> bool:
    """Serving computes on blocks: the "model" axis has several ranks, or
    the rules split the MoE experts over several
    (``moe.splits_experts``), and "model" does not carry the ring's
    sequence (``impl="ring"``)."""
    return (impl or cfg.attn_impl) != "ring" and (rules.axis_sizes.get("model", 1) > 1
                                                  or MOE.splits_experts(cfg, rules))


def _context(cfg, rules, impl):
    return tp.computing_on_blocks() if computes_on_blocks(cfg, rules, impl) else \
        contextlib.nullcontext()


def serving_params(cfg: ModelConfig, params, rules: Rules, impl: Optional[str] = None):
    """The parameters the steps compute on: where serving computes on
    "model" blocks, each leaf of ``tp_leaves`` as this rank's "model" block
    (a ``DTensor`` gathered over the other mesh axes only, a whole tensor
    cut) and every other leaf whole; elsewhere every leaf whole (``params``
    itself where no leaf is a ``DTensor``)."""
    tree = params.tree if isinstance(params, M.LM) else params
    named = flatten_with_names(tree)
    if not computes_on_blocks(cfg, rules, impl):
        if not any(hasattr(x, "full_tensor") for _, x in named):
            return params
        return tree_map(full_tensor, tree)
    blocks, experts = M.tp_leaves(cfg), M.ep_leaves(cfg)
    axes = dict(named_axes(M.param_logical_axes(cfg)))
    specs = dict(flatten_with_names(M.param_specs(cfg)))

    def leaf(n, x):
        if n not in blocks:
            return full_tensor(x)
        own = ("model",) + (ep.expert_axes(rules, specs[n]) if n in experts else ())
        if hasattr(x, "redistribute"):
            return gather_over(x, [a for a in rules.mesh.axis_names if a not in own])
        return cut_over(rules, x, axes[n], own).contiguous()

    return unflatten_like(tree, {n: leaf(n, x) for n, x in named})


def batch_rows(rules: Rules, batch: dict) -> dict:
    """This rank's rows of a batch: a placed leaf's (``DTensor``) own block,
    a whole leaf cut by the batch's placement."""
    axes = batch_logical_axes(batch)
    return {k: x.to_local() if hasattr(x, "to_local")
            else x[rules.local_slices(axes[k], tuple(x.shape))] for k, x in batch.items()}


def prefill_step(cfg: ModelConfig, rules: Rules, params, batch: dict, max_seq: int, *,
                 impl: Optional[str] = None):
    """Prefill of this rank's rows of ``batch`` (whole, or placed) on
    ``params`` (``serving_params``'s): (last-position logits of those rows,
    whole over the vocabulary, the cache's blocks).  MoE layers route with
    the batch axis's shard count over the batch as groups, this rank's
    share of them over its rows."""
    rows = batch_rows(rules, batch)
    shards = batch["tokens"].shape[0] // max(rows["tokens"].shape[0], 1)
    if cfg.num_experts and computes_on_blocks(cfg, rules, impl):
        tokens = batch["tokens"]
        MOE.check_rows(cfg, rules, rules.dim_axes(batch_logical_axes(batch)["tokens"],
                                                  tuple(tokens.shape))[0])
    with use_mesh_context(rules.mesh, rules), _context(cfg, rules, impl):
        return M.prefill(params, cfg, rows, max_seq, impl=impl,
                         moe_groups=max(1, rules.axis_group_size("batch") // shards))


def _row_axes(rules: Rules, batch: int) -> tuple:
    """The mesh axes that split the rows of a batch of ``batch``."""
    return tuple(rules.dim_axes(("batch",), (batch,))[0])


def decode_step(cfg: ModelConfig, rules: Rules, params, tokens, cache: dict, max_seq: int,
                batch: int, *, impl: Optional[str] = None):
    """One decode step of this rank's rows (``tokens``, ``cache``: its
    blocks of a cache of ``max_seq`` positions) of a batch of ``batch``
    rows: (their logits, whole over the vocabulary, the cache, updated in
    place).  MoE layers route the whole batch as one group, as the
    reference's decode does."""
    with use_mesh_context(rules.mesh, rules), _context(cfg, rules, impl):
        return M.decode_step(params, cfg, tokens, cache, impl=impl, max_seq=max_seq,
                             row_axes=_row_axes(rules, batch))


class Engine:
    """Minimal batched serving engine with checkpointable generation state."""

    def __init__(self, cfg: ModelConfig, params, *, batch: int, max_seq: int,
                 impl: Optional[str] = None, sync_client=None,
                 rules: Optional[Rules] = None):
        self.cfg = cfg
        self.param_handle = (params if isinstance(params, ParamHandle)
                             else ParamHandle(params))
        # default: the host mesh (one rank unless a process group is up) on
        # the device of the params
        self.rules = rules or Rules(make_host_mesh(_device_of(self.param_handle.current)))
        self.mesh = self.rules.mesh
        # routing groups over the whole batch; each rank routes its share
        self.moe_groups = self.rules.axis_group_size("batch")
        # the cache leaves held as "model" blocks (the rest rows only), and
        # the cache's axes and whole shapes, which place a snapshot
        self.blocks = (M.serving_blocks(cfg) if computes_on_blocks(cfg, self.rules, impl)
                       else set())
        self.cache_axes = M.cache_logical_axes(cfg, batch, max_seq)
        self.cache_shapes = {n: shp for n, shp in _spec_shapes(M.cache_specs(cfg, batch,
                                                                             max_seq))}
        self._served = (None, None)          # (the handle's tree, the tree computed on)
        # optional WeightSyncClient: wires the staleness gate into the
        # serving loop as ADMISSION CONTROL (admit() below) instead of a
        # mid-batch failure
        self.sync_client = sync_client
        # swap-safe weights: the engine serves ``param_handle.current`` and
        # commits a staged update (weight_sync's double buffer) only at
        # generation boundaries — a decode loop can never see a torn tree.
        self.batch = batch
        self.max_seq = max_seq
        self.impl = impl
        self.cache = None
        self.last_tokens = None
        self.last_logits = None

    @property
    def params(self):
        """The model decode is currently serving (read-only view)."""
        return self.param_handle.current

    def maybe_swap(self) -> bool:
        """Generation-boundary swap point: adopt a staged weight update, if
        any.  Called automatically at the entry of ``prefill``/``generate``;
        exposed so a serving loop can also swap between batches."""
        return self.param_handle.commit_pending()

    def admit(self) -> bool:
        """Admission gate for NEW generations: False while the attached
        ``WeightSyncClient`` is draining.  Always True without a sync
        client.  ``generate`` on already-admitted work never gates."""
        return self.sync_client is None or self.sync_client.admit()

    def _serving(self):
        """``serving_params`` of the handle's current tree, made once per
        tree (again after a swap)."""
        current = self.param_handle.current
        if self._served[0] is not current:
            tree = serving_params(self.cfg, current, self.rules, self.impl)
            if tree is not current:
                tree = M.LM(self.cfg, tree)
            self._served = (current, tree)
        return self._served[1]

    def whole_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Tokens (or logits) of this rank's rows gathered over the batch's
        ranks; ``x`` itself on a mesh of one rank."""
        shape = (self.batch,) + tuple(x.shape[1:])
        axes = ("batch",) + (None,) * (x.ndim - 1)
        return whole_tree({"x": x}, {"x": axes}, self.rules, {"x": shape})["x"]

    def prefill(self, prompts: dict) -> torch.Tensor:
        self.maybe_swap()
        tokens = prompts["tokens"]
        if tokens.shape[0] != self.batch or tokens.shape[1] > self.max_seq:
            raise ValueError(f"prompts {tuple(tokens.shape)} do not fit batch "
                             f"{self.batch} and max_seq {self.max_seq}")
        logits, self.cache = prefill_step(self.cfg, self.rules, self._serving(), prompts,
                                          self.max_seq, impl=self.impl)
        self.last_logits = logits
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        if self.cfg.num_codebooks and nxt.ndim == 1:
            nxt = nxt[:, None].expand(nxt.shape[0], self.cfg.num_codebooks).contiguous()
        self.last_tokens = nxt
        return self.last_tokens

    def generate(self, n: int, on_token=None) -> np.ndarray:
        self.maybe_swap()
        # captured ONCE: a weight push staged mid-loop waits for the next
        # boundary — all n tokens of this call come from one coherent tree
        params = self._serving()
        if int(self.cache["t"]) + n > self.max_seq:
            raise ValueError(f"{n} more tokens overflow the cache of {self.max_seq}")
        out = []
        for _ in range(n):
            logits, self.cache = decode_step(self.cfg, self.rules, params, self.last_tokens,
                                             self.cache, self.max_seq, self.batch,
                                             impl=self.impl)
            self.last_logits = logits
            self.last_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
            out.append(self.whole_rows(self.last_tokens).cpu().numpy())
            if on_token is not None:
                on_token(out[-1])
        return np.stack(out, axis=1)

    # --- C/R surface ---------------------------------------------------------
    def snapshot(self) -> dict:
        """The generation state, whole: the cache with the one-rank engine's
        paths, shapes and dtypes (gathered from every rank's blocks: every
        rank calls) and the last tokens of every row.  A leaf that no rank
        splits is the live cache's own tensor, which the next decode step
        writes in place: save or copy the snapshot before decoding on."""
        cache = whole_tree(self.cache, self.cache_axes, self.rules, self.cache_shapes,
                           self.blocks)
        return {"cache": cache, "last_tokens": self.whole_rows(self.last_tokens)}

    def restore(self, snap: dict) -> None:
        """Resume from a snapshot taken on any mesh: its whole cache cut to
        this engine's blocks and rows."""
        self.cache = cut_tree(snap["cache"], self.cache_axes, self.rules, self.blocks)
        tokens = snap["last_tokens"]
        self.last_tokens = cut_tree(
            {"x": tokens}, {"x": ("batch",) + (None,) * (tokens.ndim - 1)}, self.rules)["x"]


def _spec_shapes(specs, path=()):
    """(path, whole shape) of a ``models.model.cache_specs`` tree."""
    for k in sorted(specs):
        v = specs[k]
        if isinstance(v, dict):
            yield from _spec_shapes(v, path + (k,))
        else:
            yield "/".join(path + (k,)), tuple(v[0])
