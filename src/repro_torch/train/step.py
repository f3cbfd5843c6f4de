"""Train step: microbatched (gradient accumulation in float32), one device.

The state is a plain dict ``{params, opt{m,v}, step}`` with the reference's
tree and names (``repro/train/step.py``), so the checkpoint plane saves it
as it saves the reference's.  ``make_train_step`` returns a function
``step(state, batch) -> (state, metrics)`` that differentiates
``models.model.loss_fn`` with autograd and updates the params and moments
in place (``optim.adamw.apply_updates``); ``step`` is a new 0-d tensor.
The reference's logical-axis shardings are not ported: the port trains on
one card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.utils.tree import flatten_with_names, tree_map, unflatten_like


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
                   z_loss: float = 1e-4):
    """(loss, metrics, grads) of ``loss_fn`` at ``params``; grads is a tree
    like ``params``.  The params are read, never written."""
    named = flatten_with_names(params)
    leaves = [p.detach().requires_grad_(True) for _, p in named]
    tree = unflatten_like(params, {n: x for (n, _), x in zip(named, leaves)})
    with torch.enable_grad():
        loss, metrics = M.loss_fn(tree, cfg, batch, impl=impl, z_loss=z_loss)
        grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten_like(params, {n: g for (n, _), g in zip(named, grads)}))


def make_train_step(cfg: ModelConfig, oc: adamw.OptConfig, *, microbatches: int = 1,
                    impl: Optional[str] = None, z_loss: float = 1e-4):
    """Raises ``NotImplementedError`` for a config whose loss is not ported
    yet (``models.model.require_trainable``), before any state is drawn."""
    M.require_trainable(cfg)

    def train_step(state: dict, batch: dict):
        params = state["params"]
        B = batch["tokens"].shape[0]
        mb_count = effective_microbatches(B, microbatches, 1)
        if mb_count == 1:
            loss, metrics, grads = loss_and_grads(params, cfg, batch, impl=impl,
                                                  z_loss=z_loss)
        else:
            gsum = lsum = ce = None
            for i in range(mb_count):
                mb = {k: x[i * (B // mb_count):(i + 1) * (B // mb_count)]
                      for k, x in batch.items()}
                l, mets, g = loss_and_grads(params, cfg, mb, impl=impl, z_loss=z_loss)
                if gsum is None:
                    gsum = tree_map(lambda x: x.float(), g)
                    lsum, ce = l, mets["ce"]
                else:
                    gsum = tree_map(lambda a, b: a + b.float(), gsum, g)
                    lsum, ce = lsum + l, ce + mets["ce"]
            grads = tree_map(lambda g: g / mb_count, gsum)
            loss = lsum / mb_count
            metrics = {"ce": ce / mb_count}
        _, _, om = adamw.apply_updates(params, grads, state["opt"], state["step"], oc)
        new_state = {"params": params, "opt": state["opt"], "step": state["step"] + 1}
        return new_state, {"loss": loss, "ce": metrics.get("ce", loss), **om}

    return train_step
