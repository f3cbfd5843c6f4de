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
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.parallel.context import use_mesh_context
from repro_torch.parallel.mesh_rules import Rules
from repro_torch.serve.weight_sync import ParamHandle
from repro_torch.utils.tree import flatten_with_names


def _device_of(params) -> torch.device:
    tree = params.tree if isinstance(params, M.LM) else params
    return next(x for _, x in flatten_with_names(tree)).device


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
        self.moe_groups = self.rules.axis_group_size("batch")
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

    def prefill(self, prompts: dict) -> torch.Tensor:
        self.maybe_swap()
        tokens = prompts["tokens"]
        if tokens.shape[0] != self.batch or tokens.shape[1] > self.max_seq:
            raise ValueError(f"prompts {tuple(tokens.shape)} do not fit batch "
                             f"{self.batch} and max_seq {self.max_seq}")
        with use_mesh_context(self.mesh, self.rules):
            logits, self.cache = M.prefill(self.param_handle.current, self.cfg, prompts,
                                           self.max_seq, impl=self.impl,
                                           moe_groups=self.moe_groups)
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
        params = self.param_handle.current
        if int(self.cache["t"]) + n > self.max_seq:
            raise ValueError(f"{n} more tokens overflow the cache of {self.max_seq}")
        out = []
        for _ in range(n):
            with use_mesh_context(self.mesh, self.rules):
                logits, self.cache = M.decode_step(params, self.cfg, self.last_tokens,
                                                   self.cache, impl=self.impl)
            self.last_logits = logits
            self.last_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
            out.append(self.last_tokens.cpu().numpy())
            if on_token is not None:
                on_token(out[-1])
        return np.stack(out, axis=1)

    # --- C/R surface ---------------------------------------------------------
    def snapshot(self) -> dict:
        return {"cache": self.cache, "last_tokens": self.last_tokens}

    def restore(self, snap: dict) -> None:
        self.cache = snap["cache"]
        self.last_tokens = snap["last_tokens"]
