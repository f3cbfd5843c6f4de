"""LM assembly for the dense plan: param specs, forward, prefill, decode.

Parameters keep the reference package's tree, names and layout
(``embed/table``, ``seg0/ln1/scale``, ``seg0/attn/wq/{w,b}``, ...), with the
layers of a segment stacked on a leading dimension, so checkpoints and tests
compare like with like.  :class:`LM` holds them as an ``nn.Module`` whose
parameter names are those paths with ``.`` for ``/``; the functions below
take an ``LM`` or the nested dict itself.  Caches mirror the segment
structure: ``{"seg0": {"k", "v"}: (L,B,S,Hkv,Dh), "t": int32 0-d}``.

Only the dense plan (``attn_dense`` layers) is ported so far; other families
raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch.checkpoint.serialization import to_torch
from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks as BL
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamSpec
from repro_torch.utils.tree import flatten_with_names, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str
    count: int


def layer_plan(cfg: ModelConfig) -> list[Segment]:
    if (cfg.mixer != "attn" or cfg.num_experts or cfg.num_codebooks
            or cfg.num_image_tokens or cfg.mtp_depth or cfg.shared_attn_period):
        raise NotImplementedError(
            f"{cfg.name}: only dense GQA decoders are ported so far")
    return [Segment("attn_dense", cfg.num_layers)]


# ----------------------------------------------------------------------------------
# Param specs and the module that holds the parameters
# ----------------------------------------------------------------------------------


def param_specs(cfg: ModelConfig) -> dict:
    D, V = cfg.d_model, cfg.vocab_size
    specs: dict[str, Any] = {"embed": L.embedding_spec(V, D)}
    for i, seg in enumerate(layer_plan(cfg)):
        specs[f"seg{i}"] = BL.stacked(BL.block_spec(cfg, seg.kind), seg.count)
    specs["final_norm"] = L.rms_norm_spec(D)
    if not cfg.tie_embeddings:
        specs["head"] = ParamSpec((D, V), ("embed", "vocab"), "normal")
    return specs


def count_params_analytic(cfg: ModelConfig) -> int:
    return sum(int(np.prod(s.shape)) for s in tree_leaves(param_specs(cfg)))


class LM(nn.Module):
    """The parameter tree of one model as an ``nn.Module``.  ``tree`` is the
    nested dict (the reference package's names) over the same tensors, and
    ``layers[i]`` the per-layer views of segment ``i``, made once."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__()
        self.cfg = cfg
        _register(self, tree)
        self.tree = _tree_of(self)
        self.layers = [
            [tree_map(lambda x, j=j: x[j], self.tree[f"seg{i}"]) for j in range(seg.count)]
            for i, seg in enumerate(layer_plan(cfg))]

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B,S) -> fp32 logits (B,S,V)."""
        h, _ = forward_full(self, self.cfg, {"tokens": tokens})
        return logits_fn(self, self.cfg, h)


def _register(module: nn.Module, tree: dict) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            child = nn.Module()
            _register(child, v)
            module.add_module(k, child)
        else:
            module.register_parameter(k, nn.Parameter(v, requires_grad=False))


def _tree_of(module: nn.Module) -> dict:
    out: dict = {}
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = p
    return out


def _tree(params) -> dict:
    return params.tree if isinstance(params, LM) else params


def _layers(params, i: int, count: int) -> list:
    if isinstance(params, LM):
        return params.layers[i]
    return [tree_map(lambda x, j=j: x[j], params[f"seg{i}"]) for j in range(count)]


def init_params(cfg: ModelConfig, seed: int, device) -> LM:
    """Random parameters from ``seed`` (per-leaf generators; see
    ``layers.materialize``), in ``cfg.param_dtype``, on ``device``."""
    tree = L.materialize(param_specs(cfg), seed, L.torch_dtype(cfg.param_dtype), device)
    return LM(cfg, tree)


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree as tensors on the ``meta`` device (no storage)."""
    return L.abstract_params(param_specs(cfg), L.torch_dtype(cfg.param_dtype))


def params_from_numpy(cfg: ModelConfig, tree: dict, device) -> LM:
    """The model whose parameters are ``tree`` (the reference package's
    ``init_params`` tree, or a restored checkpoint, as numpy arrays), on
    ``device``.  Names, shapes and dtypes must match ``param_specs(cfg)``."""
    want = {n: s.shape for n, s in flatten_with_names(param_specs(cfg))}
    got = {n: tuple(np.shape(a)) for n, a in flatten_with_names(tree)}
    if want != got:
        raise ValueError(f"{cfg.name}: parameter tree does not match the specs: "
                         f"missing {sorted(set(want) - set(got))}, "
                         f"unexpected {sorted(set(got) - set(want))}, "
                         f"shapes differ at {[n for n in want if n in got and want[n] != got[n]]}")
    return LM(cfg, tree_map(lambda a: to_torch(a, device), tree))


def params_tree(model: LM) -> dict:
    """The model's parameters as the reference package's nested dict."""
    return model.tree


# ----------------------------------------------------------------------------------
# Embedding / head
# ----------------------------------------------------------------------------------


def embed_inputs(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    return L.embed(_tree(params)["embed"], batch["tokens"], L.torch_dtype(cfg.compute_dtype))


def logits_fn(params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """h: (B,C,D) -> fp32 logits (B,C,V)."""
    tree = _tree(params)
    if cfg.tie_embeddings:
        return L.unembed(tree["embed"], h)
    return h.float() @ tree["head"].float()


# ----------------------------------------------------------------------------------
# Forward (full sequence), prefill, decode
# ----------------------------------------------------------------------------------


def forward_full(params, cfg: ModelConfig, batch: dict, *, want_cache=False, impl=None):
    """Returns (h_final, per-segment lists of per-layer cache entries | None)."""
    tree = _tree(params)
    h = embed_inputs(tree, cfg, batch)
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device)[None].expand(B, S)
    caches = []
    for i, seg in enumerate(layer_plan(cfg)):
        entries = []
        for p in _layers(params, i, seg.count):
            h, c = BL.block_full(seg.kind, p, cfg, h, positions, want_cache=want_cache,
                                 impl=impl)
            entries.append(c)
        caches.append(entries)
    h = L.rms_norm(tree["final_norm"], h, cfg.norm_eps)
    return h, (caches if want_cache else None)


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """{path: (shape, dtype string)} of the cache tree, as nested dicts."""
    specs: dict[str, Any] = {}
    for i, seg in enumerate(layer_plan(cfg)):
        entry = BL.cache_entry_spec(cfg, seg.kind, batch, max_seq)
        specs[f"seg{i}"] = {k: ((seg.count,) + shp, dt) for k, (shp, dt) in entry.items()}
    specs["t"] = ((), "int32")
    return specs


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device) -> dict:
    out: dict[str, Any] = {}
    for name, spec in cache_specs(cfg, batch, max_seq).items():
        if name == "t":
            out["t"] = torch.zeros((), dtype=torch.int32, device=device)
        else:
            out[name] = {k: torch.zeros(shp, dtype=L.torch_dtype(dt), device=device)
                         for k, (shp, dt) in spec.items()}
    return out


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, tokens_new: torch.Tensor, cache: dict, *,
                impl=None):
    """tokens_new: (B,) int.  Returns (fp32 logits (B,V), new cache).

    The new cache holds the SAME k/v tensors as ``cache``, updated in place at
    position ``cache["t"]``, and a new ``t``; the old ``t`` is left as it was."""
    tree = _tree(params)
    t = cache["t"]
    h = embed_inputs(tree, cfg, {"tokens": tokens_new[:, None]})
    new_cache: dict[str, Any] = {}
    for i, seg in enumerate(layer_plan(cfg)):
        seg_c = cache[f"seg{i}"]
        for j, p in enumerate(_layers(params, i, seg.count)):
            cj = {k: x[j] for k, x in seg_c.items()}
            h, _ = BL.block_decode(seg.kind, p, cfg, h, cj, t, impl=impl)
        new_cache[f"seg{i}"] = seg_c
    h = L.rms_norm(tree["final_norm"], h, cfg.norm_eps)
    logits = logits_fn(tree, cfg, h)[:, 0]
    new_cache["t"] = t + 1
    return logits, new_cache


@torch.no_grad()
def prefill(params, cfg: ModelConfig, batch: dict, max_seq: int, *, impl=None):
    """Full-sequence prefill; returns (last-position logits, cache of len max_seq)."""
    tokens = batch["tokens"]
    B, S = tokens.shape[:2]
    h, caches = forward_full(params, cfg, batch, want_cache=True, impl=impl)
    full = init_cache(cfg, B, max_seq, tokens.device)
    for i, entries in enumerate(caches):
        for j, entry in enumerate(entries):
            for k, x in entry.items():
                full[f"seg{i}"][k][j, :, :S] = x
    full["t"] = torch.tensor(S, dtype=torch.int32, device=tokens.device)
    logits = logits_fn(params, cfg, h[:, -1:])[:, 0]   # h already final-normed
    return logits, full
