"""LM assembly: param specs, forward, prefill, decode.

Parameters keep the reference package's tree, names and layout
(``embed/table``, ``seg0/ln1/scale``, ``seg0/attn/wq/{w,b}``, ...), with the
layers of a segment stacked on a leading dimension, so checkpoints and tests
compare like with like.  :class:`LM` holds them as an ``nn.Module`` whose
parameter names are those paths with ``.`` for ``/``; the functions below
take an ``LM`` or the nested dict itself.  Caches mirror the segment
structure with the reference's paths, shapes and dtypes (``cache_specs``):
``{"seg0": {"k", "v"}: (L,B,S,Hkv,Dh), "t": int32 0-d}`` for the dense plan,
nested entries for zamba2's groups (``{"mamba": {"conv", "ssm"}, "shared_k",
"shared_v"}``) and fp32 recurrent states for the SSM families.

Every plan of the reference serves: dense and MoE GQA decoders, MLA with
dense and MoE FFNs (DeepSeek's first dense layers become a segment of
their own), mamba2 with zamba2's shared-attention groups, rwkv6, and the
codebook (musicgen) and image-token (llava) inputs; MLA's cache is
``{"ckv": (L,B,S,kv_lora_rank + rope)}``.  Serving over a mesh whose
"model" axis has several ranks computes under ``tp.computing_on_blocks``
(``serve/engine.py``): the attention caches and the SSM states
(``serving_blocks``) are then this rank's blocks of the rules (its kv heads
or its block of positions, its SSM heads), and ``prefill`` / ``decode_step`` return the
logits made whole over the vocabulary.  Every plan trains: ``loss_fn`` is
the reference's (the MoE aux loss, the MTP head's loss, the codebooks' mean
cross entropy, the image-token mask), differentiated with autograd over a
plain dict of tensors (``train/step.py``).  The reference's layer remat
(``jax.checkpoint``) only saves memory and is left out.
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
from repro_torch.parallel import tp
from repro_torch.parallel.collectives import group_sum
from repro_torch.parallel.context import current_rules
from repro_torch.parallel.mesh_rules import named_axes
from repro_torch.utils.tree import (flatten_with_names, tree_leaves, tree_map,
                                    unflatten_like)


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str
    count: int


def layer_plan(cfg: ModelConfig) -> list[Segment]:
    if cfg.mixer == "rwkv6":
        return [Segment("rwkv6", cfg.num_layers)]
    if cfg.mixer == "mamba2":
        if cfg.shared_attn_period:
            inner = cfg.shared_attn_period
            groups = cfg.num_layers // inner
            tail = cfg.num_layers - groups * inner
            plan = [Segment("zamba_group", groups)]
            if tail:
                plan.append(Segment("mamba2", tail))
            return plan
        return [Segment("mamba2", cfg.num_layers)]
    base = "mla" if cfg.mixer == "mla" else "attn"
    if cfg.num_experts:
        plan = []
        if cfg.first_dense_layers:
            plan.append(Segment(f"{base}_dense", cfg.first_dense_layers))
        plan.append(Segment(f"{base}_moe", cfg.num_layers - cfg.first_dense_layers))
        return plan
    return [Segment(f"{base}_dense", cfg.num_layers)]


# ----------------------------------------------------------------------------------
# Param specs and the module that holds the parameters
# ----------------------------------------------------------------------------------


def param_specs(cfg: ModelConfig) -> dict:
    D, V = cfg.d_model, cfg.vocab_size
    specs: dict[str, Any] = {}
    if cfg.num_codebooks:
        specs["embed"] = {"table": ParamSpec((cfg.num_codebooks, V, D),
                                             (None, "vocab", "embed"), "embed")}
    else:
        specs["embed"] = L.embedding_spec(V, D)
    if cfg.mixer == "rwkv6":
        specs["ln0"] = L.rms_norm_spec(D)
    for i, seg in enumerate(layer_plan(cfg)):
        specs[f"seg{i}"] = BL.stacked(BL.block_spec(cfg, seg.kind), seg.count)
    if cfg.shared_attn_period:
        specs["shared_attn"] = BL.shared_attn_spec(cfg)
    specs["final_norm"] = L.rms_norm_spec(D)
    if not cfg.tie_embeddings:
        if cfg.num_codebooks:
            specs["head"] = ParamSpec((cfg.num_codebooks, D, V), (None, "embed", "vocab"),
                                      "normal")
        else:
            specs["head"] = ParamSpec((D, V), ("embed", "vocab"), "normal")
    if cfg.mtp_depth:
        specs["mtp"] = {
            "proj": L.linear_spec(2 * D, D, "embed", "embed"),
            "block": BL.block_spec(cfg, "mla_dense" if cfg.mixer == "mla" else "attn_dense"),
            "norm": L.rms_norm_spec(D),
        }
    return specs


def count_params_analytic(cfg: ModelConfig) -> int:
    return sum(int(np.prod(s.shape)) for s in tree_leaves(param_specs(cfg)))


def count_active_params(cfg: ModelConfig) -> int:
    """Per-token active params (MoE: top-k + shared experts only)."""
    total = count_params_analytic(cfg)
    if not cfg.num_experts:
        return total
    D, F, E, K = cfg.d_model, cfg.moe_d_ff, cfg.num_experts, cfg.num_experts_per_tok
    moe_layers = cfg.num_layers - cfg.first_dense_layers
    per_expert = 3 * D * F
    return total - moe_layers * E * per_expert + moe_layers * K * per_expert


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
        h, _, _ = forward_full(self, self.cfg, {"tokens": tokens})
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
    """Per-layer views of segment ``i``.  A segment given as a list is
    already per layer (``train/step.py``'s leaves, one per layer).  For a
    plain dict each stacked leaf is unbound once, so under autograd its
    gradient is assembled by one stack, not by ``count`` full-size scatters."""
    if isinstance(params, LM):
        return params.layers[i]
    seg = params[f"seg{i}"]
    if isinstance(seg, list):
        return seg
    per_leaf = {n: x.unbind(0) for n, x in flatten_with_names(seg)}
    return [unflatten_like(seg, {n: xs[j] for n, xs in per_leaf.items()})
            for j in range(count)]


def init_params(cfg: ModelConfig, seed: int, device) -> LM:
    """Random parameters from ``seed`` (per-leaf generators; see
    ``layers.materialize``), in ``cfg.param_dtype``, on ``device``."""
    tree = L.materialize(param_specs(cfg), seed, L.torch_dtype(cfg.param_dtype), device)
    return LM(cfg, tree)


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree as tensors on the ``meta`` device (no storage)."""
    return L.abstract_params(param_specs(cfg), L.torch_dtype(cfg.param_dtype))


def param_logical_axes(cfg: ModelConfig) -> dict:
    return L.logical_axes(param_specs(cfg))


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
    """tokens (B,S), or (B,S,K) with codebooks (the K embeddings summed), ->
    (B,S,D); with image tokens and ``image_embeds`` (B,n,D) in the batch, those
    take the first n positions."""
    tree = _tree(params)
    dt = L.torch_dtype(cfg.compute_dtype)
    tokens = batch["tokens"]
    if cfg.num_codebooks:
        tabs = tree["embed"]["table"]                       # (K,V,D)
        h = torch.zeros(tokens.shape[:2] + (cfg.d_model,), dtype=dt, device=tokens.device)
        for k in range(cfg.num_codebooks):
            h = h + L.embed({"table": tabs[k]}, tokens[..., k], dt)
    else:
        h = L.embed(tree["embed"], tokens, dt, _vocab_spec(cfg, "embed"))
    if cfg.num_image_tokens and "image_embeds" in batch:
        n = cfg.num_image_tokens
        h = torch.cat([batch["image_embeds"].to(dt), h[:, n:]], dim=1)
    if cfg.mixer == "rwkv6":
        h = L.rms_norm(tree["ln0"], h, cfg.norm_eps)
    return h


def logits_fn(params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """h: (B,C,D) -> fp32 logits (B,C,V), or (B,C,K,V) with codebooks."""
    tree = _tree(params)
    if cfg.num_codebooks:
        if cfg.tie_embeddings:
            return torch.einsum("bcd,kvd->bckv", h.float(), tree["embed"]["table"].float())
        return torch.einsum("bcd,kdv->bckv", h.float(), tree["head"].float())
    if cfg.tie_embeddings:
        return L.unembed(tree["embed"], h, _vocab_spec(cfg, "embed"))
    if _logits_start(params, cfg) is not None:          # this rank's vocab block
        tp.COUNTS["block_products"] += 1
        h = tp.copy_to_model(h)
    return h.float() @ tree["head"].float()


def _vocab_spec(cfg: ModelConfig, name: str):
    """The ``ParamSpec`` of the embedding's table (``name`` "embed") or of
    the head, which ``tp.vocab_start`` holds the leaf to, where the step
    computes on "model" blocks (``tp.on_blocks``) and there are no
    codebooks; else ``None``: the leaf is read whole."""
    if cfg.num_codebooks or not tp.on_blocks():
        return None
    spec = param_specs(cfg)[name]
    return spec["table"] if name == "embed" else spec


def _logits_start(params, cfg: ModelConfig):
    """The first vocabulary entry of this rank's block of the logits where
    the head (or the tied table) is read as a "model" block, else ``None``."""
    name = "embed" if cfg.tie_embeddings else "head"
    spec = _vocab_spec(cfg, name)
    if spec is None:
        return None
    tree = _tree(params)
    return tp.vocab_start(tree["embed"]["table"] if name == "embed" else tree["head"], spec)


def tp_leaves(cfg: ModelConfig) -> set:
    """The leaves that the tensor-parallel modules read as this rank's
    "model" block (``train/step.py`` gathers them over their other mesh axes
    only, and computes under ``tp.computing_on_blocks``): the embedding and
    the head without codebooks, the attention (GQA or MLA) of the stacked
    segments, their FFNs (the dense SwiGLU, or the MoE layer: its experts'
    ``moe_d_ff``, DeepSeek's shared expert; the router has no "model" dim),
    the MTP block's attention and SwiGLU, zamba2's shared block's, Mamba2's
    ``out_proj`` (in a zamba group or a segment of its own), and RWKV6's
    time-mix ``wr``, ``wk``, ``wv``, ``wg``, ``wo`` and channel-mix ``wk``,
    ``wv``.  Those modules hold each weight to its spec through
    ``tp.block_dim`` (``tp.vocab_start``, ``ep.expert_block``): the whole
    leaf where the rules do not split it over "model", else this rank's
    block.  The experts of ``ep_leaves`` are also this rank's block over
    their expert axes.  Every other leaf (codebooks, norms, Mamba2's fused
    ``in_proj`` and conv, whose rules' blocks are not a rank's heads, the
    RWKV6 LoRAs and decay) is read whole; the SSM mixers slice the parts of
    their heads from it (``tp.own_part``)."""
    prefixes = []
    if not cfg.num_codebooks:
        prefixes += ["embed/", "head"]
    for i, seg in enumerate(layer_plan(cfg)):
        if seg.kind in BL.ATTN_KINDS:
            prefixes += [f"seg{i}/attn/", f"seg{i}/ffn/"]
        elif seg.kind in ("mamba2", "zamba_group"):
            prefixes.append(f"seg{i}/{'mamba/' if seg.kind == 'zamba_group' else ''}"
                            "mixer/out_proj/")
        elif seg.kind == "rwkv6":
            prefixes += [f"seg{i}/tmix/{n}/" for n in ("wr", "wk", "wv", "wg", "wo")]
            prefixes += [f"seg{i}/cmix/{n}/" for n in ("wk", "wv")]
    if cfg.shared_attn_period:
        prefixes += ["shared_attn/attn/", "shared_attn/ffn/"]
    if cfg.mtp_depth:
        prefixes += ["mtp/block/attn/", "mtp/block/ffn/"]
    return {n for n, _ in flatten_with_names(param_specs(cfg)) if n.startswith(tuple(prefixes))}


def ep_leaves(cfg: ModelConfig) -> set:
    """The experts' leaves of the MoE segments (``wi_gate``, ``wi_up``,
    ``wo``), which the MoE layer reads as this rank's block over the axes
    the rules give "expert" (``parallel/ep.py``) as well as over "model"."""
    return {f"seg{i}/ffn/{k}" for i, seg in enumerate(layer_plan(cfg))
            if seg.kind.endswith("moe") for k in ("wi_gate", "wi_up", "wo")}


# ----------------------------------------------------------------------------------
# Forward (full sequence), prefill, decode
# ----------------------------------------------------------------------------------


def forward_full(params, cfg: ModelConfig, batch: dict, *, want_cache=False,
                 moe_groups=16, impl=None, batch_group=None):
    """Returns (h_final, per-segment lists of per-layer cache entries | None,
    the MoE aux loss summed over the layers; ``batch_group``: see
    ``loss_fn``)."""
    tree = _tree(params)
    h = embed_inputs(tree, cfg, batch)
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device)[None].expand(B, S)
    emb0 = h if cfg.shared_attn_period else None
    shared_p = tree.get("shared_attn")
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    caches = []
    for i, seg in enumerate(layer_plan(cfg)):
        entries = []
        for p in _layers(params, i, seg.count):
            h, c, a = BL.block_full(seg.kind, p, cfg, h, positions, moe_groups=moe_groups,
                                    want_cache=want_cache, emb0=emb0, shared_p=shared_p,
                                    impl=impl, batch_group=batch_group)
            if a is not None:
                aux = aux + a
            entries.append(c)
        caches.append(entries)
    h = L.rms_norm(tree["final_norm"], h, cfg.norm_eps)
    return h, (caches if want_cache else None), aux


# ----------------------------------------------------------------------------------
# Loss (chunked over the sequence, as the reference's, so fp32 logits exist for
# one chunk at a time)
# ----------------------------------------------------------------------------------


def _ce_from_logits(logits, labels, mask, start=None):
    """(ce_sum, z_sum); ``tp.vocab_parallel_ce`` where ``logits`` are this
    rank's block of the vocabulary, from entry ``start`` (``_logits_start``)."""
    if start is not None:
        return tp.vocab_parallel_ce(logits, labels, mask, start)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    ce = (lse - gold) * mask
    zl = torch.square(lse) * mask
    return torch.sum(ce), torch.sum(zl)


def _chunk_ce(params, cfg: ModelConfig, h, labels, mask):
    """(ce_sum, z_sum) of one chunk; with codebooks, the mean of the K
    codebooks' sums (labels (B,C,K))."""
    logits = logits_fn(params, cfg, h)
    if not cfg.num_codebooks:
        return _ce_from_logits(logits, labels, mask, _logits_start(params, cfg))
    ce = z = 0.0
    for k in range(cfg.num_codebooks):
        c, zk = _ce_from_logits(logits[:, :, k], labels[..., k], mask)
        ce, z = ce + c, z + zk
    return ce / cfg.num_codebooks, z / cfg.num_codebooks


def chunked_ce(params, cfg: ModelConfig, h, labels, mask, chunk: int = 1024):
    """h: (B,S,D); labels: (B,S) or (B,S,K); mask: (B,S) fp32.  Returns
    (ce_sum, z_sum, n).

    The reference recomputes each chunk's logits in its backward
    (``jax.checkpoint``); here autograd keeps them, which at the port's
    training shapes (one chunk of B x 128 rows) costs less than the
    recompute would."""
    B, S, _ = h.shape
    chunk = min(chunk, S)
    while S % chunk:
        chunk -= 1
    ce_s = torch.zeros((), dtype=torch.float32, device=h.device)
    z_s = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        ce, z = _chunk_ce(params, cfg, h[:, sl], labels[:, sl], mask[:, sl])
        ce_s, z_s = ce_s + ce, z_s + z
    return ce_s, z_s, torch.clamp(torch.sum(mask), min=1.0)


def _shift_labels(cfg: ModelConfig, batch: dict):
    """Next-token labels and their mask: the last position has no label; an
    image-token model scores no position before its last image token."""
    tokens = batch["tokens"]
    labels = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
    B, S = tokens.shape[:2]
    mask = torch.ones((B, S), dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    if "loss_mask" in batch:
        mask = mask * batch["loss_mask"].float()
    if cfg.num_image_tokens:
        pos_ok = torch.arange(S, device=tokens.device) >= max(cfg.num_image_tokens - 1, 0)
        mask = mask * pos_ok[None].float()
    return labels, mask


def _mtp_ce(params, cfg: ModelConfig, h, tokens, mask, impl, batch_group=None):
    """The MTP head's (ce_sum, n): position t predicts token t + 2 from the
    final hidden state at t and the embedding of token t + 1, through
    ``mtp/proj``, one dense block and ``mtp/norm``, scored by the head."""
    tree = _tree(params)
    mtp = tree["mtp"]
    dt = L.torch_dtype(cfg.compute_dtype)
    emb_next = L.embed(tree["embed"], tokens, dt, _vocab_spec(cfg, "embed"))
    x = L.linear(mtp["proj"], torch.cat([h[:, :-1], emb_next[:, 1:]], dim=-1), dt)
    B, S1, _ = x.shape
    pos = torch.arange(S1, device=x.device)[None].expand(B, S1)
    kind = "mla_dense" if cfg.mixer == "mla" else "attn_dense"
    x, _, _ = BL.block_full(kind, mtp["block"], cfg, x, pos, impl=impl)
    x = L.rms_norm(mtp["norm"], x, cfg.norm_eps)
    labels = torch.cat([tokens[:, 2:], tokens[:, -2:]], dim=1)[:, :S1]
    mtp_mask = torch.ones((B, S1), dtype=torch.float32, device=x.device)
    mtp_mask[:, -2:] = 0.0
    mtp_mask = mtp_mask * mask[:, :S1]
    ce, _, n = chunked_ce(tree, cfg, x, labels, mtp_mask)
    return ce, _tokens(mtp_mask, n, batch_group)


def _tokens(mask, n, batch_group):
    """The scored tokens of the whole batch: ``n`` (``chunked_ce``'s count of
    this rank's) where it holds all of it, else the ranks' counts summed."""
    if batch_group is None:
        return n
    return torch.clamp(group_sum(torch.sum(mask), batch_group), min=1.0)


def loss_fn(params, cfg: ModelConfig, batch: dict, *, moe_groups=16, impl=None,
            z_loss: float = 1e-4, batch_group=None):
    """The reference's ``loss_fn``: next-token cross entropy (the K
    codebooks' mean with codebooks; no position before the last image
    token scored) plus ``z_loss`` x mean(logsumexp^2), the MoE aux loss
    summed over the layers, and, with an MTP head and no codebooks, 0.3 x
    the MTP head's cross entropy.  ``moe_groups`` sets the routing groups
    (and with them each expert's capacity); the train step passes 1, as the
    reference's does on one device.  Returns (loss, {"ce", "aux", "tokens"}
    and "mtp_ce" with an MTP head).

    ``batch_group``: the process group of the ranks that hold the other
    slices of the batch (``None``: this rank holds all of it).  Then the
    sums are over this rank's rows but the token counts over the whole
    batch's, so the loss and every metric but ``tokens`` is this rank's
    share: the shares sum over the group to the whole batch's value, and so
    do their gradients."""
    h, _, aux = forward_full(params, cfg, batch, moe_groups=moe_groups, impl=impl,
                             batch_group=batch_group)
    labels, mask = _shift_labels(cfg, batch)
    ce, z, n = chunked_ce(params, cfg, h, labels, mask)
    n = _tokens(mask, n, batch_group)
    loss = ce / n + z_loss * z / n + aux
    metrics = {"ce": ce / n, "aux": aux, "tokens": n}
    if cfg.mtp_depth and not cfg.num_codebooks:
        ce2, n2 = _mtp_ce(params, cfg, h, batch["tokens"], mask, impl, batch_group)
        loss = loss + 0.3 * ce2 / n2
        metrics["mtp_ce"] = ce2 / n2
    return loss, metrics


def _cache_entries(cfg: ModelConfig, batch: int, max_seq: int, part) -> dict:
    """The cache tree, each leaf ``part((shape, dtype, axes))`` of its
    ``blocks.cache_entry_spec`` entry stacked on a leading layer dimension,
    and ``t``."""
    def expand(entry, count):
        return {k: expand(v, count) if isinstance(v, dict)
                else part(((count,) + v[0], v[1], ("layers",) + v[2]))
                for k, v in entry.items()}

    out: dict[str, Any] = {}
    for i, seg in enumerate(layer_plan(cfg)):
        out[f"seg{i}"] = expand(BL.cache_entry_spec(cfg, seg.kind, batch, max_seq), seg.count)
    out["t"] = part(((), "int32", ()))
    return out


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """The cache tree's {name: (shape, dtype string)} leaves, as nested dicts
    with the reference's paths: each segment's entry stacked on a leading
    layer dimension, and ``t``."""
    return _cache_entries(cfg, batch, max_seq, lambda e: e[:2])


def cache_logical_axes(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """The cache tree's logical axes (the second tree the reference's
    ``cache_specs`` returns)."""
    return _cache_entries(cfg, batch, max_seq, lambda e: e[2])


def serving_blocks(cfg: ModelConfig) -> set:
    """The cache leaves that serving over "model" blocks holds as this
    rank's block of the rules' layout: each attention segment's ``k`` and
    ``v`` (GQA) or ``ckv`` (MLA) and zamba2's ``shared_k`` and ``shared_v``
    (``kv_heads_dim``, else ``cache_seq``, on "model"), and the SSM states
    ``ssm`` (Mamba2's, in a zamba group or not) and ``wkv`` (RWKV6's) on
    ``ssm_heads_dim``, whose mixers compute on this rank's heads where the
    rules split them.  Every other leaf (``t``, Mamba2's conv window, whose
    rules' block of ``ssm_inner`` channels is not a rank's heads, RWKV6's
    token-shift rows) is whole over "model"; a rank holds its rows of it.
    The MoE layers keep no cache: their experts compute on blocks
    (``tp_leaves``, ``ep_leaves``) on every rank's rows, routed as one
    group."""
    names = {"attn_dense": ("k", "v"), "attn_moe": ("k", "v"), "mla_dense": ("ckv",),
             "mla_moe": ("ckv",), "mamba2": ("ssm",), "rwkv6": ("wkv",),
             "zamba_group": ("mamba/ssm", "shared_k", "shared_v")}
    return {f"seg{i}/{n}" for i, seg in enumerate(layer_plan(cfg)) for n in names[seg.kind]}


# the leaves of a segment's cache entry indexed by position
_POSITIONS = ("k", "v", "ckv", "shared_k", "shared_v")


def _seq_lens(cfg: ModelConfig, max_seq) -> dict:
    """{segment index: ``max_seq``} for each segment whose attention cache
    (zamba2's shared block's in a zamba group) the ambient rules split over
    "model" by position (``cache_seq``), where the step computes on blocks;
    empty otherwise."""
    rules = current_rules()
    if not tp.on_blocks() or rules is None:
        return {}
    if max_seq is None:
        raise ValueError("a decode step on 'model' blocks needs the whole cache's max_seq")
    out = {}
    for i, seg in enumerate(layer_plan(cfg)):
        entry = BL.cache_entry_spec(cfg, seg.kind, 1, max_seq)
        keys = [k for k in _POSITIONS if k in entry]
        if keys:
            shape, _, axes = entry[keys[0]]
            if tp.block_dims(axes, shape) == [1]:
                out[i] = max_seq
    return out


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device) -> dict:
    """A cache of zeros.  Under ``tp.computing_on_blocks`` each leaf of
    ``serving_blocks`` is this rank's "model" block of it (``batch``: this
    rank's rows)."""
    blocks = serving_blocks(cfg) if tp.on_blocks() else set()
    axes = dict(named_axes(cache_logical_axes(cfg, batch, max_seq)))

    def make(spec, path):
        if isinstance(spec, dict):
            return {k: make(v, path + (k,)) for k, v in spec.items()}
        name, shape = "/".join(path), spec[0]
        if name in blocks:
            shape = tp.block_shape(axes[name], shape)
        return torch.zeros(shape, dtype=L.torch_dtype(spec[1]), device=device)

    return make(cache_specs(cfg, batch, max_seq), ())


def _whole_logits(params, cfg: ModelConfig, h):
    """``logits_fn``, made whole over the vocabulary where the head is read
    as a "model" block (serving's argmax reads every entry)."""
    logits = logits_fn(params, cfg, h)
    return logits if _logits_start(params, cfg) is None else tp.gather_logits(logits)


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, tokens_new: torch.Tensor, cache: dict, *,
                impl=None, max_seq=None, row_axes=()):
    """tokens_new: (B,) or (B,K) int.  Returns (fp32 logits (B,V) or (B,K,V),
    new cache).  ``row_axes``: the mesh axes of the ambient rules that split
    the whole batch's rows, of which these are this rank's (() where they
    are all of them): a MoE layer routes the whole batch as one group.

    The new cache holds the SAME tensors as ``cache``, updated in place (the
    attention caches at position ``cache["t"]``, the recurrent states by
    copy), and a new ``t``; the old ``t`` is left as it was.  Under
    ``tp.computing_on_blocks`` the ``serving_blocks`` leaves of ``cache``
    are this rank's blocks of a cache of ``max_seq`` positions."""
    tree = _tree(params)
    t = cache["t"]
    seq_lens = _seq_lens(cfg, max_seq)
    h = embed_inputs(tree, cfg, {"tokens": tokens_new[:, None]})
    emb0 = h if cfg.shared_attn_period else None
    shared_p = tree.get("shared_attn")
    new_cache: dict[str, Any] = {}
    for i, seg in enumerate(layer_plan(cfg)):
        seg_c = cache[f"seg{i}"]
        for j, p in enumerate(_layers(params, i, seg.count)):
            h, _ = BL.block_decode(seg.kind, p, cfg, h, tree_map(lambda x, j=j: x[j], seg_c),
                                   t, emb0=emb0, shared_p=shared_p, impl=impl,
                                   seq_len=seq_lens.get(i), row_axes=row_axes)
        new_cache[f"seg{i}"] = seg_c
    h = L.rms_norm(tree["final_norm"], h, cfg.norm_eps)
    logits = _whole_logits(tree, cfg, h)[:, 0]
    new_cache["t"] = t + 1
    return logits, new_cache


def _place(dst: torch.Tensor, src: torch.Tensor) -> None:
    """The reference's ``place`` rule: an entry of the cache's own shape is
    copied whole; a sequence-indexed one goes into the leading [0:S]."""
    dst[tuple(slice(0, n) for n in src.shape)].copy_(src)


@torch.no_grad()
def prefill(params, cfg: ModelConfig, batch: dict, max_seq: int, *, impl=None,
            moe_groups=16):
    """Full-sequence prefill; returns (last-position logits, cache of len
    max_seq).  Under ``tp.computing_on_blocks`` the cache is this rank's
    blocks (``init_cache``): its kv heads, which ``gqa_full`` computed, or
    its block of positions of every head."""
    tokens = batch["tokens"]
    B, S = tokens.shape[:2]
    h, caches, _ = forward_full(params, cfg, batch, want_cache=True, moe_groups=moe_groups,
                                impl=impl)
    full = init_cache(cfg, B, max_seq, tokens.device)
    seq_lens = _seq_lens(cfg, max_seq)
    for i, entries in enumerate(caches):
        for j, entry in enumerate(entries):
            if i in seq_lens:                       # this rank's block of positions
                start, n = tp.seq_block(max_seq)
                entry = {k: x[:, start:start + n] if k in _POSITIONS else x
                         for k, x in entry.items()}
            tree_map(lambda dst, src, j=j: _place(dst[j], src), full[f"seg{i}"], entry)
    full["t"] = torch.tensor(S, dtype=torch.int32, device=tokens.device)
    logits = _whole_logits(params, cfg, h[:, -1:])[:, 0]   # h already final-normed
    return logits, full
