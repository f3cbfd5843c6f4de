"""Per-layer blocks: spec + full-sequence + decode application, per block kind.

Kinds, as in ``repro/models/blocks.py``:
  attn_dense  pre-LN GQA attention + pre-LN SwiGLU
  attn_moe    pre-LN GQA attention + pre-LN MoE FFN
  mla_dense   pre-LN MLA attention + pre-LN SwiGLU
  mla_moe     pre-LN MLA attention + pre-LN MoE FFN (DeepSeek)
  mamba2      pre-LN Mamba2 mixer (no separate FFN)
  rwkv6       RWKV6 time-mix + channel-mix (LN-per-submodule)
  zamba_group ``inner`` Mamba2 layers + one shared-attention invocation

``block_full`` returns the layer's MoE aux loss (None for a layer without
MoE) beside its cache entry.
Decode updates a layer's cache entry in place (the attention caches at the
device ``t``, the SSM states by copy) and returns it.  Serving over "model"
blocks passes the attention kinds' entries, zamba2's shared block's among
them, as this rank's blocks (the rules' ``kv_heads_dim`` or ``cache_seq``;
``seq_len`` says the latter), and the SSM states ``ssm`` and ``wkv`` as this
rank's heads (``ssm_heads_dim``) where the mixers compute on them; the
Mamba2 conv window and RWKV6's token-shift rows stay whole over "model".
zamba2's ``shared_in`` is then column-parallel over "model" (``_shared_in``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv as R
from repro_torch.models import ssm as S
from repro_torch.parallel import tp
from repro_torch.utils.tree import tree_map

ATTN_KINDS = ("attn_dense", "attn_moe", "mla_dense", "mla_moe")


def block_spec(cfg: ModelConfig, kind: str) -> dict:
    D = cfg.d_model
    if kind in ATTN_KINDS:
        return {
            "ln1": L.rms_norm_spec(D),
            "ln2": L.rms_norm_spec(D),
            "attn": A.mla_spec(cfg) if kind.startswith("mla") else A.gqa_spec(cfg),
            "ffn": MOE.moe_spec(cfg) if kind.endswith("moe") else L.swiglu_spec(D, cfg.d_ff),
        }
    if kind == "mamba2":
        return {"ln1": L.rms_norm_spec(D), "mixer": S.mamba2_spec(cfg)}
    if kind == "rwkv6":
        return {
            "ln1": L.rms_norm_spec(D),
            "ln2": L.rms_norm_spec(D),
            "tmix": R.time_mix_spec(cfg),
            "cmix": R.channel_mix_spec(cfg),
        }
    if kind == "zamba_group":
        return {
            "mamba": stacked(block_spec(cfg, "mamba2"), cfg.shared_attn_period),
            "shared_in": L.linear_spec(2 * D, D, "embed", "embed"),
        }
    raise ValueError(kind)


def shared_attn_spec(cfg: ModelConfig) -> dict:
    """The zamba2 shared transformer block (weights reused across invocations)."""
    return block_spec(cfg, "attn_dense")


def stacked(specs, n: int):
    return tree_map(
        lambda s: L.ParamSpec((n,) + s.shape, ("layers",) + s.axes, s.init, s.scale),
        specs)


def cache_entry_spec(cfg: ModelConfig, kind: str, batch: int, max_seq: int) -> dict:
    """{name: (shape, dtype string, logical axes) | nested dict} of one
    layer's cache entry."""
    dt = cfg.compute_dtype
    kv = (batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    kvax = ("batch", "cache_seq", "kv_heads_dim", None)
    if kind in ("attn_dense", "attn_moe"):
        return {"k": (kv, dt, kvax), "v": (kv, dt, kvax)}
    if kind in ("mla_dense", "mla_moe"):
        return {"ckv": ((batch, max_seq, cfg.mla_cache_dim), dt, ("batch", "cache_seq", None))}
    if kind == "mamba2":
        E, N, H, P, W = S._dims(cfg)
        return {"conv": ((batch, W - 1, E + 2 * N), dt, ("batch", None, "ssm_inner")),
                "ssm": ((batch, H, P, N), "float32", ("batch", "ssm_heads_dim", None, None))}
    if kind == "rwkv6":
        D, H, Dh = R._dims(cfg)
        return {"xt": ((batch, D), dt, ("batch", None)), "xc": ((batch, D), dt, ("batch", None)),
                "wkv": ((batch, H, Dh, Dh), "float32", ("batch", "ssm_heads_dim", None, None))}
    if kind != "zamba_group":
        raise ValueError(kind)
    inner = cfg.shared_attn_period
    mamba = {k: ((inner,) + shp, d, ("layers",) + ax)
             for k, (shp, d, ax) in cache_entry_spec(cfg, "mamba2", batch, max_seq).items()}
    return {"mamba": mamba, "shared_k": (kv, dt, kvax), "shared_v": (kv, dt, kvax)}


def _index(tree, i: int):
    return tree_map(lambda x: x[i], tree)


def _ffn(kind, p, cfg: ModelConfig, xn, moe_groups: int, dt, batch_group=None,
         row_axes=None):
    """The block's FFN: (out, the MoE aux loss or None); ``row_axes``: see
    ``moe.moe_ffn``."""
    if kind.endswith("moe"):
        return MOE.moe_ffn(p, cfg, xn, moe_groups, batch_group, row_axes)
    spec = L.swiglu_spec(cfg.d_model, cfg.d_ff) if tp.on_blocks() else None
    return L.swiglu(p, xn, dt, spec), None


def _shared_in(p, cfg: ModelConfig, h, emb0, dt):
    """zamba2's ``shared_in`` of concat(h, embedding stream), (B,S,2D) ->
    (B,S,D).  Where the step computes on "model" blocks its product is
    column-parallel: this rank's D/P output columns of the whole weight
    (``tp.own_part``), gathered whole for the shared block's norm."""
    x = torch.cat([h, emb0.to(h.dtype)], dim=-1)
    r, n = tp.model_rank_size() if tp.on_blocks() else (0, 1)
    if n == 1 or cfg.d_model % n:
        return L.linear(p["shared_in"], x, dt)
    c = cfg.d_model // n
    w = tp.own_part(p["shared_in"]["w"], 1, [(r * c, c)])
    tp.COUNTS["block_products"] += 1
    return tp.gather_from_model(tp.copy_to_model(x).to(dt) @ w.to(dt), -1)


def block_full(kind, p, cfg: ModelConfig, h, positions, *, moe_groups=16,
               want_cache=False, emb0=None, shared_p=None, impl=None, batch_group=None):
    """Returns (h, cache_entry | None, aux_loss | None); ``batch_group``:
    see ``moe.route``."""
    cache = aux = None
    dt = L.torch_dtype(cfg.compute_dtype)
    if kind in ATTN_KINDS:
        xn = L.rms_norm(p["ln1"], h, cfg.norm_eps)
        if kind.startswith("mla"):
            attn_out, ckv = A.mla_full(p["attn"], cfg, xn, positions, impl=impl)
            cache = {"ckv": ckv} if want_cache else None
        else:
            attn_out, (k, v) = A.gqa_full(p["attn"], cfg, xn, positions, impl=impl)
            cache = {"k": k, "v": v} if want_cache else None
        h = h + attn_out
        xn = L.rms_norm(p["ln2"], h, cfg.norm_eps)
        ffn_out, aux = _ffn(kind, p["ffn"], cfg, xn, moe_groups, dt, batch_group)
        return h + ffn_out, cache, aux

    if kind == "mamba2":
        xn = L.rms_norm(p["ln1"], h, cfg.norm_eps)
        out, state = S.mamba2_full(p["mixer"], cfg, xn, want_state=want_cache, impl=impl)
        if want_cache:
            cache = {"conv": state[0], "ssm": state[1]}
        return h + out, cache, aux

    if kind == "rwkv6":
        xn = L.rms_norm(p["ln1"], h, cfg.norm_eps)
        out, st = R.time_mix_full(p["tmix"], cfg, xn, want_state=want_cache, impl=impl)
        h = h + out
        xn2 = L.rms_norm(p["ln2"], h, cfg.norm_eps)
        if want_cache:
            cm_out, xc = R.channel_mix(p["cmix"], cfg, xn2, want_state=True)
            cache = {"xt": st[0], "xc": xc, "wkv": st[1]}
        else:
            cm_out = R.channel_mix(p["cmix"], cfg, xn2)
        return h + cm_out, cache, aux

    if kind != "zamba_group":
        raise ValueError(kind)
    # ``inner`` mamba2 layers, then the shared attention block on
    # concat(h, embedding stream)
    mcaches = []
    for i in range(cfg.shared_attn_period):
        h, ci, _ = block_full("mamba2", _index(p["mamba"], i), cfg, h, positions,
                              want_cache=want_cache, impl=impl)
        mcaches.append(ci)
    x_in = _shared_in(p, cfg, h, emb0, dt)
    hs, scache, _ = block_full("attn_dense", shared_p, cfg, x_in, positions,
                               want_cache=want_cache, impl=impl)
    h = h + hs
    if want_cache:
        mstack = tree_map(lambda *xs: torch.stack(xs), *mcaches)
        cache = {"mamba": mstack, "shared_k": scache["k"], "shared_v": scache["v"]}
    return h, cache, aux


def block_decode(kind, p, cfg: ModelConfig, h, cache, t, *, emb0=None, shared_p=None,
                 impl=None, seq_len=None, row_axes=()):
    """Returns (h, cache); the cache entry (views into the model's cache) is
    updated in place.  A MoE FFN routes the B tokens of the whole batch as
    one group, as the reference's; ``row_axes``: the mesh axes that split
    them, () where ``h`` holds all of them (``moe.moe_ffn``).
    ``seq_len``: the whole cache's length where an attention kind's entry
    (zamba2's shared block's) is this rank's block of positions
    (``attention.gqa_decode``)."""
    dt = L.torch_dtype(cfg.compute_dtype)
    if kind in ATTN_KINDS:
        xn = L.rms_norm(p["ln1"], h, cfg.norm_eps)
        if kind.startswith("mla"):
            attn_out, ckv = A.mla_decode(p["attn"], cfg, xn, cache["ckv"], t, impl=impl,
                                         seq_len=seq_len)
            cache = {"ckv": ckv}
        else:
            attn_out, (k, v) = A.gqa_decode(p["attn"], cfg, xn, cache["k"], cache["v"], t,
                                            impl=impl, seq_len=seq_len)
            cache = {"k": k, "v": v}
        h = h + attn_out
        xn = L.rms_norm(p["ln2"], h, cfg.norm_eps)
        ffn_out, _ = _ffn(kind, p["ffn"], cfg, xn, 1, dt, row_axes=row_axes)
        return h + ffn_out, cache

    if kind == "mamba2":
        xn = L.rms_norm(p["ln1"], h, cfg.norm_eps)
        out, (conv, ssm) = S.mamba2_decode(p["mixer"], cfg, xn, cache["conv"], cache["ssm"])
        cache["conv"].copy_(conv)
        cache["ssm"].copy_(ssm)
        return h + out, cache

    if kind == "rwkv6":
        xn = L.rms_norm(p["ln1"], h, cfg.norm_eps)
        out, (xt, wkv) = R.time_mix_decode(p["tmix"], cfg, xn, cache["xt"], cache["wkv"])
        h = h + out
        xn2 = L.rms_norm(p["ln2"], h, cfg.norm_eps)
        cm_out, xc = R.channel_mix(p["cmix"], cfg, xn2, x_prev0=cache["xc"], want_state=True)
        cache["xt"].copy_(xt)
        cache["wkv"].copy_(wkv)
        cache["xc"].copy_(xc)
        return h + cm_out, cache

    if kind != "zamba_group":
        raise ValueError(kind)
    for i in range(cfg.shared_attn_period):
        h, _ = block_decode("mamba2", _index(p["mamba"], i), cfg, h,
                            _index(cache["mamba"], i), t, impl=impl)
    x_in = _shared_in(p, cfg, h, emb0, dt)
    hs, _ = block_decode("attn_dense", shared_p, cfg, x_in,
                         {"k": cache["shared_k"], "v": cache["shared_v"]}, t, impl=impl,
                         seq_len=seq_len)
    return h + hs, cache
