"""Per-layer blocks: spec + full-sequence + decode application, per block kind.

Kinds ported so far (``PORTED_KINDS``), as in ``repro/models/blocks.py``:
  attn_dense  pre-LN GQA attention + pre-LN SwiGLU
  mamba2      pre-LN Mamba2 mixer (no separate FFN)
  rwkv6       RWKV6 time-mix + channel-mix (LN-per-submodule)
  zamba_group ``inner`` Mamba2 layers + one shared-attention invocation
The MoE and MLA kinds come with their families.

Decode updates a layer's cache entry in place (the attention cache at the
device ``t``, the SSM states by copy) and returns it.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import rwkv as R
from repro_torch.models import ssm as S
from repro_torch.utils.tree import tree_map

PORTED_KINDS = ("attn_dense", "mamba2", "rwkv6", "zamba_group")


def _require(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet "
                                  f"(ported: {PORTED_KINDS})")


def block_spec(cfg: ModelConfig, kind: str) -> dict:
    _require(kind)
    D = cfg.d_model
    if kind == "attn_dense":
        return {
            "ln1": L.rms_norm_spec(D),
            "ln2": L.rms_norm_spec(D),
            "attn": A.gqa_spec(cfg),
            "ffn": L.swiglu_spec(D, cfg.d_ff),
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
    return {   # zamba_group
        "mamba": stacked(block_spec(cfg, "mamba2"), cfg.shared_attn_period),
        "shared_in": L.linear_spec(2 * D, D, "embed", "embed"),
    }


def shared_attn_spec(cfg: ModelConfig) -> dict:
    """The zamba2 shared transformer block (weights reused across invocations)."""
    return block_spec(cfg, "attn_dense")


def stacked(specs, n: int):
    return tree_map(
        lambda s: L.ParamSpec((n,) + s.shape, ("layers",) + s.axes, s.init, s.scale),
        specs)


def cache_entry_spec(cfg: ModelConfig, kind: str, batch: int, max_seq: int) -> dict:
    """{name: (shape, dtype string) | nested dict} of one layer's cache entry."""
    _require(kind)
    dt = cfg.compute_dtype
    kv = (batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    if kind == "attn_dense":
        return {"k": (kv, dt), "v": (kv, dt)}
    if kind == "mamba2":
        E, N, H, P, W = S._dims(cfg)
        return {"conv": ((batch, W - 1, E + 2 * N), dt),
                "ssm": ((batch, H, P, N), "float32")}
    if kind == "rwkv6":
        D, H, Dh = R._dims(cfg)
        return {"xt": ((batch, D), dt), "xc": ((batch, D), dt),
                "wkv": ((batch, H, Dh, Dh), "float32")}
    inner = cfg.shared_attn_period      # zamba_group
    mamba = {k: ((inner,) + shp, d)
             for k, (shp, d) in cache_entry_spec(cfg, "mamba2", batch, max_seq).items()}
    return {"mamba": mamba, "shared_k": (kv, dt), "shared_v": (kv, dt)}


def _index(tree, i: int):
    return tree_map(lambda x: x[i], tree)


def block_full(kind, p, cfg: ModelConfig, h, positions, *, want_cache=False,
               emb0=None, shared_p=None, impl=None):
    """Returns (h, cache_entry | None)."""
    _require(kind)
    cache = None
    dt = L.torch_dtype(cfg.compute_dtype)
    if kind == "attn_dense":
        xn = L.rms_norm(p["ln1"], h, cfg.norm_eps)
        attn_out, (k, v) = A.gqa_full(p["attn"], cfg, xn, positions, impl=impl)
        h = h + attn_out
        xn = L.rms_norm(p["ln2"], h, cfg.norm_eps)
        h = h + L.swiglu(p["ffn"], xn, dt)
        return h, ({"k": k, "v": v} if want_cache else None)

    if kind == "mamba2":
        xn = L.rms_norm(p["ln1"], h, cfg.norm_eps)
        out, state = S.mamba2_full(p["mixer"], cfg, xn, want_state=want_cache, impl=impl)
        if want_cache:
            cache = {"conv": state[0], "ssm": state[1]}
        return h + out, cache

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
        return h + cm_out, cache

    # zamba_group: ``inner`` mamba2 layers, then the shared attention block
    # on concat(h, embedding stream)
    mcaches = []
    for i in range(cfg.shared_attn_period):
        h, ci = block_full("mamba2", _index(p["mamba"], i), cfg, h, positions,
                           want_cache=want_cache, impl=impl)
        mcaches.append(ci)
    x_in = L.linear(p["shared_in"], torch.cat([h, emb0.to(h.dtype)], dim=-1), dt)
    hs, scache = block_full("attn_dense", shared_p, cfg, x_in, positions,
                            want_cache=want_cache, impl=impl)
    h = h + hs
    if want_cache:
        mstack = tree_map(lambda *xs: torch.stack(xs), *mcaches)
        cache = {"mamba": mstack, "shared_k": scache["k"], "shared_v": scache["v"]}
    return h, cache


def block_decode(kind, p, cfg: ModelConfig, h, cache, t, *, emb0=None, shared_p=None,
                 impl=None):
    """Returns (h, cache); the cache entry (views into the model's cache) is
    updated in place."""
    _require(kind)
    dt = L.torch_dtype(cfg.compute_dtype)
    if kind == "attn_dense":
        xn = L.rms_norm(p["ln1"], h, cfg.norm_eps)
        attn_out, (k, v) = A.gqa_decode(p["attn"], cfg, xn, cache["k"], cache["v"], t,
                                        impl=impl)
        h = h + attn_out
        xn = L.rms_norm(p["ln2"], h, cfg.norm_eps)
        h = h + L.swiglu(p["ffn"], xn, dt)
        return h, {"k": k, "v": v}

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

    # zamba_group
    for i in range(cfg.shared_attn_period):
        h, _ = block_decode("mamba2", _index(p["mamba"], i), cfg, h,
                            _index(cache["mamba"], i), t, impl=impl)
    x_in = L.linear(p["shared_in"], torch.cat([h, emb0.to(h.dtype)], dim=-1), dt)
    hs, _ = block_decode("attn_dense", shared_p, cfg, x_in,
                         {"k": cache["shared_k"], "v": cache["shared_v"]}, t, impl=impl)
    return h + hs, cache
