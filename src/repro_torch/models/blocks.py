"""Per-layer blocks: spec + full-sequence + decode application.

Only ``attn_dense`` (pre-LN GQA attention + pre-LN SwiGLU) is ported so far;
the other kinds of ``repro/models/blocks.py`` come with their families.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.utils.tree import tree_map

PORTED_KINDS = ("attn_dense",)


def _require(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet "
                                  f"(ported: {PORTED_KINDS})")


def block_spec(cfg: ModelConfig, kind: str) -> dict:
    _require(kind)
    D = cfg.d_model
    return {
        "ln1": L.rms_norm_spec(D),
        "ln2": L.rms_norm_spec(D),
        "attn": A.gqa_spec(cfg),
        "ffn": L.swiglu_spec(D, cfg.d_ff),
    }


def stacked(specs, n: int):
    return tree_map(
        lambda s: L.ParamSpec((n,) + s.shape, ("layers",) + s.axes, s.init, s.scale),
        specs)


def cache_entry_spec(cfg: ModelConfig, kind: str, batch: int, max_seq: int) -> dict:
    """{name: (shape, dtype string)} of one layer's cache entry."""
    _require(kind)
    shp = (batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {"k": (shp, cfg.compute_dtype), "v": (shp, cfg.compute_dtype)}


def block_full(kind, p, cfg: ModelConfig, h, positions, *, want_cache=False, impl=None):
    """Returns (h, cache_entry | None)."""
    _require(kind)
    xn = L.rms_norm(p["ln1"], h, cfg.norm_eps)
    attn_out, (k, v) = A.gqa_full(p["attn"], cfg, xn, positions, impl=impl)
    h = h + attn_out
    xn = L.rms_norm(p["ln2"], h, cfg.norm_eps)
    h = h + L.swiglu(p["ffn"], xn, L.torch_dtype(cfg.compute_dtype))
    return h, ({"k": k, "v": v} if want_cache else None)


def block_decode(kind, p, cfg: ModelConfig, h, cache, t, *, impl=None):
    """Returns (h, cache); the cache entry is updated in place."""
    _require(kind)
    xn = L.rms_norm(p["ln1"], h, cfg.norm_eps)
    attn_out, (k, v) = A.gqa_decode(p["attn"], cfg, xn, cache["k"], cache["v"], t,
                                    impl=impl)
    h = h + attn_out
    xn = L.rms_norm(p["ln2"], h, cfg.norm_eps)
    h = h + L.swiglu(p["ffn"], xn, L.torch_dtype(cfg.compute_dtype))
    return h, {"k": k, "v": v}
