"""GQA/MHA attention mixer (+qkv-bias, qk_norm).

Two execution paths:
  * ``gqa_full``   — prefill over a full sequence (causal), through ``flash``
    on the card.
  * ``gqa_decode`` — one new token against a cache, through ``flash_decode``
    on the card.

MLA (DeepSeek) comes with the MLA slice of the port.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L


def gqa_spec(cfg: ModelConfig) -> dict:
    H, Hkv, D, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.d_model, cfg.head_dim
    s = {
        "wq": L.linear_spec(D, H * Dh, "embed", "heads", bias=cfg.qkv_bias),
        "wk": L.linear_spec(D, Hkv * Dh, "embed", "kv_heads", bias=cfg.qkv_bias),
        "wv": L.linear_spec(D, Hkv * Dh, "embed", "kv_heads", bias=cfg.qkv_bias),
        "wo": L.linear_spec(H * Dh, D, "heads", "embed"),
    }
    if cfg.qk_norm:
        s["q_norm"] = L.rms_norm_spec(Dh)
        s["k_norm"] = L.rms_norm_spec(Dh)
    return s


def _project_qkv(p, cfg: ModelConfig, x, positions, dt):
    B, S, _ = x.shape
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = L.linear(p["wq"], x, dt).reshape(B, S, H, Dh)
    k = L.linear(p["wk"], x, dt).reshape(B, S, Hkv, Dh)
    v = L.linear(p["wv"], x, dt).reshape(B, S, Hkv, Dh)
    if cfg.qk_norm:
        q = L.rms_norm(p["q_norm"], q, cfg.norm_eps)
        k = L.rms_norm(p["k_norm"], k, cfg.norm_eps)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_full(p, cfg: ModelConfig, x, positions, impl=None):
    """x: (B,S,D) -> (out, kv) ; kv returned for prefill cache construction."""
    dt = L.torch_dtype(cfg.compute_dtype)
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions, dt)
    out = ops.attention(q, k, v, causal=True, impl=impl or cfg.attn_impl)
    out = out.reshape(B, S, cfg.num_heads * cfg.head_dim)
    return L.linear(p["wo"], out, dt), (k, v)


def gqa_decode(p, cfg: ModelConfig, x, cache_k, cache_v, t, impl=None):
    """One-token decode.  x: (B,1,D); cache_k/v: (B,Smax,Hkv,Dh); t: 0-d int32
    tensor on the cache's device.

    Writes the new entry into ``cache_k``/``cache_v`` IN PLACE at position
    ``t`` (the reference returns updated copies; updating in place saves a
    copy of the whole cache per layer and step) and returns them.  ``t`` stays
    on the device: no ``.item()``, so a decode step never syncs the host."""
    dt = L.torch_dtype(cfg.compute_dtype)
    B = x.shape[0]
    positions = t.reshape(1, 1).expand(B, 1)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions, dt)
    idx = t.reshape(1).long()
    cache_k.index_copy_(1, idx, k_new.to(cache_k.dtype))
    cache_v.index_copy_(1, idx, v_new.to(cache_v.dtype))
    out = ops.attention(
        q, cache_k.to(dt), cache_v.to(dt),
        causal=False, kv_len=t + 1, impl=impl or cfg.attn_impl, decode=True,
    )
    out = out.reshape(B, 1, cfg.num_heads * cfg.head_dim)
    return L.linear(p["wo"], out, dt), (cache_k, cache_v)
