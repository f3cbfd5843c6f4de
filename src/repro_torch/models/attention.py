"""Attention mixers: GQA/MHA (+qkv-bias, qk_norm) and DeepSeek MLA.

Two execution paths per mixer:
  * ``*_full``   — prefill over a full sequence (causal), through ``flash``
    on the card.
  * ``*_decode`` — one new token against a cache, through ``flash_decode``
    on the card.  MLA decodes in *absorbed* form: attention in the latent
    space over the compressed cache, so the per-head K/V are never formed
    over the whole cache.

Where the step computes on "model" blocks (``tp.on_blocks``: training, and
serving over a mesh whose "model" axis has several ranks), GQA's and MLA's
products run on this rank's blocks of their weights (its heads, where they
split), and a decode step reads this rank's block of the cache as the rules
lay it out: its kv heads (``kv_heads_dim``), or its block of positions
(``cache_seq``), whose attention is merged over "model" by log-sum-exp
(``tp.merge_over_model``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamSpec
from repro_torch.parallel import tp


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


def _heads(t, B, S, Dh, blk: bool, count: int, tpn: int, r: int):
    """A projection's output as (B, S, heads, Dh) and its first head: this
    rank's ``count / tpn`` heads where it is a block that splits at head
    boundaries, else every head (a block gathered over "model" first)."""
    if blk and count % tpn == 0:
        return t.reshape(B, S, count // tpn, Dh), r * (count // tpn)
    if blk:
        t = tp.gather_from_model(t, -1)
    return t.reshape(B, S, count, Dh), 0


def _qkv(p, cfg: ModelConfig, x, positions, dt):
    """q, k, v of ``x`` (B,S,D) as (B,S,heads,Dh), normed and rotated, with
    q's and k's first heads, and the ``wo`` hints (``_out``): on this rank's
    blocks of the weights where the step computes on "model" blocks, as the
    reference's ``heads_dim`` / ``kv_heads_dim`` hints resolve.  q keeps
    this rank's heads where H divides the axis, else it is gathered and has
    every head; k and v likewise over Hkv.  On whole weights every step of
    that is the identity."""
    B, S, _ = x.shape
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    spec = gqa_spec(cfg) if tp.on_blocks() else None
    blk = {n: spec is not None and tp.block_dim(p[n]["w"], spec[n]["w"]) is not None
           for n in ("wq", "wk", "wv", "wo")}
    r, tpn = tp.model_rank_size() if spec is not None else (0, 1)
    xc = tp.copy_to_model(x) if blk["wq"] or blk["wk"] or blk["wv"] else x

    def proj(n):
        return L.linear(p[n], xc if blk[n] else x, dt, spec and spec[n])

    q, q0 = _heads(proj("wq"), B, S, Dh, blk["wq"], H, tpn, r)
    k, k0 = _heads(proj("wk"), B, S, Dh, blk["wk"], Hkv, tpn, r)
    v, _ = _heads(proj("wv"), B, S, Dh, blk["wv"], Hkv, tpn, r)
    if cfg.qk_norm:
        # a scale read by this rank's heads only has a partial gradient here
        def norm(name, t, heads):
            scale = p[name]["scale"]
            if t.shape[2] != heads:
                scale = tp.copy_to_model(scale)
            return L.rms_norm({"scale": scale}, t, cfg.norm_eps)

        q, k = norm("q_norm", q, H), norm("k_norm", k, Hkv)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, q0, k, k0, v, (blk["wo"], spec and spec["wo"])


def _out(p, cfg: ModelConfig, out, wo, dt):
    """``wo`` of the attention output ``out`` (B,S,heads,Dh): row-parallel
    over the heads attended here where ``wo`` is a block (the hints of
    ``_qkv`` or ``_mla_heads``), or over its own block of them where every
    head was; whole otherwise."""
    B, S, hq, Dh = out.shape
    blk, spec = wo
    out = out.reshape(B, S, hq * Dh)
    if blk and hq == cfg.num_heads:
        out = tp.scatter_to_model(out, -1)
    elif not blk and hq != cfg.num_heads:
        out = tp.gather_from_model(out, -1)
    return L.linear(p["wo"], out, dt, spec)


def gqa_full(p, cfg: ModelConfig, x, positions, impl=None):
    """x: (B,S,D) -> (out, (k, v)); k and v for the prefill's cache.

    Where the step computes on "model" blocks (``tp.on_blocks``), the
    projections run on this rank's blocks (``_qkv``); where k and v were
    gathered, the kv heads of this rank's q heads (q head h reads kv head
    h // (H / Hkv)) are sliced out for attention; ``wo`` is row-parallel
    (``_out``).  The k and v returned are ``_qkv``'s, before that slice:
    this rank's kv heads where Hkv divides the axis, every kv head
    otherwise, the cache's ``kv_heads_dim`` and ``cache_seq`` blocks' heads."""
    dt = L.torch_dtype(cfg.compute_dtype)
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    q, q0, k, k0, v, wo = _qkv(p, cfg, x, positions, dt)
    kv = (k, v)
    hq, g = q.shape[2], H // Hkv
    lo, hi = q0 // g, (q0 + hq - 1) // g + 1           # the kv heads of this rank's q heads
    if (k0, k.shape[2]) != (lo, hi - lo):
        if hi - lo > 1 and (q0 % g or hq % g):
            raise ValueError(f"q heads {q0}..{q0 + hq - 1} of {H} do not read an even "
                             f"share each of the {Hkv} kv heads")
        if k.shape[2] != Hkv:                          # this rank's kv heads, not those
            k, v = tp.gather_from_model(k, 2), tp.gather_from_model(v, 2)
        if hq != H:                                    # slices of whole k, v: their
            k, v = tp.copy_to_model(k), tp.copy_to_model(v)    # gradients summed
        k, v = k[:, :, lo:hi].contiguous(), v[:, :, lo:hi].contiguous()
    out = ops.attention(q, k, v, causal=True, impl=impl or cfg.attn_impl)
    return _out(p, cfg, out, wo, dt), kv


def _decode_attention(q, cache_k, cache_v, t, seq_len, impl, scale=None):
    """One query token against a cache: the whole cache (or this rank's kv
    heads of it) up to ``t``, or, with ``seq_len``, this rank's block of
    positions of a cache of ``seq_len`` (``tp.seq_block``), merged over
    "model" by log-sum-exp."""
    if seq_len is None:
        return ops.attention(q, cache_k, cache_v, causal=False, kv_len=t + 1, impl=impl,
                             decode=True, scale=scale)
    out, lse = ops.attention(q, cache_k, cache_v, causal=False,
                             kv_len=tp.local_kv_len(t, seq_len), impl=impl, decode=True,
                             scale=scale, return_lse=True)
    return tp.merge_over_model(out, lse)


def _write(cache, entry, t, seq_len) -> None:
    """The new entry into the cache at ``t``: by the rank whose block of
    positions holds it where ``seq_len`` is given (``tp.write_owned``)."""
    if seq_len is None:
        cache.index_copy_(1, t.reshape(1).long(), entry.to(cache.dtype))
    else:
        tp.write_owned(cache, entry, t, seq_len)


def gqa_decode(p, cfg: ModelConfig, x, cache_k, cache_v, t, impl=None, seq_len=None):
    """One-token decode.  x: (B,1,D); cache_k/v: (B,Smax,Hkv,Dh); t: 0-d int32
    tensor on the cache's device.

    Writes the new entry into ``cache_k``/``cache_v`` IN PLACE at position
    ``t`` (the reference returns updated copies; updating in place saves a
    copy of the whole cache per layer and step) and returns them.  ``t`` stays
    on the device: no ``.item()``, so a decode step never syncs the host.

    On "model" blocks (``tp.on_blocks``) the cache is this rank's block of
    it, as the rules lay it out: where it holds this rank's kv heads
    (Hkv/P of them, ``kv_heads_dim``), q, k and v keep this rank's heads as
    in ``gqa_full`` and attend there; where it holds every head, q, k and v
    are made whole, and ``seq_len`` (the whole cache's length) says that
    the cache is this rank's block of positions (``cache_seq``): the rank
    that holds ``t`` writes the entry, each rank attends over its block and
    the ranks' outputs merge over "model".  ``wo`` is row-parallel either
    way (``_out``)."""
    dt = L.torch_dtype(cfg.compute_dtype)
    B = x.shape[0]
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    positions = t.reshape(1, 1).expand(B, 1)
    q, q0, k, k0, v, wo = _qkv(p, cfg, x, positions, dt)
    if cache_k.shape[2] == Hkv:                     # every head: made whole
        if q.shape[2] != H:
            q = tp.gather_from_model(q, 2)
        if k.shape[2] != Hkv:
            k, v = tp.gather_from_model(k, 2), tp.gather_from_model(v, 2)
    elif (k.shape[2], q.shape[2], q0) != (cache_k.shape[2], H * k.shape[2] // Hkv,
                                          k0 * (H // Hkv)):
        raise ValueError(f"a cache block of {cache_k.shape[2]} kv heads is not the heads "
                         f"this rank's projections give ({k.shape[2]} from {k0}, q "
                         f"{q.shape[2]} from {q0})")
    _write(cache_k, k, t, seq_len)
    _write(cache_v, v, t, seq_len)
    out = _decode_attention(q, cache_k.to(dt), cache_v.to(dt), t, seq_len,
                            impl or cfg.attn_impl)
    return _out(p, cfg, out, wo, dt), (cache_k, cache_v)


# ----------------------------------------------------------------------------------
# MLA (DeepSeek-V3)
# ----------------------------------------------------------------------------------


def mla_spec(cfg: ModelConfig) -> dict:
    D, H = cfg.d_model, cfg.num_heads
    nope, rope, vdim = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    s: dict = {
        # KV down-projection: latent c_kv + shared rope key
        "wkv_a": L.linear_spec(D, cfg.kv_lora_rank + rope, "embed", None),
        "kv_norm": L.rms_norm_spec(cfg.kv_lora_rank),
        # up-projections from the latent
        "wk_b": ParamSpec((cfg.kv_lora_rank, H, nope), (None, "heads_dim", None), "normal"),
        "wv_b": ParamSpec((cfg.kv_lora_rank, H, vdim), (None, "heads_dim", None), "normal"),
        "wo": L.linear_spec(H * vdim, D, "heads", "embed"),
    }
    if cfg.q_lora_rank:
        s["wq_a"] = L.linear_spec(D, cfg.q_lora_rank, "embed", None)
        s["q_norm"] = L.rms_norm_spec(cfg.q_lora_rank)
        s["wq_b"] = ParamSpec((cfg.q_lora_rank, H, nope + rope), (None, "heads_dim", None),
                              "normal")
    else:
        s["wq"] = ParamSpec((D, H, nope + rope), ("embed", "heads_dim", None), "normal")
    return s


def _mla_heads(p, cfg: ModelConfig):
    """(whether ``p`` holds this rank's heads of the head-split weights, the
    ``wo`` hints for ``_out``) where the step computes on "model" blocks:
    ``wq_b`` (or ``wq``), ``wk_b`` and ``wv_b`` are this rank's H/P heads
    where the rules split ``heads_dim`` (H divides the axis), else whole;
    ``wo`` (``heads``: H x v_head_dim rows) is a block wherever its rows
    split.  (False, (False, None)) elsewhere."""
    if not tp.on_blocks():
        return False, (False, None)
    spec = mla_spec(cfg)
    local = [tp.block_dim(p[n], spec[n]) is not None
             for n in ("wq_b", "wq", "wk_b", "wv_b") if n in p]
    wo = tp.block_dim(p["wo"]["w"], spec["wo"]["w"]) is not None
    return all(local), (wo, spec["wo"])


def _per_head(eq: str, a, w, dt, local: bool):
    """``einsum(eq, a, w)`` of an up-projection over the heads (``w`` this
    rank's block of them where ``local``)."""
    if local:
        tp.COUNTS["block_products"] += 1
    return torch.einsum(eq, a, w.to(dt))


def _mla_q(p, cfg: ModelConfig, x, positions, dt, local: bool):
    """q's nope and (rotated) rope parts, (B,S,heads,*): this rank's heads
    where ``local`` (``_mla_heads``), the whole ``cq`` (or ``x``) entering
    them through ``tp.copy_to_model``."""
    nope = cfg.qk_nope_head_dim
    into = tp.copy_to_model if local else (lambda t: t)
    if cfg.q_lora_rank:
        cq = L.rms_norm(p["q_norm"], L.linear(p["wq_a"], x, dt), cfg.norm_eps)
        q = _per_head("bsr,rhd->bshd", into(cq), p["wq_b"], dt, local)
    else:
        q = _per_head("bsD,Dhd->bshd", into(x).to(dt), p["wq"], dt, local)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    return q_nope, L.apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(p, cfg: ModelConfig, x, positions, dt):
    kv = L.linear(p["wkv_a"], x, dt)
    c_kv = L.rms_norm(p["kv_norm"], kv[..., :cfg.kv_lora_rank], cfg.norm_eps)
    k_rope = kv[..., cfg.kv_lora_rank:][:, :, None, :]          # (B,S,1,rope)
    k_rope = L.apply_rope(k_rope, positions, cfg.rope_theta)
    return c_kv, k_rope[:, :, 0, :]


def mla_full(p, cfg: ModelConfig, x, positions, impl=None):
    """Expanded MLA for prefill: the per-head K and V are formed from the
    latent, and the shared rope key is broadcast over the heads.  Returns
    (out, the compressed cache (B,S,kv_lora_rank + rope)).

    Where the step computes on "model" blocks and the rules split the heads
    (``_mla_heads``), q, K and V are this rank's H/P heads: the latent
    ``c_kv`` and the rope key, the same on every rank (``wkv_a`` and
    ``kv_norm`` are whole), enter them through ``tp.copy_to_model``, and
    attention runs on those heads.  ``wo`` is row-parallel (``_out``), over
    this rank's heads or, where every head was attended (H does not divide
    the axis), over its own block of them.  The cache returned is whole."""
    dt = L.torch_dtype(cfg.compute_dtype)
    B, S, _ = x.shape
    local, wo = _mla_heads(p, cfg)
    q_nope, q_rope = _mla_q(p, cfg, x, positions, dt, local)
    c_kv, k_rope = _mla_latent(p, cfg, x, positions, dt)
    c_h, kr_h = (tp.copy_to_model(c_kv), tp.copy_to_model(k_rope)) if local else (c_kv, k_rope)
    k_nope = _per_head("bsr,rhd->bshd", c_h, p["wk_b"], dt, local)
    v = _per_head("bsr,rhd->bshd", c_h, p["wv_b"], dt, local)
    h = k_nope.shape[2]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, kr_h[:, :, None, :].expand(B, S, h, cfg.qk_rope_head_dim)],
                  dim=-1)
    out = ops.attention(q, k, v.contiguous(), causal=True, impl=impl or cfg.attn_impl)
    return _out(p, cfg, out, wo, dt), torch.cat([c_kv, k_rope], dim=-1)


def mla_scale(cfg: ModelConfig) -> float:
    """1/sqrt(qk_head_dim), computed in float32 as the reference computes it
    (a Python float: the reference's jax array cannot reach its Pallas
    kernel, ROADMAP §3 fault 9)."""
    return float(np.float32(1) / np.sqrt(np.float32(cfg.qk_head_dim)))


def mla_decode(p, cfg: ModelConfig, x, cache, t, impl=None, seq_len=None):
    """Absorbed-form decode.  x: (B,1,D); cache: (B,Smax,kv_lora_rank + rope)
    compressed entries; t: 0-d int32 on the cache's device.

    ``wk_b`` is absorbed into the query, so attention runs in the latent
    space with one kv head shared by all H query heads: q (B,1,H,R+rope)
    against the cache itself as K, and its first R columns (a view) as V.
    Writes the new entry into ``cache`` IN PLACE at position ``t`` and
    returns it.  ``seq_len``: the whole cache's length where ``cache`` is
    this rank's block of positions (``cache_seq`` on "model"), as in
    ``gqa_decode``.

    On "model" blocks with the heads split (``_mla_heads``), the absorbed
    query is formed from this rank's blocks of ``wq_b`` and ``wk_b``; over
    a block of positions it is gathered to every head (B,1,H,R+rope), which
    attends there and merges over "model", and this rank's heads of the
    merged latent output go on through its block of ``wv_b``.  ``wo`` is
    row-parallel (``_out``)."""
    dt = L.torch_dtype(cfg.compute_dtype)
    B = x.shape[0]
    R = cfg.kv_lora_rank
    positions = t.reshape(1, 1).expand(B, 1)
    local, wo = _mla_heads(p, cfg)
    q_nope, q_rope = _mla_q(p, cfg, x, positions, dt, local)    # (B,1,heads,*)
    c_new, kr_new = _mla_latent(p, cfg, x, positions, dt)       # (B,1,R), (B,1,rope)
    _write(cache, torch.cat([c_new, kr_new], dim=-1), t, seq_len)
    k_cat = cache.to(dt)[:, :, None, :]                          # (B,S,1,R+rope)
    # absorb W_uk into q:  q_abs = q_nope @ W_uk  -> latent-space query
    q_abs = _per_head("bqhd,rhd->bqhr", q_nope, p["wk_b"], dt, local)  # (B,1,heads,R)
    q_cat = torch.cat([q_abs, q_rope], dim=-1)                  # (B,1,heads,R+rope)
    every_head = local and seq_len is not None
    if every_head:                          # every head attends this rank's positions
        q_cat = tp.gather_from_model(q_cat, 2)
    out_lat = _decode_attention(q_cat, k_cat, k_cat[..., :R], t, seq_len,
                                impl or cfg.attn_impl, scale=mla_scale(cfg))
    if every_head:                          # this rank's heads of the merged output
        out_lat = tp.scatter_to_model(out_lat, 2)
    out = _per_head("bqhr,rhd->bqhd", out_lat, p["wv_b"], dt, local)
    return _out(p, cfg, out, wo, dt), cache
