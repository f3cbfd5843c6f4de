"""RWKV6 ("Finch") layer, as ``repro/models/rwkv.py``: data-dependent-decay
time-mix + channel-mix.

Token-shift ddlerp with a rank-`rwkv_lora_mix` LoRA producing per-channel
mix offsets for (r,k,v,w,g); decay ``w = exp(-exp(w0 + lora(x_w)))``; WKV6
recurrence (``ops.wkv6``: the CUDA kernel on the card; the one-token step is
plain PyTorch, ``wkv6_step``); per-head GroupNorm; gated output.  Decode
state per layer: (x_prev for time-mix, x_prev for channel-mix, wkv state
(H,D,D)).

Where the step computes on "model" blocks (``tp.on_blocks``) and the rules
split the time-mix's "heads" over the axis, ``wr``, ``wk``, ``wv`` and ``wg``
are column-parallel and ``wo`` row-parallel.  Where H divides the axis their
blocks are this rank's H/P heads (``_heads``): the decay is computed for
its channels (``w0`` and ``decay_w2``'s columns sliced, the whole LoRA
activation entering through ``tp.copy_to_model``), the scan runs on its
heads with ``u`` sliced, and the per-head GroupNorm with ``ln_scale`` and
``ln_bias`` sliced (``tp.own_part``); the serving state ``wkv`` is then its
heads (the rules' ``ssm_heads_dim``).  Where H does not divide it, r, k, v
are gathered whole, every head is computed, and the normed output is cut to
``wg``'s and ``wo``'s block.  The ddlerp LoRA stays whole on every rank.
The channel-mix is a tensor-parallel MLP: ``wk`` column-parallel on "mlp",
``wv`` row-parallel, ``wr`` whole.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.rwkv6_scan import wkv6_step
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamSpec
from repro_torch.parallel import tp


def _dims(cfg: ModelConfig):
    D = cfg.d_model
    Dh = cfg.head_dim
    H = D // Dh
    return D, H, Dh


def time_mix_spec(cfg: ModelConfig) -> dict:
    D, H, Dh = _dims(cfg)
    R = cfg.rwkv_lora_mix
    R2 = cfg.rwkv_lora_decay
    return {
        "mu_x": ParamSpec((D,), (None,), "small"),
        "mu": ParamSpec((5, D), (None, None), "small"),
        "lora_w1": ParamSpec((D, 5 * R), ("embed", None), "small"),
        "lora_w2": ParamSpec((5, R, D), (None, None, "embed"), "small"),
        "wr": L.linear_spec(D, D, "embed", "heads"),
        "wk": L.linear_spec(D, D, "embed", "heads"),
        "wv": L.linear_spec(D, D, "embed", "heads"),
        "wg": L.linear_spec(D, D, "embed", "heads"),
        "w0": ParamSpec((D,), (None,), "decay"),
        "decay_w1": ParamSpec((D, R2), ("embed", None), "small"),
        "decay_w2": ParamSpec((R2, D), (None, "embed"), "small"),
        "u": ParamSpec((H, Dh), ("ssm_heads", None), "small"),
        "ln_scale": ParamSpec((D,), (None,), "ones"),
        "ln_bias": ParamSpec((D,), (None,), "zeros"),
        "wo": L.linear_spec(D, D, "heads", "embed"),
    }


def channel_mix_spec(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    F_ = cfg.d_ff
    return {
        "mu_k": ParamSpec((D,), (None,), "small"),
        "mu_r": ParamSpec((D,), (None,), "small"),
        "wk": L.linear_spec(D, F_, "embed", "mlp"),
        "wv": L.linear_spec(F_, D, "mlp", "embed"),
        "wr": L.linear_spec(D, D, "embed", "embed"),
    }


def _ddlerp(p, x, x_prev, dt):
    """Returns the 5 mixed inputs (r,k,v,w,g). x/x_prev: (B,S,D)."""
    xx = x_prev - x
    xxx = x + xx * p["mu_x"].to(dt)
    R = p["lora_w1"].shape[1] // 5
    lo = torch.tanh(xxx @ p["lora_w1"].to(dt))               # (B,S,5R)
    B_, S_, _ = lo.shape
    lo = lo.reshape(B_, S_, 5, R)
    offs = torch.einsum("bsfr,frd->bsfd", lo, p["lora_w2"].to(dt))
    return [x + xx * (p["mu"][i].to(dt) + offs[:, :, i]) for i in range(5)]


def _heads(p, cfg: ModelConfig):
    """(this rank's first head and head count, or ``None`` where it computes
    every head, the time-mix's spec where its products run on "model"
    blocks, else ``None``): off blocks, or where the rules leave "heads"
    whole, (None, None)."""
    if not tp.on_blocks():
        return None, None
    spec = time_mix_spec(cfg)
    if tp.block_dim(p["wr"]["w"], spec["wr"]["w"]) is None:
        return None, None
    r, n = tp.model_rank_size()
    D, H, Dh = _dims(cfg)
    return ((r * (H // n), H // n) if H % n == 0 else None), spec


def _proj(p, name, x, dt, heads, spec, whole=True):
    """A column-parallel product of the time-mix: this rank's block of the
    output where ``spec`` is given, gathered whole where the heads do not
    split (and ``whole``)."""
    if spec is None:
        return L.linear(p[name], x, dt)
    y = L.linear(p[name], tp.copy_to_model(x), dt, spec[name])
    return tp.gather_from_model(y, -1) if heads is None and whole else y


def _channels(cfg: ModelConfig, heads):
    """(first channel, count) of this rank's heads."""
    return heads[0] * cfg.head_dim, heads[1] * cfg.head_dim


def _decay(p, cfg: ModelConfig, xw, dt, heads):
    """w = exp(-exp(w0 + lora(x_w))) in fp32, (B,S,D), or (B,S,D/P) of this
    rank's heads."""
    lo = torch.tanh(xw @ p["decay_w1"].to(dt))
    if heads is None:
        w_raw = p["w0"].float() + (lo @ p["decay_w2"].to(dt)).float()
    else:
        c = [_channels(cfg, heads)]
        tp.COUNTS["block_products"] += 1
        w_raw = tp.own_part(p["w0"], 0, c).float() + (
            tp.copy_to_model(lo) @ tp.own_part(p["decay_w2"], 1, c).to(dt)).float()
    return torch.exp(-torch.exp(w_raw))


def _gated_out(p, cfg: ModelConfig, y, g, dt, heads, spec):
    """GroupNorm of the heads in ``y``, gated by ``g`` (this rank's block of
    it where ``spec`` is given), through ``wo`` (row-parallel on blocks)."""
    if heads is None:
        y = L.group_norm(y, y.shape[-1] // cfg.head_dim, cfg.norm_eps) \
            * p["ln_scale"].to(dt) + p["ln_bias"].to(dt)
        if spec is not None:                 # every head: cut to wg's and wo's block
            y = tp.scatter_to_model(y, -1)
        return L.linear(p["wo"], y * F.silu(g), dt, spec and spec["wo"])
    c = [_channels(cfg, heads)]
    y = L.group_norm(y, heads[1], cfg.norm_eps) * tp.own_part(p["ln_scale"], 0, c).to(dt) \
        + tp.own_part(p["ln_bias"], 0, c).to(dt)
    return L.linear(p["wo"], y * F.silu(g), dt, spec["wo"])


def time_mix_full(p, cfg: ModelConfig, x, *, x_prev0=None, want_state=False, impl=None):
    """x: (B,S,D). x_prev0: (B,D) carried shift state (decode handoff).  On
    this rank's heads (``_heads``) the wkv state is theirs."""
    dt = L.torch_dtype(cfg.compute_dtype)
    D, H, Dh = _dims(cfg)
    B, S, _ = x.shape
    heads, spec = _heads(p, cfg)
    hl = H if heads is None else heads[1]
    if x_prev0 is None:
        x_prev0 = torch.zeros((B, D), dtype=dt, device=x.device)
    x_prev = torch.cat([x_prev0[:, None], x[:, :-1]], dim=1)
    xr, xk, xv, xw, xg = _ddlerp(p, x, x_prev, dt)
    r = _proj(p, "wr", xr, dt, heads, spec).reshape(B, S, hl, Dh)
    k = _proj(p, "wk", xk, dt, heads, spec).reshape(B, S, hl, Dh)
    v = _proj(p, "wv", xv, dt, heads, spec).reshape(B, S, hl, Dh)
    g = _proj(p, "wg", xg, dt, heads, spec, whole=False)
    w = _decay(p, cfg, xw, dt, heads).reshape(B, S, hl, Dh)
    u = p["u"] if heads is None else tp.own_part(p["u"], 0, [heads])
    # the scan reads w in the compute dtype, as the reference (rwkv.py:99)
    out = ops.wkv6(r, k, v, w.to(dt), u, impl=impl or "auto", return_state=want_state)
    state = None
    if want_state:
        out, wkv_state = out
        state = (x[:, -1].to(dt), wkv_state)
    return _gated_out(p, cfg, out.reshape(B, S, hl * Dh), g, dt, heads, spec), state


def time_mix_decode(p, cfg: ModelConfig, x, x_prev, wkv_state):
    """x: (B,1,D); x_prev: (B,D); wkv_state: (B,H,Dh,Dh) fp32, or this
    rank's heads of it (``_heads``).
    Returns (out, (new x_prev, new wkv_state)), both new tensors."""
    dt = L.torch_dtype(cfg.compute_dtype)
    D, H, Dh = _dims(cfg)
    B = x.shape[0]
    heads, spec = _heads(p, cfg)
    hl = H if heads is None else heads[1]
    xr, xk, xv, xw, xg = _ddlerp(p, x, x_prev[:, None], dt)
    r = _proj(p, "wr", xr, dt, heads, spec).reshape(B, hl, Dh)
    k = _proj(p, "wk", xk, dt, heads, spec).reshape(B, hl, Dh)
    v = _proj(p, "wv", xv, dt, heads, spec).reshape(B, hl, Dh)
    g = _proj(p, "wg", xg, dt, heads, spec, whole=False)
    w = _decay(p, cfg, xw, dt, heads).reshape(B, hl, Dh)
    u = p["u"] if heads is None else tp.own_part(p["u"], 0, [heads])
    y, wkv_state = wkv6_step(r, k, v, w.to(dt), u, wkv_state)
    return (_gated_out(p, cfg, y.reshape(B, 1, hl * Dh), g, dt, heads, spec),
            (x[:, 0].to(dt), wkv_state))


def channel_mix(p, cfg: ModelConfig, x, x_prev0=None, want_state=False):
    """Works for full sequences and single steps alike.  On "model" blocks
    (``tp.on_blocks``, "mlp" split) ``wk`` is column-parallel and ``wv``
    row-parallel; ``wr`` is whole."""
    dt = L.torch_dtype(cfg.compute_dtype)
    B, S, D = x.shape
    spec = channel_mix_spec(cfg) if tp.on_blocks() else None
    if spec is not None and tp.block_dim(p["wk"]["w"], spec["wk"]["w"]) is None:
        spec = None
    if x_prev0 is None:
        x_prev0 = torch.zeros((B, D), dtype=dt, device=x.device)
    x_prev = torch.cat([x_prev0[:, None], x[:, :-1]], dim=1)
    xx = x_prev - x
    xk = x + xx * p["mu_k"].to(dt)
    xr = x + xx * p["mu_r"].to(dt)
    if spec is not None:
        xk = tp.copy_to_model(xk)
    kk = torch.square(F.relu(L.linear(p["wk"], xk, dt, spec and spec["wk"])))
    out = torch.sigmoid(L.linear(p["wr"], xr, dt)) * L.linear(p["wv"], kk, dt,
                                                              spec and spec["wv"])
    if want_state:
        return out, x[:, -1].to(dt)
    return out
