"""RWKV6 ("Finch") layer, as ``repro/models/rwkv.py``: data-dependent-decay
time-mix + channel-mix.

Token-shift ddlerp with a rank-`rwkv_lora_mix` LoRA producing per-channel
mix offsets for (r,k,v,w,g); decay ``w = exp(-exp(w0 + lora(x_w)))``; WKV6
recurrence (``ops.wkv6``: the CUDA kernel on the card; the one-token step is
plain PyTorch, ``wkv6_step``); per-head GroupNorm; gated output.  Decode
state per layer: (x_prev for time-mix, x_prev for channel-mix, wkv state
(H,D,D)).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.rwkv6_scan import wkv6_step
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamSpec


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


def _decay(p, xw, dt):
    """w = exp(-exp(w0 + lora(x_w))) in fp32, (B,S,D)."""
    w_raw = p["w0"].float() + (
        torch.tanh(xw @ p["decay_w1"].to(dt)) @ p["decay_w2"].to(dt)).float()
    return torch.exp(-torch.exp(w_raw))


def _gated_out(p, cfg: ModelConfig, y, g, H, dt):
    y = L.group_norm(y, H, cfg.norm_eps) * p["ln_scale"].to(dt) + p["ln_bias"].to(dt)
    return L.linear(p["wo"], y * F.silu(g), dt)


def time_mix_full(p, cfg: ModelConfig, x, *, x_prev0=None, want_state=False, impl=None):
    """x: (B,S,D). x_prev0: (B,D) carried shift state (decode handoff)."""
    dt = L.torch_dtype(cfg.compute_dtype)
    D, H, Dh = _dims(cfg)
    B, S, _ = x.shape
    if x_prev0 is None:
        x_prev0 = torch.zeros((B, D), dtype=dt, device=x.device)
    x_prev = torch.cat([x_prev0[:, None], x[:, :-1]], dim=1)
    xr, xk, xv, xw, xg = _ddlerp(p, x, x_prev, dt)
    r = L.linear(p["wr"], xr, dt).reshape(B, S, H, Dh)
    k = L.linear(p["wk"], xk, dt).reshape(B, S, H, Dh)
    v = L.linear(p["wv"], xv, dt).reshape(B, S, H, Dh)
    g = L.linear(p["wg"], xg, dt)
    w = _decay(p, xw, dt).reshape(B, S, H, Dh)
    # the scan reads w in the compute dtype, as the reference (rwkv.py:99)
    out = ops.wkv6(r, k, v, w.to(dt), p["u"], impl=impl or "auto",
                   return_state=want_state)
    state = None
    if want_state:
        out, wkv_state = out
        state = (x[:, -1].to(dt), wkv_state)
    return _gated_out(p, cfg, out.reshape(B, S, D), g, H, dt), state


def time_mix_decode(p, cfg: ModelConfig, x, x_prev, wkv_state):
    """x: (B,1,D); x_prev: (B,D); wkv_state: (B,H,Dh,Dh) fp32.
    Returns (out, (new x_prev, new wkv_state)), both new tensors."""
    dt = L.torch_dtype(cfg.compute_dtype)
    D, H, Dh = _dims(cfg)
    B = x.shape[0]
    xr, xk, xv, xw, xg = _ddlerp(p, x, x_prev[:, None], dt)
    r = L.linear(p["wr"], xr, dt).reshape(B, H, Dh)
    k = L.linear(p["wk"], xk, dt).reshape(B, H, Dh)
    v = L.linear(p["wv"], xv, dt).reshape(B, H, Dh)
    g = L.linear(p["wg"], xg, dt)
    w = _decay(p, xw, dt).reshape(B, H, Dh)
    y, wkv_state = wkv6_step(r, k, v, w.to(dt), p["u"], wkv_state)
    return _gated_out(p, cfg, y.reshape(B, 1, D), g, H, dt), (x[:, 0].to(dt), wkv_state)


def channel_mix(p, cfg: ModelConfig, x, x_prev0=None, want_state=False):
    """Works for full sequences and single steps alike."""
    dt = L.torch_dtype(cfg.compute_dtype)
    B, S, D = x.shape
    if x_prev0 is None:
        x_prev0 = torch.zeros((B, D), dtype=dt, device=x.device)
    x_prev = torch.cat([x_prev0[:, None], x[:, :-1]], dim=1)
    xx = x_prev - x
    xk = x + xx * p["mu_k"].to(dt)
    xr = x + xx * p["mu_r"].to(dt)
    kk = torch.square(F.relu(L.linear(p["wk"], xk, dt)))
    out = torch.sigmoid(L.linear(p["wr"], xr, dt)) * L.linear(p["wv"], kk, dt)
    if want_state:
        return out, x[:, -1].to(dt)
    return out
