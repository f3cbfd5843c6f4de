"""Mamba2 block (zamba2's backbone), as ``repro/models/ssm.py``.

Layout: in_proj -> [z | x | B | C | dt] ; causal depthwise conv over [x|B|C] ;
SSD scan ; gated RMSNorm ; out_proj.  Decode carries (conv window, ssm state).
The full-sequence scan goes through ``ops.ssd`` (the CUDA kernel on the
card); the one-token step is plain PyTorch (``ssd_step``), as in the
reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_step
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamSpec


def _dims(cfg: ModelConfig):
    E = cfg.d_inner
    N = cfg.ssm_state_dim
    H = cfg.ssm_heads
    P = cfg.ssm_head_dim
    W = cfg.ssm_conv_width
    return E, N, H, P, W


def mamba2_spec(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    E, N, H, P, W = _dims(cfg)
    conv_ch = E + 2 * N
    return {
        "in_proj": L.linear_spec(D, 2 * E + 2 * N + H, "embed", "ssm_inner"),
        "conv_w": ParamSpec((W, conv_ch), (None, "ssm_inner"), "normal", 1.0),
        "conv_b": ParamSpec((conv_ch,), ("ssm_inner",), "zeros"),
        "A_log": ParamSpec((H,), ("ssm_heads",), "ssm_a"),
        "D": ParamSpec((H,), ("ssm_heads",), "ones"),
        "dt_bias": ParamSpec((H,), ("ssm_heads",), "zeros"),
        "norm": L.rms_norm_spec(E),
        "out_proj": L.linear_spec(E, D, "ssm_inner", "embed"),
    }


def _split(cfg, proj):
    E, N, H, P, W = _dims(cfg)
    z = proj[..., :E]
    xBC = proj[..., E: 2 * E + 2 * N]
    dt_raw = proj[..., 2 * E + 2 * N:]
    return z, xBC, dt_raw


def _causal_conv(xBC, w, b):
    """Depthwise causal conv via W shifted adds. xBC: (B,S,C); w: (W,C)."""
    W = w.shape[0]
    S = xBC.shape[1]
    out = xBC * w[-1][None, None]
    for i in range(1, W):
        shifted = F.pad(xBC, (0, 0, i, 0))[:, :S]
        out = out + shifted * w[W - 1 - i][None, None]
    return F.silu(out + b[None, None])


def mamba2_full(p, cfg: ModelConfig, x, *, want_state: bool = False, impl=None):
    """x: (B,S,D) -> (y, (conv_state, ssm_state) | None)."""
    dt_c = L.torch_dtype(cfg.compute_dtype)
    B, S, D = x.shape
    E, N, H, P, W = _dims(cfg)
    proj = L.linear(p["in_proj"], x, dt_c)
    z, xBC, dt_raw = _split(cfg, proj)
    xBC_conv = _causal_conv(xBC, p["conv_w"].to(dt_c), p["conv_b"].to(dt_c))
    xs = xBC_conv[..., :E].reshape(B, S, H, P).contiguous()
    Bm = xBC_conv[..., E: E + N].contiguous()
    Cm = xBC_conv[..., E + N:].contiguous()
    # softplus in fp32, then the compute dtype, as the reference (ssm.py:73-75)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    y = ops.ssd(xs, dt.to(dt_c).contiguous(), p["A_log"], Bm, Cm, p["D"],
                chunk=cfg.ssm_chunk, impl=impl or "auto", return_state=want_state)
    state = None
    if want_state:
        y, ssm_state = y
        # last W-1 *pre-conv* inputs, zero-padded on the left when S < W-1
        conv_state = F.pad(xBC, (0, 0, max(W - 1 - S, 0), 0))[:, -(W - 1):]
        state = (conv_state.to(dt_c), ssm_state)
    y = y.reshape(B, S, E)
    y = L.rms_norm(p["norm"], y * F.silu(z), cfg.norm_eps)
    out = L.linear(p["out_proj"], y, dt_c)
    return out, state


def mamba2_decode(p, cfg: ModelConfig, x, conv_state, ssm_state):
    """x: (B,1,D); conv_state: (B,W-1,E+2N); ssm_state: (B,H,P,N) fp32.
    Returns (out, (new conv_state, new ssm_state)), both new tensors."""
    dt_c = L.torch_dtype(cfg.compute_dtype)
    B = x.shape[0]
    E, N, H, P, W = _dims(cfg)
    proj = L.linear(p["in_proj"], x, dt_c)
    z, xBC, dt_raw = _split(cfg, proj)                       # (B,1,*)
    window = torch.cat([conv_state, xBC.to(conv_state.dtype)], dim=1)   # (B,W,C)
    conv_w = p["conv_w"].to(dt_c)
    conv = torch.einsum("bwc,wc->bc", window.to(dt_c), conv_w) + p["conv_b"].to(dt_c)
    conv = F.silu(conv)
    xs = conv[:, :E].reshape(B, H, P)
    Bm = conv[:, E: E + N]
    Cm = conv[:, E + N:]
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"].float())
    y, ssm_state = ssd_step(xs, dt, p["A_log"], Bm, Cm, p["D"], ssm_state)
    y = y.reshape(B, 1, E)
    y = L.rms_norm(p["norm"], y * F.silu(z), cfg.norm_eps)
    out = L.linear(p["out_proj"], y, dt_c)
    return out, (window[:, 1:], ssm_state)
