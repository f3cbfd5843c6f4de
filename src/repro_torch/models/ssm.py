"""Mamba2 block (zamba2's backbone), as ``repro/models/ssm.py``.

Layout: in_proj -> [z | x | B | C | dt] ; causal depthwise conv over [x|B|C] ;
SSD scan ; gated RMSNorm ; out_proj.  Decode carries (conv window, ssm state).
The full-sequence scan goes through ``ops.ssd`` (the CUDA kernel on the
card); the one-token step is plain PyTorch (``ssd_step``), as in the
reference.

Where the step computes on "model" blocks (``tp.on_blocks``) and ``out_proj``
is this rank's block of rows (the rules' ``ssm_inner``), the mixer computes
on this rank's H/P heads where H divides the axis (``_heads``): the rules'
block of the fused in-projection is a run of its ``[z | x | B | C | dt]``
columns, not this rank's heads, so ``in_proj`` is read whole and only this
rank's z, x and dt columns and all of B and C are computed
(``tp.own_part``); the conv runs on those channels, the scan on those
heads, the gated RMSNorm sums its statistic over "model"
(``tp.sum_over_model``), and ``out_proj``, whose rows are head-major, is
row-parallel.  The serving state ``ssm`` is then this rank's heads (the
rules' ``ssm_heads_dim``); the conv window stays whole over "model" (the
decode step gathers the new token's x channels to append it).  Where H does
not divide the axis, every head is computed whole and cut to this rank's
rows of ``out_proj``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_step
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamSpec
from repro_torch.parallel import tp


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


def _split(proj, el: int, N: int):
    """``in_proj``'s output of ``el`` inner channels as (z, xBC, dt_raw)."""
    return proj[..., :el], proj[..., el: 2 * el + 2 * N], proj[..., 2 * el + 2 * N:]


def _causal_conv(xBC, w, b):
    """Depthwise causal conv via W shifted adds. xBC: (B,S,C); w: (W,C)."""
    W = w.shape[0]
    S = xBC.shape[1]
    out = xBC * w[-1][None, None]
    for i in range(1, W):
        shifted = F.pad(xBC, (0, 0, i, 0))[:, :S]
        out = out + shifted * w[W - 1 - i][None, None]
    return F.silu(out + b[None, None])


def _heads(p, cfg: ModelConfig):
    """(this rank's first head and head count, or ``None`` where it computes
    every head, the ``out_proj`` hints for ``_out``): a rank's H/P heads
    where the step computes on "model" blocks, ``out_proj`` is a block and H
    divides the axis; (None, (False, None)) off blocks."""
    if not tp.on_blocks():
        return None, (False, None)
    spec = mamba2_spec(cfg)["out_proj"]
    blk = tp.block_dim(p["out_proj"]["w"], spec["w"]) is not None
    r, n = tp.model_rank_size()
    H = cfg.ssm_heads
    return ((r * (H // n), H // n) if blk and H % n == 0 else None), (blk, spec)


def _in_proj(p, cfg: ModelConfig, x, dt_c, heads):
    """``in_proj`` of ``x``: every column, or with ``heads`` (first, count)
    this rank's ``[z | x | B | C | dt]``: its heads' z, x and dt columns and
    all of B and C, from the whole weight (``tp.own_part``)."""
    if heads is None:
        return L.linear(p["in_proj"], x, dt_c)
    E, N, H, P, W = _dims(cfg)
    h0, hl = heads
    w = tp.own_part(p["in_proj"]["w"], 1, [(h0 * P, hl * P), (E + h0 * P, hl * P),
                                           (2 * E, 2 * N), (2 * E + 2 * N + h0, hl)])
    tp.COUNTS["block_products"] += 1
    return tp.copy_to_model(x).to(dt_c) @ w.to(dt_c)


def _conv_params(p, cfg: ModelConfig, dt_c, heads):
    """``conv_w`` and ``conv_b`` on the channels of ``_in_proj``'s xBC."""
    if heads is None:
        return p["conv_w"].to(dt_c), p["conv_b"].to(dt_c)
    E, N, H, P, W = _dims(cfg)
    parts = [(heads[0] * P, heads[1] * P), (E, 2 * N)]
    return (tp.own_part(p["conv_w"], 1, parts).to(dt_c),
            tp.own_part(p["conv_b"], 0, parts).to(dt_c))


def _head_vectors(p, heads):
    """``A_log``, ``D`` and ``dt_bias`` of this rank's heads."""
    if heads is None:
        return p["A_log"], p["D"], p["dt_bias"]
    return tuple(tp.own_part(p[n], 0, [heads]) for n in ("A_log", "D", "dt_bias"))


def _out(p, cfg: ModelConfig, y, z, dt_c, heads, wo):
    """The gated RMSNorm of ``y * silu(z)`` over all of E, then ``out_proj``:
    on this rank's heads the statistic is summed over "model" and
    ``out_proj`` is row-parallel; where every head was computed and
    ``out_proj`` is a block, the normed output is cut to its rows."""
    blk, spec = wo
    if heads is None:
        y = L.rms_norm(p["norm"], y * F.silu(z), cfg.norm_eps)
        if blk:
            y = tp.scatter_to_model(y, -1)
        return L.linear(p["out_proj"], y, dt_c, spec)
    P = cfg.ssm_head_dim
    g = (y * F.silu(z)).float()
    var = tp.sum_over_model(torch.sum(g * g, dim=-1, keepdim=True)) / cfg.d_inner
    scale = tp.own_part(p["norm"]["scale"], 0, [(heads[0] * P, heads[1] * P)])
    y = (g * torch.rsqrt(var + cfg.norm_eps) * scale.float()).to(y.dtype)
    return L.linear(p["out_proj"], y, dt_c, spec)


def _whole_x(cfg: ModelConfig, xBC, heads):
    """Pre-conv ``xBC`` of ``_in_proj``'s channels made whole over "model"
    (the conv window's layout): this rank's x channels gathered."""
    if heads is None:
        return xBC
    el = heads[1] * cfg.ssm_head_dim
    return torch.cat([tp.gather_from_model(xBC[..., :el], -1), xBC[..., el:]], dim=-1)


def mamba2_full(p, cfg: ModelConfig, x, *, want_state: bool = False, impl=None):
    """x: (B,S,D) -> (y, (conv_state, ssm_state) | None).  On this rank's
    heads (``_heads``) the ssm state is theirs and the conv state whole."""
    dt_c = L.torch_dtype(cfg.compute_dtype)
    B, S, D = x.shape
    E, N, H, P, W = _dims(cfg)
    heads, wo = _heads(p, cfg)
    hl = H if heads is None else heads[1]
    el = hl * P
    proj = _in_proj(p, cfg, x, dt_c, heads)
    z, xBC, dt_raw = _split(proj, el, N)
    xBC_conv = _causal_conv(xBC, *_conv_params(p, cfg, dt_c, heads))
    xs = xBC_conv[..., :el].reshape(B, S, hl, P).contiguous()
    Bm = xBC_conv[..., el: el + N].contiguous()
    Cm = xBC_conv[..., el + N:].contiguous()
    A_log, Dp, dt_bias = _head_vectors(p, heads)
    # softplus in fp32, then the compute dtype, as the reference (ssm.py:73-75)
    dt = F.softplus(dt_raw.float() + dt_bias.float())
    y = ops.ssd(xs, dt.to(dt_c).contiguous(), A_log, Bm, Cm, Dp,
                chunk=cfg.ssm_chunk, impl=impl or "auto", return_state=want_state)
    state = None
    if want_state:
        y, ssm_state = y
        # last W-1 *pre-conv* inputs, zero-padded on the left when S < W-1
        conv_state = F.pad(xBC, (0, 0, max(W - 1 - S, 0), 0))[:, -(W - 1):]
        state = (_whole_x(cfg, conv_state, heads).to(dt_c), ssm_state)
    return _out(p, cfg, y.reshape(B, S, el), z, dt_c, heads, wo), state


def mamba2_decode(p, cfg: ModelConfig, x, conv_state, ssm_state):
    """x: (B,1,D); conv_state: (B,W-1,E+2N); ssm_state: (B,H,P,N) fp32, or
    this rank's heads of it (``_heads``; the conv state stays whole).
    Returns (out, (new conv_state, new ssm_state)), both new tensors."""
    dt_c = L.torch_dtype(cfg.compute_dtype)
    B = x.shape[0]
    E, N, H, P, W = _dims(cfg)
    heads, wo = _heads(p, cfg)
    hl = H if heads is None else heads[1]
    el = hl * P
    proj = _in_proj(p, cfg, x, dt_c, heads)
    z, xBC, dt_raw = _split(proj, el, N)
    own = conv_state if heads is None else \
        torch.cat([conv_state[..., heads[0] * P: heads[0] * P + el], conv_state[..., E:]], -1)
    window = torch.cat([own, xBC.to(conv_state.dtype)], dim=1)          # (B,W,C)
    conv_w, conv_b = _conv_params(p, cfg, dt_c, heads)
    conv = F.silu(torch.einsum("bwc,wc->bc", window.to(dt_c), conv_w) + conv_b)
    xs = conv[:, :el].reshape(B, hl, P)
    Bm = conv[:, el: el + N]
    Cm = conv[:, el + N:]
    A_log, Dp, dt_bias = _head_vectors(p, heads)
    dt = F.softplus(dt_raw[:, 0].float() + dt_bias.float())
    y, ssm_state = ssd_step(xs, dt, A_log, Bm, Cm, Dp, ssm_state)
    out = _out(p, cfg, y.reshape(B, 1, el), z, dt_c, heads, wo)
    new = _whole_x(cfg, xBC, heads).to(conv_state.dtype)
    return out, (torch.cat([conv_state[:, 1:], new], dim=1), ssm_state)
