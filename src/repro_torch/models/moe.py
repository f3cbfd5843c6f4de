"""Mixture-of-Experts FFN with capacity-based gather dispatch.

The reference's ``repro/models/moe.py`` in plain PyTorch: GShard-style
grouped routing, where the tokens are split into ``moe_groups`` routing
groups and each group computes its top-k assignments and packs its tokens
into per-expert capacity slots.  Dispatch and combine are gathers (real data
movement, not a one-hot einsum); the experts' products are batched matrix
products over the expert dimension.  The reference computes none of this in
a Pallas kernel, so there is no kernel to port here.

One difference from the reference, on purpose (ROADMAP §3 fault 8): where an
expert overflows, the reference's inverse map scatters the overflowing
(token, k) entries to slot 0 of that expert too, so the token that holds
slot 0 can lose its place.  Here only the valid entries are written: each
(expert, slot) keeps its token, and only the entries beyond capacity drop.

The steps are functions of their own (``route``, ``assign_slots``,
``dispatch``, ``expert_ffn``, ``combine``) so that a profile can attribute
device time to each.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamSpec
from repro_torch.parallel.collectives import group_sum


def moe_spec(cfg: ModelConfig) -> dict:
    D, E, Fd = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    s = {
        "router": ParamSpec((D, E), ("embed", None), "normal"),
        "wi_gate": ParamSpec((E, D, Fd), ("expert", "embed", "mlp"), "normal"),
        "wi_up": ParamSpec((E, D, Fd), ("expert", "embed", "mlp"), "normal"),
        "wo": ParamSpec((E, Fd, D), ("expert", "mlp", "embed"), "normal"),
    }
    if cfg.num_shared_experts:
        s["shared"] = L.swiglu_spec(D, cfg.moe_d_ff * cfg.num_shared_experts)
    return s


class _QuantTransport(torch.autograd.Function):
    """int8 round trip of the dispatched tokens (per-slot absmax scale in the
    compute dtype), as the reference's int8 dispatch all-to-all; on one
    device there is no all-to-all, so only the rounding remains.  The
    gradient passes straight through."""

    @staticmethod
    def forward(ctx, x):
        x32 = x.float()
        amax = torch.amax(torch.abs(x32), dim=-1, keepdim=True)
        scale = (torch.clamp(amax, min=1e-6) / 127.0).to(x.dtype)
        q = torch.clamp(torch.round(x32 / scale.float()), -127, 127).to(torch.int8)
        return q.to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


def quant_transport(x: torch.Tensor) -> torch.Tensor:
    return _QuantTransport.apply(x)


def capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    c = int(np.ceil(tokens_per_group * cfg.num_experts_per_tok
                    / cfg.num_experts * cfg.capacity_factor))
    return max(8, int(np.ceil(c / 8) * 8))


def groups(T: int, moe_groups: int) -> int:
    """The reference's group count: ``min(moe_groups, T)``, lowered until it
    divides T."""
    G = min(moe_groups, T)
    while T % G:
        G -= 1
    return G


def route(router_w: torch.Tensor, cfg: ModelConfig, xg: torch.Tensor, batch_group=None):
    """xg (G,Tg,D) -> (top_p (G,Tg,K) renormalised, top_e (G,Tg,K), aux loss),
    all in fp32; top-k sorted by descending probability.

    With ``batch_group`` (the ranks holding the other groups of the batch,
    as many tokens each), the aux loss is this rank's share of the whole
    batch's: the expert densities are averaged over the ranks, and the
    shares sum to the aux loss of all the groups together, in value and
    gradient."""
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    logits = torch.einsum("gtd,de->gte", xg.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, K, dim=-1, sorted=True)
    top_p = top_p / torch.clamp(torch.sum(top_p, dim=-1, keepdim=True), min=1e-9)
    # load-balance aux loss (Switch style)
    density = torch.mean(F.one_hot(top_e[..., 0], E).float(), dim=(0, 1))
    mean_prob = torch.mean(probs, dim=(0, 1))
    if batch_group is None:
        aux = torch.sum(density * mean_prob) * E * cfg.router_aux_weight
    else:
        R = dist.get_world_size(batch_group)
        aux = torch.sum(group_sum(density, batch_group) / R * mean_prob) * E \
            * cfg.router_aux_weight / R
    return top_p, top_e, aux


def assign_slots(flat_e: torch.Tensor, E: int, C: int, K: int):
    """flat_e (G,Tg*K): each entry's expert, in token-major routing order.

    Returns (slot (G,Tg*K), its place in the expert's queue, 0 where dropped;
    valid (G,Tg*K), within capacity; slot_tok (G,E*C), the token that fills
    each (expert, slot); slot_filled (G,E*C)).  Only valid entries are
    written to the inverse map (fault 8 of the reference)."""
    Gn, TK = flat_e.shape
    # the one-hot laid out expert-major, (G,E,Tg*K), so that the running count
    # of each expert's entries is a scan along the innermost dimension (a
    # scan along an outer one was most of granite-moe's prefill time on an H100)
    experts = torch.arange(E, device=flat_e.device)
    onehot = (flat_e[:, None, :] == experts[None, :, None]).to(torch.int32)
    pos_in_e = torch.cumsum(onehot, dim=2, dtype=torch.int32) - 1
    slot = torch.gather(pos_in_e, 1, flat_e[:, None, :])[:, 0, :].long()
    valid = slot < C
    slot = torch.where(valid, slot, torch.zeros_like(slot))
    # a dropped entry goes to a dump column past the last slot, then cut off
    target = torch.where(valid, flat_e * C + slot, torch.full_like(slot, E * C))
    tok_idx = torch.arange(TK, device=flat_e.device, dtype=torch.int64) // K
    slot_tok = torch.zeros((Gn, E * C + 1), dtype=torch.int64, device=flat_e.device)
    slot_tok.scatter_(1, target.long(), tok_idx.expand(Gn, TK))
    slot_filled = torch.zeros((Gn, E * C + 1), dtype=torch.bool, device=flat_e.device)
    slot_filled.scatter_(1, target.long(), valid)
    return slot, valid, slot_tok[:, :E * C], slot_filled[:, :E * C]


def dispatch(xg: torch.Tensor, slot_tok: torch.Tensor, slot_filled: torch.Tensor,
             E: int, C: int, quant: bool) -> torch.Tensor:
    """Gather each (expert, slot)'s token: (G,Tg,D) -> (G,E,C,D), zero where
    the slot is empty."""
    Gn, _, D = xg.shape
    xe = torch.gather(xg, 1, slot_tok[..., None].expand(Gn, E * C, D))
    xe = xe.reshape(Gn, E, C, D) * slot_filled.reshape(Gn, E, C, 1).to(xg.dtype)
    return quant_transport(xe) if quant else xe


def expert_ffn(p, xe: torch.Tensor, dt) -> torch.Tensor:
    """Each expert's SwiGLU over its C slots: (G,E,C,D) -> (G,E,C,D)."""
    x = xe.to(dt)
    g = torch.einsum("gecd,edf->gecf", x, p["wi_gate"].to(dt))
    u = torch.einsum("gecd,edf->gecf", x, p["wi_up"].to(dt))
    h = F.silu(g) * u
    return torch.einsum("gecf,efd->gecd", h, p["wo"].to(dt))


def combine(ye: torch.Tensor, flat_e: torch.Tensor, slot: torch.Tensor,
            valid: torch.Tensor, top_p: torch.Tensor, C: int, dt) -> torch.Tensor:
    """Weighted sum of each token's K expert outputs, in routing order, in
    the compute dtype: (G,E,C,D) -> (G,Tg,D)."""
    Gn, E, _, D = ye.shape
    TK = flat_e.shape[1]
    K = top_p.shape[-1]
    gathered = torch.gather(ye.reshape(Gn, E * C, D), 1,
                            (flat_e * C + slot).long()[..., None].expand(Gn, TK, D))
    w = (top_p.reshape(Gn, TK) * valid.float()).to(dt)
    contrib = gathered * w[..., None]
    return torch.sum(contrib.reshape(Gn, TK // K, K, D), dim=2)


def moe_ffn(p, cfg: ModelConfig, x: torch.Tensor, moe_groups: int, batch_group=None):
    """x: (B,S,D) -> (out, aux_loss).  Token order is preserved.
    ``batch_group``: see ``route``."""
    dt = L.torch_dtype(cfg.compute_dtype)
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    G = groups(T, moe_groups)
    Tg = T // G
    C = capacity(Tg, cfg)
    xg = x.reshape(G, Tg, D)

    top_p, top_e, aux = route(p["router"], cfg, xg, batch_group)
    flat_e = top_e.reshape(G, Tg * K)
    slot, valid, slot_tok, slot_filled = assign_slots(flat_e, E, C, K)
    xe = dispatch(xg, slot_tok, slot_filled, E, C, cfg.moe_dispatch_bits == 8)
    ye = expert_ffn(p, xe, dt)
    out = combine(ye, flat_e, slot, valid, top_p, C, dt)
    if cfg.num_shared_experts:
        out = out + L.swiglu(p["shared"], xg, dt)
    return out.reshape(B, S, D), aux
