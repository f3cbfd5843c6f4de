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
from repro_torch.kernels import costs
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamSpec
from repro_torch.parallel import ep, tp
from repro_torch.parallel.collectives import group_sum
from repro_torch.parallel.context import current_rules


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


def splits_experts(cfg: ModelConfig, rules) -> bool:
    """The rules split the MoE experts over several ranks (``ep.expert_axes``
    of the experts' leaves is not empty)."""
    return cfg.num_experts > 0 and bool(
        ep.expert_axes(rules, moe_spec(cfg)["wi_gate"]))


def check_rows(cfg: ModelConfig, rules, batch_axes) -> None:
    """Raise where the experts split over mesh axes that do not split the
    batch's rows: the ranks of an all-to-all must each hold rows of their
    own (``parallel/ep.py``)."""
    ex = ep.expert_axes(rules, moe_spec(cfg)["wi_gate"])
    if not set(ex) <= set(batch_axes):
        raise ValueError(f"the experts split over {ex}, but the batch's rows over "
                         f"{tuple(batch_axes)}: every rank of the experts' all-to-all "
                         "must hold rows of its own")


class _QuantTransport(torch.autograd.Function):
    """int8 round trip of the dispatched tokens (per-slot absmax scale in the
    compute dtype), as the reference's int8 dispatch all-to-all; where the
    experts do not split over ranks there is no all-to-all
    (``parallel/ep.py``), so only the rounding remains.  The gradient
    passes straight through."""

    @staticmethod
    def forward(ctx, x):
        q, scale = ep.quantize(x)
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
    """Each expert's SwiGLU over its C slots: (G,E,C,D) -> (G,E,C,D).  On
    this rank's "model" block of ``moe_d_ff`` (gate and up column-parallel,
    wo row-parallel) the output is this rank's share of the sum over
    "model"."""
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


def _blocks(p, cfg: ModelConfig):
    """(whether the expert weights in ``p`` are this rank's experts only,
    whether they are its "model" block of ``moe_d_ff``): both False off
    ``tp.on_blocks`` or for whole weights (``ep.expert_block`` holds each
    to its spec)."""
    if not tp.on_blocks():
        return False, False
    spec = moe_spec(cfg)
    got = {ep.expert_block(p[k], spec[k]) for k in ("wi_gate", "wi_up", "wo")}
    if len(got) != 1:
        raise ValueError(f"the expert weights are blocks of different kinds: {sorted(got)}")
    return got.pop()


def _shared(p, cfg: ModelConfig, xg: torch.Tensor, dt) -> torch.Tensor:
    """DeepSeek's shared expert: a SwiGLU on "model" blocks where the step
    computes on them (``blocks._ffn``'s rule)."""
    spec = L.swiglu_spec(cfg.d_model, cfg.moe_d_ff * cfg.num_shared_experts) \
        if tp.on_blocks() else None
    return L.swiglu(p["shared"], xg, dt, spec)


def moe_ffn(p, cfg: ModelConfig, x: torch.Tensor, moe_groups: int, batch_group=None,
            row_axes=None):
    """x: (B,S,D) -> (out, aux_loss).  Token order is preserved.
    ``batch_group``: see ``route``.

    Where the step computes on blocks (``tp.on_blocks``) and ``p`` holds this
    rank's experts (``parallel/ep.py``), the dispatched slots move to their
    experts' ranks and back by all-to-alls; where it holds their "model"
    block of ``moe_d_ff``, the experts run on it and the combined output is
    summed over "model".  Routing stays on this rank's groups.

    ``row_axes`` (decode, where the B rows are one routing group): the mesh
    axes that split the batch's rows, () where this rank holds all of them;
    see ``_decode_one_group``."""
    if row_axes is not None and (row_axes or any(_blocks(p, cfg))):
        return _decode_one_group(p, cfg, x, tuple(row_axes)), None
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
    on_experts, on_model = _blocks(p, cfg)
    quant = cfg.moe_dispatch_bits == 8
    spec = moe_spec(cfg)["wi_gate"]

    def routed(xg, top_p):
        if on_model:       # the slots' gradient, and the weights', summed over "model"
            xg, top_p = tp.copy_to_model(xg), tp.copy_to_model(top_p)
            tp.COUNTS["block_products"] += 3
        xe = dispatch(xg, slot_tok, slot_filled, E, C, quant and not on_experts)
        if on_experts:
            xe = ep.to_experts(xe, spec, quant)
        ye = expert_ffn(p, xe, dt)
        if on_experts:
            ye = ep.from_experts(ye, spec)
        out = combine(ye, flat_e, slot, valid, top_p, C, dt)
        return tp.reduce_from_model(out) if on_model else out

    out = costs.in_section("experts", routed, xg, top_p)
    if cfg.num_shared_experts:
        out = out + _shared(p, cfg, xg, dt)
    return out.reshape(B, S, D), aux


def _reduce_scatter_rows(part: torch.Tensor, group) -> torch.Tensor:
    """(B,D) partials summed over ``group``, rank r keeping rows block r."""
    out = part.new_empty((part.shape[0] // dist.get_world_size(group),) + part.shape[1:])
    dist.reduce_scatter_tensor(out, part.contiguous(), group=group)
    return out


def _decode_one_group(p, cfg: ModelConfig, x: torch.Tensor, row_axes: tuple) -> torch.Tensor:
    """A decode step's MoE FFN over ranks, as the reference routes it: the B
    rows of the whole batch as one group (its capacity from all B tokens).
    ``x`` (B/R,1,D) is this rank's rows, split over the mesh axes
    ``row_axes`` (R ranks; () where it holds all of them).  The rows'
    input is gathered over ``rows``, all B are routed alike on every rank,
    this rank computes the slots of its experts (all, or its block over the
    expert axes) on its block of ``moe_d_ff``, and forms each row's partial
    combine over them; the partials are summed over the expert axes and cut
    to this rank's rows (one reduce-scatter where the expert axes are the
    rows' axes), then summed over "model".  The shared expert runs on this
    rank's rows.  Returns (B/R,1,D); no grad (decode)."""
    dt = L.torch_dtype(cfg.compute_dtype)
    Bl, _, D = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    rules = current_rules()
    rows = rules.mesh.group(row_axes) if row_axes else None
    xg = x.reshape(1, Bl, D)
    xa = xg if rows is None else tp._all_gather(xg, 1, rows)
    B = xa.shape[1]
    C = capacity(B, cfg)
    top_p, top_e, _ = route(p["router"], cfg, xa)
    flat_e = top_e.reshape(1, B * K)
    slot, valid, slot_tok, slot_filled = assign_slots(flat_e, E, C, K)
    on_experts, on_model = _blocks(p, cfg)
    spec = moe_spec(cfg)["wi_gate"]
    El = p["wi_gate"].shape[0]
    e0 = ep.expert_rank_size(spec)[0] * El if on_experts else 0

    def routed(xa, top_p):
        mine = slice(e0 * C, (e0 + El) * C)
        xe = dispatch(xa, slot_tok[:, mine], slot_filled[:, mine], El, C,
                      cfg.moe_dispatch_bits == 8)
        ye = expert_ffn(p, xe, dt)
        tp.COUNTS["block_products"] += 3 if on_model else 0
        here = (flat_e >= e0) & (flat_e < e0 + El)
        local_e = torch.where(here, flat_e - e0, torch.zeros_like(flat_e))
        part = combine(ye, local_e, slot, valid & here, top_p, C, dt)[0]    # (B,D)
        ex_axes = ep.expert_axes(rules, spec) if on_experts else ()
        if ex_axes:
            group = ep.expert_group(spec)
            if ex_axes == row_axes:
                part = _reduce_scatter_rows(part, group)
                return tp.reduce_from_model(part) if on_model else part
            dist.all_reduce(part, group=group)
        if rows is not None:
            part = part.chunk(dist.get_world_size(rows))[dist.get_rank(rows)]
        return tp.reduce_from_model(part) if on_model else part

    out = costs.in_section("experts", routed, xa, top_p)[:, None]
    if cfg.num_shared_experts:
        out = out + _shared(p, cfg, xg, dt).reshape(Bl, 1, D)
    return out
