"""Ring attention (context parallelism) over a mesh axis, as
``repro/kernels/ring_attention.py``.

Archs whose head counts don't divide the model axis (qwen2: 14 q heads, 2 kv
heads) would otherwise compute the full S^2 attention on every model rank.
Ring attention shards the SEQUENCE over the axis instead: each rank holds
S/P queries and S/P keys/values, and the KV blocks rotate around the ring
(``batch_isend_irecv`` over the axis's process group) while an online softmax
in float32 accumulates.  Causality: every block pair is computed and masked,
as the reference's v1 does.

``ring_attention_local`` is the reference's shard_map body on the local
shards; ``ring_attention`` takes the whole sequence on every rank of the
ring, keeps this rank's S/P block, and returns the whole output, as the
reference's wrapper does around shard_map.  Under autograd the rotation's
backward sends the gradient the other way, and the split and gather's
backwards keep each input's gradient whole and unscaled on every rank.

This is not a port of a Pallas kernel (the reference's ring is XLA code):
each block is plain PyTorch.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist


def _block_attend(q, k, v, q_off, k_off, scale, causal):
    """One masked flash block in fp32.  q: (B,Sq,Hkv,G,D) k/v: (B,Sk,Hkv,D)."""
    s = torch.einsum("bqkgd,bskd->bqkgs", q, k) * scale
    if causal:
        qpos = q_off + torch.arange(q.shape[1], device=q.device)
        kpos = k_off + torch.arange(k.shape[1], device=q.device)
        mask = kpos[None, :] <= qpos[:, None]                  # (Sq,Sk)
        s = s.masked_fill(~mask[None, :, None, None, :], -math.inf)
    m = s.amax(dim=-1)
    # fully-masked rows: exp(-inf - -inf) guards
    m_safe = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(torch.where(torch.isinf(s), torch.full_like(s, -math.inf),
                              s - m_safe[..., None]))
    p = torch.nan_to_num(p, nan=0.0)
    l = p.sum(dim=-1)
    pv = torch.einsum("bqkgs,bskd->bqkgd", p, v)
    return torch.where(torch.isinf(m), torch.full_like(m, -math.inf), m_safe), l, pv


def _ring_shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """``x`` sent to the rank ``step`` places on in ``group``'s order, and the
    block of the rank ``step`` places back received."""
    P, me = dist.get_world_size(group), dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, (me + step) % P),
                      group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (me - step) % P), group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return out


class _Permute(torch.autograd.Function):
    """The ring's rotation (ppermute j -> j+1); its transpose rotates back."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _ring_shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _ring_shift(g, ctx.group, -1), None


def _gather_blocks(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _own_block(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    P, me = dist.get_world_size(group), dist.get_rank(group)
    n = x.shape[dim] // P
    return x.narrow(dim, me * n, n)


class _Split(torch.autograd.Function):
    """This rank's block of a tensor every rank of ``group`` holds whole; the
    backward gathers the blocks' gradients, so the input's is whole."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _own_block(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_blocks(g, ctx.group, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    """The blocks of ``group``'s ranks, joined; the backward keeps this rank's
    block of a gradient that every rank holds whole (not their sum)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather_blocks(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _own_block(g, ctx.group, ctx.dim).contiguous(), None, None


def ring_attention_local(q, k, v, *, group=None, scale=None, causal: bool = True):
    """q/k/v: LOCAL shards (B, S/P, H|Hkv, D) of a sequence split over the
    ranks of ``group`` in its rank order (``None``: one rank).  Returns the
    local out (B, S/P, H, Dv)."""
    P = 1 if group is None else dist.get_world_size(group)
    idx = 0 if group is None else dist.get_rank(group)
    B, Sq, H, Dq = q.shape
    Hkv, Dv = k.shape[2], v.shape[-1]
    G = H // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(Dq)
    qg = q.reshape(B, Sq, Hkv, G, Dq).float()
    q_off = idx * Sq

    acc = torch.zeros((B, Sq, Hkv, G, Dv), dtype=torch.float32, device=q.device)
    m = torch.full((B, Sq, Hkv, G), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Sq, Hkv, G), dtype=torch.float32, device=q.device)
    kb, vb = k, v
    for i in range(P):
        src = (idx - i) % P                     # rank that produced this block
        bm, bl, bpv = _block_attend(qg, kb.float(), vb.float(), q_off, src * kb.shape[1],
                                    scale, causal)
        m_new = torch.maximum(m, bm)
        alpha = torch.exp(torch.where(torch.isinf(m), torch.full_like(m, -math.inf), m - m_new))
        beta = torch.exp(torch.where(torch.isinf(bm), torch.full_like(bm, -math.inf),
                                     bm - m_new))
        l = l * alpha + bl * beta
        acc = acc * alpha[..., None] + bpv * beta[..., None]
        m = m_new
        if i + 1 < P:                           # the last rotation's blocks go unused
            kb = _Permute.apply(kb, group)
            vb = _Permute.apply(vb, group)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, Sq, H, Dv).to(q.dtype)


def ring_attention(q, k, v, *, mesh, axis: str = "model", scale=None,
                   causal: bool = True) -> torch.Tensor:
    """Attention over the whole sequence, computed as a ring over the ranks
    along ``axis`` of ``mesh``: q/k/v (B, S, H|Hkv, D) are the same on every
    rank of the ring; each rank keeps its S/P block, the ring runs, and the
    blocks of the output are gathered back, so every rank returns the whole
    (B, S, H, Dv).  S must divide by the axis's size.  The batch is not
    split: every rank of the ring holds its batch rows whole."""
    group = mesh.group((axis,))
    if group is None:
        return ring_attention_local(q, k, v, scale=scale, causal=causal)
    P = dist.get_world_size(group)
    if q.shape[1] % P:
        raise ValueError(f"sequence {q.shape[1]} does not split over {P} ranks of {axis!r}")
    ql, kl, vl = (_Split.apply(x, group, 1) for x in (q, k, v))
    return _Gather.apply(ring_attention_local(ql, kl, vl, group=group, scale=scale,
                                              causal=causal), group, 1)

