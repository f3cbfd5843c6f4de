"""FLOP-exact blockwise causal attention in plain PyTorch (a loop over the
visible blocks), as ``repro/kernels/xla_attention.py``.

The CPU path for long sequences: memory is bounded by one (block_q x
block_k) score tile per step, and only *visible* (lower-triangular) blocks
are ever computed, so the work matches the causal-attention roofline instead
of double-counting masked blocks.  On the card the ``flash`` kernel is the
equivalent; this is not a port of a Pallas kernel (the reference's is XLA
code), so it has no kernel of its own.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def causal_blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale=None,
                     block_q: int = 1024, block_k: int = 1024) -> torch.Tensor:
    """q: (B,Sq,H,Dq)  k: (B,Skv,Hkv,Dq)  v: (B,Skv,Hkv,Dv) ; self-attention (Sq==Skv)."""
    B, Sq, H, Dq = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(Dq)
    block_q = min(block_q, Sq)
    block_k = min(block_k, Skv)
    # pad ragged sequences up to a block multiple; padded keys sit *after* all
    # real queries on the causal diagonal, so the causal mask hides them.
    pq = (-Sq) % block_q
    pk = (-Skv) % block_k
    if pq or pk:
        q = F.pad(q, (0, 0, 0, 0, 0, pq))
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
        out = causal_blockwise(q, k, v, scale=scale, block_q=block_q, block_k=block_k)
        return out[:, :Sq]
    nq, nk = Sq // block_q, Skv // block_k

    qg = q.reshape(B, Sq, Hkv, G, Dq).float()
    kf, vf = k.float(), v.float()
    out = []
    for i in range(nq):
        qs = i * block_q
        qb = qg[:, qs:qs + block_q]                                    # (B,bq,Hkv,G,Dq)
        qpos = qs + torch.arange(block_q, device=q.device)
        acc = torch.zeros((B, block_q, Hkv, G, Dv), dtype=torch.float32, device=q.device)
        m = torch.full((B, block_q, Hkv, G), -math.inf, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, block_q, Hkv, G), dtype=torch.float32, device=q.device)
        # the visible (q-block, k-block) pairs of this row, j ascending
        for j in range(nk):
            ks = j * block_k
            if ks > qs + block_q - 1:
                break
            s = torch.einsum("bqkgd,bskd->bqkgs", qb, kf[:, ks:ks + block_k]) * scale
            kpos = ks + torch.arange(block_k, device=q.device)
            mask = kpos[None, :] <= qpos[:, None]                      # (bq,bk)
            s = s.masked_fill(~mask[None, :, None, None, :], -math.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # rows with everything masked so far keep m=-inf; guard the exp
            alpha = torch.exp(torch.where(torch.isinf(m), -math.inf, m - m_new))
            p = torch.exp(s - m_new[..., None])
            p = torch.nan_to_num(p, nan=0.0)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bqkgs,bskd->bqkgd", p,
                                                        vf[:, ks:ks + block_k])
            m = m_new
        out.append(acc / torch.clamp(l[..., None], min=1e-37))
    return torch.cat(out, dim=1).reshape(B, Sq, H, Dv).to(q.dtype)
