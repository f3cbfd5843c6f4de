"""Plain PyTorch versions of the kernels in this package.

Each is the ground truth its CUDA kernel is held against on the card
(``chip_smoke.py``, the ``gpu`` tests) and the path a wrapper takes for a
tensor that lies on the CPU.  Only ``attention`` is here so far: the other
oracles of ``repro/kernels/ref.py`` come with their kernels.
"""
from __future__ import annotations

import numpy as np
import torch


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, kv_len=None, scale=None,
              q_offset: int = 0) -> torch.Tensor:
    """Naive masked attention.

    q: (B,Sq,H,Dq)   k: (B,Skv,Hkv,Dq)   v: (B,Skv,Hkv,Dv)  with H % Hkv == 0.
    ``kv_len`` (an int or a 0-d tensor) masks cache positions >= kv_len.
    ``q_offset`` shifts the causal diagonal (query i attends keys <=
    q_offset + i).  Computed in fp32; the result is in q's dtype.
    """
    B, Sq, H, Dq = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    if scale is None:
        scale = 1.0 / np.sqrt(Dq)
    qg = q.reshape(B, Sq, Hkv, G, Dq).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * float(scale)
    mask = None
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + q_offset
        ki = torch.arange(Skv, device=q.device)[None, :]
        mask = ki <= qi
    if kv_len is not None:
        lm = torch.arange(Skv, device=q.device)[None, :] < kv_len
        mask = lm if mask is None else (mask & lm)
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), torch.zeros_like(p), p)   # fully-masked rows
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)
