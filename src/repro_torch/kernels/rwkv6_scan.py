"""RWKV6 WKV decode step.

``wkv6_step`` advances the (B,H,D,D) fp32 state by one token, as
``repro/kernels/rwkv6_scan.py::wkv6_step``.  The reference writes it as
plain einsums, not as a Pallas kernel, so it stays plain PyTorch here; the
full-sequence recurrence is the CUDA kernel behind ``kernels/wkv6.py``.
"""
from __future__ import annotations

import torch


def wkv6_step(r, k, v, w, u, state):
    """Single decode step.  r/k/v/w: (B,H,D); u: (H,D); state: (B,H,D,D) fp32.
    Returns (y in r's dtype, new state)."""
    rf, kf, vf, wf = (z.float() for z in (r, k, v, w))
    kv = torch.einsum("bhk,bhv->bhkv", kf, vf)
    y = torch.einsum("bhk,bhkv->bhv", rf, state + u.float()[None, :, :, None] * kv)
    state = state * wf[..., None] + kv
    return y.to(r.dtype), state
