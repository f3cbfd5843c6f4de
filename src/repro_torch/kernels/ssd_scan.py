"""Mamba2 SSD decode step.

``ssd_step`` advances the (B,H,P,N) fp32 state by one token, as
``repro/kernels/ssd_scan.py::ssd_step``.  The reference writes it as plain
einsums, not as a Pallas kernel, so it stays plain PyTorch here; the
full-sequence scan is the CUDA kernel behind ``kernels/ssd.py``.
"""
from __future__ import annotations

import torch


def ssd_step(x, dt, A_log, Bm, Cm, D, state):
    """Single decode step.  x:(B,H,P) dt:(B,H) Bm/Cm:(B,N) state:(B,H,P,N) fp32.
    Returns (y in x's dtype, new state)."""
    A = -torch.exp(A_log.float())
    xf, dtf = x.float(), dt.float()
    decay = torch.exp(dtf * A)                                        # (B,H)
    dbx = torch.einsum("bh,bn,bhp->bhpn", dtf, Bm.float(), xf)
    state = state * decay[..., None, None] + dbx
    y = torch.einsum("bhpn,bn->bhp", state, Cm.float())
    y = y + xf * D.float()[None, :, None]
    return y.to(x.dtype), state
