"""Plain PyTorch versions of the kernels in this package.

Each is the ground truth its CUDA kernel is held against on the card
(``chip_smoke.py``, the ``gpu`` tests) and the path a wrapper takes for a
tensor that lies on the CPU: ``attention``, the two sequential SSM
recurrences ``ssd`` (Mamba2) and ``wkv6`` (RWKV6), ``checksum`` and
``chunk_fingerprints``, with the contracts of ``repro/kernels/ref.py``.
"""
from __future__ import annotations

import numpy as np
import torch

PRIME = 16777619
_M32 = 0xFFFFFFFF


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, kv_len=None, scale=None,
              q_offset: int = 0, return_lse: bool = False):
    """Naive masked attention.

    q: (B,Sq,H,Dq)   k: (B,Skv,Hkv,Dq)   v: (B,Skv,Hkv,Dv)  with H % Hkv == 0.
    ``kv_len`` (an int or a 0-d tensor) masks cache positions >= kv_len.
    ``q_offset`` shifts the causal diagonal (query i attends keys <=
    q_offset + i).  Computed in fp32; the result is in q's dtype.

    ``return_lse``: also the float32 natural-log log-sum-exp of each
    query's scaled, masked scores, (B,Sq,H): what merges the outputs of
    attention over disjoint blocks of the keys.  A query with no key
    (``kv_len`` 0) has an output of zeros and an lse of ``-inf``.
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
    o = o.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.logsumexp(s, dim=-1)                  # (B,Hkv,G,Sq); -inf where no key
    return o, lse.permute(0, 3, 1, 2).reshape(B, Sq, H)


def recompute_grads(plain, saved, need, grad_outputs, **kw):
    """The backward of a kernel wrapper (``_Flash``, ``_SSD``, ``_WKV6``):
    ``plain(*saved, **kw)`` run again under autograd from the saved inputs,
    then differentiated for ``grad_outputs`` (one per output; ``None`` for an
    output that got no gradient).  Returns one gradient per saved input, in
    its own dtype, ``None`` where ``need`` is false.  The result is the
    plain version's own gradient, bit for bit: the same operations on the
    same values."""
    inputs = [t.detach().requires_grad_(bool(n)) for t, n in zip(saved, need)]
    wrt = [t for t in inputs if t.requires_grad]
    with torch.enable_grad():
        out = plain(*inputs, **kw)
    outs = out if isinstance(out, tuple) else (out,)
    pairs = [(o, g) for o, g in zip(outs, grad_outputs) if g is not None]
    if not wrt or not pairs:
        return tuple(None for _ in inputs)
    grads = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                     allow_unused=True))
    return tuple(next(grads) if t.requires_grad else None for t in inputs)


# ----------------------------------------------------------------------------------
# Mamba2 SSD: sequential recurrence over time.
# ----------------------------------------------------------------------------------


def ssd(x, dt, A_log, Bm, Cm, D, *, init_state=None, return_state=False):
    """Mamba2 selective-state-space recurrence, one step at a time, in fp32.

    x:  (B,S,H,P)   channels grouped into H heads of dim P
    dt: (B,S,H)     softplus-activated step sizes (already positive)
    A_log: (H,)     state decay (A = -exp(A_log))
    Bm: (B,S,N)     input matrix  (single group)
    Cm: (B,S,N)     output matrix (single group)
    D:  (H,)        skip
    state: (B,H,P,N) fp32; y in x's dtype.

    ``ssd_step``'s arithmetic, with only the recurrence itself,
    state_t = state_{t-1} * exp(dt_t A) + dt_t B_t x_t, left in the loop over
    time: the decays, the inputs and the read-out C_t . state_t run once over
    the whole sequence.  This is also the backward of the ``ssd`` kernel
    (recomputed under autograd), where two operations a step keep the
    graph, and the host's launches, short."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    state = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    if S == 0:
        y = x.new_zeros(x.shape)
        return (y, state) if return_state else y
    A = -torch.exp(A_log.float())
    xf, dtf = x.float(), dt.float()
    decay = torch.exp(dtf * A)[..., None, None].unbind(1)                 # S x (B,H,1,1)
    dbx = torch.einsum("bsh,bsn,bshp->bshpn", dtf, Bm.float(), xf).unbind(1)
    states = []
    for t in range(S):
        state = state * decay[t] + dbx[t]
        states.append(state)
    y = torch.einsum("bshpn,bsn->bshp", torch.stack(states, dim=1), Cm.float())
    y = (y + xf * D.float()[None, None, :, None]).to(x.dtype)
    return (y, state) if return_state else y


# ----------------------------------------------------------------------------------
# RWKV6 WKV: sequential recurrence over time.
# ----------------------------------------------------------------------------------


def wkv6(r, k, v, w, u, *, init_state=None, return_state=False):
    """RWKV6 recurrence, one step at a time, in fp32.

    r,k,v: (B,S,H,D)    w: (B,S,H,D) per-step decay in (0,1)    u: (H,D) bonus.
    state: (B,H,D,D)  maps k-dim -> v-dim.
    y_t = r_t . (state + u*k_t v_t^T);  state' = diag(w_t) state + k_t v_t^T

    ``wkv6_step``'s arithmetic, with only the state update left in the loop
    over time (the outer products k_t v_t^T and the read-outs run once over
    the whole sequence); also the backward of the ``wkv6`` kernel, as
    ``ssd``'s."""
    B, S, H, D = r.shape
    state = (torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
             if init_state is None else init_state.float())
    if S == 0:
        y = r.new_zeros(r.shape)
        return (y, state) if return_state else y
    rf, kf, vf, wf = (z.float() for z in (r, k, v, w))
    kv = torch.einsum("bshk,bshv->bshkv", kf, vf)
    kvs, ws = kv.unbind(1), wf[..., None].unbind(1)
    before = []                                       # the state each token reads
    for t in range(S):
        before.append(state)
        state = state * ws[t] + kvs[t]
    read = torch.stack(before, dim=1) + u.float()[None, None, :, :, None] * kv
    y = torch.einsum("bshk,bshkv->bshv", rf, read).to(r.dtype)
    return (y, state) if return_state else y


# ----------------------------------------------------------------------------------
# Checkpoint checksum and chunk fingerprints (FNV-style mix over uint32 words).
#
# PyTorch has no wrapping uint32 arithmetic on every device (a uint32 sum
# widens to int64 on the CPU, and shifts refuse UInt32), so words are held in
# int64 as values in [0, 2^32) and every product and sum is masked back to 32
# bits.  Products of two such values would overflow int64; ``_mul32`` splits
# one factor into 16-bit halves so no intermediate passes 2^49.
# ----------------------------------------------------------------------------------


def _u32(words: torch.Tensor) -> torch.Tensor:
    """int32/uint32 words as int64 values in [0, 2^32)."""
    return words.to(torch.int64) & _M32


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 tensors holding values in [0, 2^32)."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix(w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return _mul32(w ^ ((idx * PRIME) & _M32), idx | 1)


def _xor_reduce(m: torch.Tensor) -> torch.Tensor:
    """XOR over the last dim, by halving folds (zero columns pad it to a
    power of two; XOR with 0 changes nothing)."""
    n = m.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        m = torch.nn.functional.pad(m, (0, width - n))
    while m.shape[-1] > 1:
        half = m.shape[-1] // 2
        m = m[..., :half] ^ m[..., half:]
    return m[..., 0]


def _to_int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as int32 tensors holding the same 32 bits."""
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def checksum(words: torch.Tensor) -> torch.Tensor:
    """(N,) int32/uint32 words -> 0-d int32 holding the uint32 digest:
    XOR + SUM (mod 2^32) of each word mixed with its global index."""
    w = _u32(words.reshape(-1))
    idx = torch.arange(w.numel(), dtype=torch.int64, device=w.device) & _M32
    m = _mix(w, idx)
    return _to_int32_bits((_xor_reduce(m) + (m.sum() & _M32)) & _M32)


def chunk_fingerprints(words: torch.Tensor, chunk_words: int) -> torch.Tensor:
    """(N,) int32/uint32 words -> (ceil(N / chunk_words),) int32 holding one
    uint32 per chunk: the same mix with the index local to the chunk; a
    ragged tail is zero-padded."""
    w = _u32(words.reshape(-1))
    pad = (-w.numel()) % chunk_words
    if pad:
        w = torch.nn.functional.pad(w, (0, pad))
    w = w.reshape(-1, chunk_words)
    idx = torch.arange(chunk_words, dtype=torch.int64, device=w.device)[None, :]
    m = _mix(w, idx)
    return _to_int32_bits((_xor_reduce(m) + (m.sum(dim=1) & _M32)) & _M32)
