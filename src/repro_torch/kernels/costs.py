"""The work of each hand-written kernel, and the recorder its wrapper charges.

One function per kernel gives ``(flops, bytes)`` for its shapes: the
operations it does and the bytes it must move (each input read once, each
output written once), whatever the card or the kernel's design.  They are
the bound column of ``chip_smoke.py``'s kernel table (with the constants of
``launch/roofline.py``) and the kernels' share of ``launch/hlo_costs.py``'s
walk.

A cost recorder (``recording``; ``None`` by default) is what the walk
installs: while one is active, each wrapper (``flash``, ``flash_decode``,
``ssd``, ``wkv6``, ``chunk_fingerprints``, ``checksum``) charges its formula
to it on any device (``charged``), and the operations the wrapper
dispatches inside the call (the plain version on the CPU, casts and padding
on the card) belong to that charge.  With no recorder a call costs one
context-variable read.
"""
from __future__ import annotations

import contextlib
import functools
from contextvars import ContextVar

import torch

_RECORDER = ContextVar("repro_torch_cost_recorder", default=None)


@contextlib.contextmanager
def recording(recorder):
    """Install ``recorder`` for the calls inside the block.  It has
    ``kernel(name, flops, nbytes)``, a context manager entered around each
    wrapper call."""
    token = _RECORDER.set(recorder)
    try:
        yield recorder
    finally:
        _RECORDER.reset(token)


@contextlib.contextmanager
def section(name: str):
    """Mark what runs inside the block as ``name``'s, for an active recorder
    that keeps sections (the walk's ``section``); otherwise nothing."""
    rec = _RECORDER.get()
    if rec is None or not hasattr(rec, "section"):
        yield
        return
    with rec.section(name):
        yield


class _Bound(torch.autograd.Function):
    """Identity on ``xs``; in the backward, the recorder's section ``name``
    opens (at the output's bound, ``opens``) or closes (at the inputs')."""

    @staticmethod
    def forward(ctx, rec, name, opens, *xs):
        ctx.rec, ctx.name, ctx.opens = rec, name, opens
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        if ctx.opens:
            ctx.rec.open_section(ctx.name)
        else:
            ctx.rec.close_section()
        return (None, None, None) + gs


def in_section(name: str, fn, *xs):
    """``fn(*xs)`` (tensors in, one tensor out) as section ``name``'s, for an
    active recorder that keeps sections: its forward inside ``section``, and
    its backward too, between two identity bounds whose backward opens and
    closes the section.  Autograd runs the nodes of one thread in the
    reverse order of their creation, so the ops between the bounds'
    backwards are those of ``fn``'s.  Without such a recorder, ``fn(*xs)``."""
    rec = _RECORDER.get()
    if rec is None or not hasattr(rec, "section"):
        return fn(*xs)
    xs = _Bound.apply(rec, name, False, *xs)
    with rec.section(name):
        out = fn(*xs)
    return _Bound.apply(rec, name, True, out)[0]


def charged(name: str, cost):
    """Decorator of a kernel wrapper: while a recorder is active, a call is
    charged ``cost(*args, **kwargs)`` = (flops, bytes) as kernel ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            rec = _RECORDER.get()
            if rec is None:
                return fn(*args, **kwargs)
            with rec.kernel(name, *cost(*args, **kwargs)):
                return fn(*args, **kwargs)
        return call
    return wrap


# ----------------------------------------------------------------------------------
# The formulas
# ----------------------------------------------------------------------------------


def flash(B: int, Sq: int, Skv: int, H: int, Hkv: int, Dq: int, Dv: int, elt: int,
          causal: bool = True) -> tuple[int, int]:
    """QK^T and PV over the (query, key) pairs the mask keeps (query i sees
    keys <= i when causal); q, k, v read once, the output written once."""
    if causal:
        n = min(Sq, Skv)
        pairs = n * (n + 1) // 2 + (Sq - n) * Skv
    else:
        pairs = Sq * Skv
    flops = 2 * B * H * pairs * (Dq + Dv)
    nbytes = elt * (B * Sq * H * (Dq + Dv) + B * Skv * Hkv * (Dq + Dv))
    return flops, nbytes


def flash_decode(B: int, S: int, H: int, Hkv: int, Dq: int, Dv: int, kv_len: int, elt: int,
                 v_is_k: bool = False, lse: bool = False) -> tuple[int, int]:
    """One query token against ``kv_len`` cache positions: q and the output
    once, K up to kv_len, V apart only where it is not a view of K's rows
    (MLA's absorbed decode), kv_len's own 4 bytes, and with ``lse`` the
    float32 log-sum-exp of each (batch, query head).  ``S``, the cache's
    length, does not enter: positions past kv_len are never read."""
    flops = 2 * B * H * kv_len * (Dq + Dv)
    v_bytes = 0 if v_is_k else B * kv_len * Hkv * Dv
    nbytes = (elt * (B * H * (Dq + Dv) + B * kv_len * Hkv * Dq + v_bytes) + 4
              + (4 * B * H if lse else 0))
    return flops, nbytes


def ssd_flops(B: int, S: int, H: int, P: int, N: int, Q: int = 64) -> int:
    """Operations of the chunked SSD form (chunk Q) on these shapes:
    lower-triangle scores, y, and the state update, per (batch, head)."""
    per = 0
    for t0 in range(0, S, Q):
        L = min(Q, S - t0)
        tri = L * (L + 1) // 2
        per += tri * (2 * N + 2) + tri * 2 * P + L * P * (2 * N + 4) + P * N * (3 * L + 2)
    return B * H * per


def ssd(B: int, S: int, H: int, P: int, N: int, elt: int, init_state: bool = False,
        state_out: bool = False) -> tuple[int, int]:
    """x, dt, Bm, Cm in and y out in ``elt`` bytes, A_log and D in float32,
    the float32 (B,H,P,N) state read and written where the call has them."""
    nbytes = (elt * (2 * B * S * H * P + B * S * H + 2 * B * S * N) + 8 * H
              + (int(init_state) + int(state_out)) * 4 * B * H * P * N)
    return ssd_flops(B, S, H, P, N), nbytes


def wkv6(B: int, S: int, H: int, D: int, elt: int, init_state: bool = False,
         state_out: bool = False) -> tuple[int, int]:
    """r, k, v, w in and y out in ``elt`` bytes, u in float32, the float32
    (B,H,D,D) state read and written where the call has them."""
    flops = B * S * H * (4 * D * D + 5 * D)
    nbytes = (elt * 5 * B * S * H * D + 4 * H * D
              + (int(init_state) + int(state_out)) * 4 * B * H * D * D)
    return flops, nbytes


def chunk_fingerprints(n: int, chunk_words: int) -> tuple[int, int]:
    """Six 32-bit integer operations a word; the words in, one word a chunk out."""
    return 6 * n, 4 * n + 4 * -(-n // chunk_words)


def checksum(n: int) -> tuple[int, int]:
    """Six 32-bit integer operations a word; the words in, one word out."""
    return 6 * n, 4 * n + 4


# ----------------------------------------------------------------------------------
# The formulas of a wrapper call, from its arguments
# ----------------------------------------------------------------------------------


def _same_storage(a, b) -> bool:
    return a.untyped_storage()._cdata == b.untyped_storage()._cdata


def flash_call(q, k, v, *, causal: bool = True, scale=None) -> tuple[int, int]:
    B, Sq, H, Dq = q.shape
    return flash(B, Sq, k.shape[1], H, k.shape[2], Dq, v.shape[-1], q.element_size(), causal)


def flash_decode_call(q, k, v, *, kv_len=None, scale=None,
                      return_lse=False) -> tuple[int, int]:
    """A ``kv_len`` held in a tensor is charged as the whole of ``k``'s
    positions: reading it would wait for the device, and on the meta device
    it has no value.  Where ``k`` is this rank's block of a cache split by
    position (``parallel/tp.seq_block``), that is the block's length."""
    B, _, H, Dq = q.shape
    S = k.shape[1]
    n = S if kv_len is None or hasattr(kv_len, "device") else int(kv_len)
    return flash_decode(B, S, H, k.shape[2], Dq, v.shape[-1], min(n, S), q.element_size(),
                        v_is_k=_same_storage(v, k), lse=return_lse)


def ssd_call(x, dt, A_log, Bm, Cm, D, *, init_state=None, return_state=False):
    B, S, H, P = x.shape
    return ssd(B, S, H, P, Bm.shape[-1], x.element_size(), init_state is not None,
               return_state)


def wkv6_call(r, k, v, w, u, *, init_state=None, return_state=False):
    B, S, H, D = r.shape
    return wkv6(B, S, H, D, r.element_size(), init_state is not None, return_state)


def chunk_fingerprints_call(words, chunk_words: int):
    return chunk_fingerprints(words.numel(), chunk_words)


def checksum_call(words, block: int = 2048):
    return checksum(words.numel())
