"""Flash decode: the CUDA kernel ``csrc/decode_attention.cu``.

Port of ``repro/kernels/decode_attention.py::flash_decode`` (a Pallas TPU
kernel): one query token against a KV cache, masked at ``kv_len``.  The
kernel reads ``kv_len`` from a device int32, so a decode loop never syncs
the host.  For a tensor on the CPU the wrapper takes the plain version
(``ref.attention``); for a CUDA tensor it launches the kernel or raises.
MLA's absorbed decode (Hkv 1, Dq 576, Dv 512, 128 query heads) runs with
its head group tiled over CTAs (``heads_per_cta``) and its V a strided view
of K's rows.

The kernel splits the cache over ``num_splits`` CTAs per (batch, kv head),
then a second launch on the same stream combines their partials in a fixed
order (the source's header says how).  The split depends on the cache's
length alone: never on ``kv_len``, which stays on the device, and never on
the card, so a cache restored on another card decodes to the same bits.
The partials go to a workspace allocated for each call.  With
``return_lse`` the combine also writes each (batch, query head)'s
log-sum-exp of the scaled scores (float32, ``-inf`` where ``kv_len`` is 0),
which ``parallel/tp.merge_over_model`` needs to merge attention over blocks
of a cache split by position; the buffer is allocated only when asked.  For
``meta`` tensors the wrapper returns empty outputs of the kernel's shapes
and dtypes and launches nothing; a call charges ``costs.flash_decode`` to an
active cost recorder.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build, costs, ref
from repro_torch.kernels.flash_attention import DTYPES, SUPPORTED_DIMS as FLASH_DIMS

# head-dim pairs (Dq, Dv) the kernel is instantiated for: flash's, and MLA's
# absorbed decode (latent + rope, latent)
SUPPORTED_DIMS = FLASH_DIMS | {(576, 512)}

MAX_SMEM_BYTES = 232448     # dynamic shared memory a block may use on Hopper
SPLIT_TILE = 64             # cache positions per kernel tile; a split is a multiple
MAX_SPLITS = 32             # splits per (batch, kv head) before a split grows (and the .cu's)

launches = 0      # calls that launched the kernel pair (split, then combine)

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("decode_attention")
        fn = lib.decode_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                       + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.decode_attention_error_string.argtypes = [ctypes.c_int]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        lib.decode_attention_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.decode_attention_smem_bytes.restype = ctypes.c_longlong
        _fn = (fn, lib.decode_attention_error_string, lib.decode_attention_smem_bytes)
    return _fn


def split_size(S: int) -> int:
    """Cache positions per split: one tile up to S = 2048, then as many
    tiles as keep the count at MAX_SPLITS."""
    return SPLIT_TILE * max(1, -(-S // (SPLIT_TILE * MAX_SPLITS)))


def num_splits(S: int) -> int:
    """Splits per (batch, kv head) for a cache of S positions.  It takes no
    kv_len: a decode step never asks the host how far the cache is filled.
    At qwen2-0.5b's serving shape (S 1024) it is 16, a grid of 16 x Hkv x B
    CTAs."""
    return max(1, -(-S // split_size(S)))


@functools.lru_cache(maxsize=None)
def heads_per_cta(Dq: int, Dv: int, G: int, elt: int) -> int:
    """Query heads a CTA of the split kernel takes: the largest divisor of the
    group G whose fp32 q rows and accumulators fit in shared memory beside
    the K/V tiles (G itself at every GQA shape; 16 of 128 at MLA's absorbed
    shape in bfloat16), 0 where not even one head fits."""
    smem_bytes = _kernel()[2]
    for gh in range(G, 0, -1):
        if G % gh == 0 and smem_bytes(Dq, Dv, gh, elt) <= MAX_SMEM_BYTES:
            return gh
    return 0


def _kv_len_tensor(kv_len, S: int, device) -> torch.Tensor:
    if kv_len is None:
        return torch.full((), S, dtype=torch.int32, device=device)
    if isinstance(kv_len, torch.Tensor):
        if kv_len.numel() != 1 or kv_len.dtype != torch.int32 or kv_len.device != device:
            raise TypeError("flash_decode: kv_len must be one int32 on the cache's device, "
                            f"got {kv_len.dtype} {tuple(kv_len.shape)} on {kv_len.device}")
        return kv_len.reshape(()).contiguous()
    return torch.full((), int(kv_len), dtype=torch.int32, device=device)


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_decode: q, k, v must be 4-d (B,S,H,D)")
    B, Sq, H, Dq = q.shape
    S, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if Sq != 1:
        raise ValueError(f"flash_decode: one query token per sequence, got {Sq}")
    if tuple(k.shape) != (B, S, Hkv, Dq) or tuple(v.shape[:3]) != (B, S, Hkv):
        raise ValueError(f"flash_decode: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} do not match")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"flash_decode: {H} query heads are not a multiple of "
                         f"{Hkv} kv heads")
    if (Dq, Dv) not in SUPPORTED_DIMS:
        raise ValueError(f"flash_decode: head dims (Dq={Dq}, Dv={Dv}) not supported; "
                         f"supported: {sorted(SUPPORTED_DIMS)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_decode: dtypes {q.dtype}/{k.dtype}/{v.dtype}; the kernel "
                        "takes float32 or bfloat16, one dtype for q, k and v")
    if not (q.is_contiguous() and k.is_contiguous()):
        raise ValueError("flash_decode: q and k must be contiguous")
    unit = 16 // v.element_size()          # elements in 16 bytes
    if v.stride(3) != 1 or any(v.stride(i) % unit for i in range(3)):
        raise ValueError(f"flash_decode: v (strides {tuple(v.stride())}) must have a "
                         "contiguous last dimension and other strides of whole 16-byte units")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_decode: q, k, v must start on a 16-byte boundary")
    v_span = sum((n - 1) * st for n, st in zip(v.shape, v.stride())) + 1
    if max(q.numel(), k.numel(), v_span) >= 2**62:
        raise ValueError("flash_decode: tensor too large")


@costs.charged("flash_decode", costs.flash_decode_call)
def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 kv_len=None, scale=None, return_lse: bool = False):
    """q: (B,1,H,Dq); k: (B,S,Hkv,Dq); v: (B,S,Hkv,Dv) -> (B,1,H,Dv), and
    with ``return_lse`` also the float32 log-sum-exp (B,1,H) of the scaled
    scores (``ref.attention``'s).

    ``kv_len``: None (the whole cache), an int, or a 0-d int32 tensor on the
    cache's device; positions >= kv_len are masked.  q and k are
    contiguous; v may be a strided view (MLA passes the first Dv columns of
    k's rows) whose last dimension is contiguous."""
    global launches
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"flash_decode: q, k, v on different devices {devices}")
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=False, kv_len=kv_len, scale=scale,
                             return_lse=return_lse)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_decode: no kernel for device {q.device}")
    _check(q, k, v)
    B, _, H, Dq = q.shape
    S, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if scale is None:
        scale = 1.0 / float(np.sqrt(Dq))
    kvl = _kv_len_tensor(kv_len, S, q.device)
    out = torch.empty((B, 1, H, Dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, 1, H), dtype=torch.float32, device=q.device) if return_lse
           else None)
    if out.numel() == 0 or out.is_meta:
        return (out, lse) if return_lse else out
    fn, err_str, _ = _kernel()
    G = H // Hkv
    gh = heads_per_cta(Dq, Dv, G, q.element_size())
    if not gh:
        raise ValueError(f"flash_decode: one head at Dq={Dq}, Dv={Dv} in {q.dtype} needs "
                         "more shared memory than a block has")
    ns = num_splits(S)
    part = torch.empty(B * Hkv * ns * G * (Dv + 2), dtype=torch.float32, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kvl.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(), part.data_ptr(), B, S, H, Hkv, Dq, Dv, DTYPES[q.dtype], gh, v.stride(0),
             v.stride(1), v.stride(2), split_size(S), ns, float(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_decode: kernel launch failed: {err_str(err).decode()}")
    launches += 1
    return (out, lse) if return_lse else out
