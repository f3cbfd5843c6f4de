"""Flash attention forward: the CUDA kernel ``csrc/flash_attention.cu``.

Port of ``repro/kernels/flash_attention.py::flash`` (a Pallas TPU kernel).
The source's header says how the Hopper design differs from the TPU one.
For a tensor on the CPU the wrapper takes the plain version
(``ref.attention``); for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build, ref

# head-dim pairs (Dq, Dv) the kernel is instantiated for
SUPPORTED_DIMS = frozenset([(dq, dv) for dq in (32, 64, 128) for dv in (32, 64, 128)]
                           + [(192, 128)])
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0      # kernel launches made by this wrapper

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("flash_attention")
        fn = lib.flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.flash_attention_error_string)
    return _fn


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash: q, k, v must be 4-d (B,S,H,D)")
    B, Sq, H, Dq = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if tuple(k.shape) != (B, Skv, Hkv, Dq) or tuple(v.shape[:3]) != (B, Skv, Hkv):
        raise ValueError(f"flash: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} do not match")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"flash: {H} query heads are not a multiple of {Hkv} kv heads")
    if (Dq, Dv) not in SUPPORTED_DIMS:
        raise ValueError(f"flash: head dims (Dq={Dq}, Dv={Dv}) not supported; "
                         f"supported: {sorted(SUPPORTED_DIMS)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash: dtypes {q.dtype}/{k.dtype}/{v.dtype}; the kernel "
                        "takes float32 or bfloat16, one dtype for q, k and v")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash: q, k, v must be contiguous")
    if max(t.numel() for t in (q, k, v)) >= 2**62:
        raise ValueError("flash: tensor too large")


def flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
          causal: bool = True, scale=None) -> torch.Tensor:
    """q: (B,Sq,H,Dq); k: (B,Skv,Hkv,Dq); v: (B,Skv,Hkv,Dv) -> (B,Sq,H,Dv)."""
    global launches
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"flash: q, k, v on different devices {devices}")
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash: no kernel for device {q.device}")
    _check(q, k, v)
    B, Sq, H, Dq = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if scale is None:
        scale = 1.0 / float(np.sqrt(Dq))
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn, err_str = _kernel()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             B, Sq, Skv, H, Hkv, Dq, Dv, DTYPES[q.dtype], int(bool(causal)),
             float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash: kernel launch failed: {err_str(err).decode()}")
    launches += 1
    return out
