"""Flash decode: the CUDA kernel ``csrc/decode_attention.cu``.

Port of ``repro/kernels/decode_attention.py::flash_decode`` (a Pallas TPU
kernel): one query token against a KV cache, masked at ``kv_len``.  The
kernel reads ``kv_len`` from a device int32, so a decode loop never syncs
the host.  For a tensor on the CPU the wrapper takes the plain version
(``ref.attention``); for a CUDA tensor it launches the kernel or raises.
MLA's absorbed decode shape (Hkv=1, Dq=576, Dv=512) is not supported yet.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_attention import DTYPES, SUPPORTED_DIMS

MAX_SMEM_BYTES = 232448     # dynamic shared memory a block may use on Hopper

launches = 0      # kernel launches made by this wrapper

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("decode_attention")
        fn = lib.decode_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.decode_attention_error_string.argtypes = [ctypes.c_int]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        lib.decode_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.decode_attention_smem_bytes.restype = ctypes.c_longlong
        _fn = (fn, lib.decode_attention_error_string, lib.decode_attention_smem_bytes)
    return _fn


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
        raise ValueError(f"flash_decode: head dims (Dq={Dq}, Dv={Dv}) not supported "
                         f"(MLA's absorbed shape comes with the MLA port); "
                         f"supported: {sorted(SUPPORTED_DIMS)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_decode: dtypes {q.dtype}/{k.dtype}/{v.dtype}; the kernel "
                        "takes float32 or bfloat16, one dtype for q, k and v")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_decode: q, k, v must be contiguous")
    if max(t.numel() for t in (q, k, v)) >= 2**62:
        raise ValueError("flash_decode: tensor too large")


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 kv_len=None, scale=None) -> torch.Tensor:
    """q: (B,1,H,Dq); k: (B,S,Hkv,Dq); v: (B,S,Hkv,Dv) -> (B,1,H,Dv).

    ``kv_len``: None (the whole cache), an int, or a 0-d int32 tensor on the
    cache's device; positions >= kv_len are masked."""
    global launches
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"flash_decode: q, k, v on different devices {devices}")
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=False, kv_len=kv_len, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: no kernel for device {q.device}")
    _check(q, k, v)
    B, _, H, Dq = q.shape
    S, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if scale is None:
        scale = 1.0 / float(np.sqrt(Dq))
    kvl = _kv_len_tensor(kv_len, S, q.device)
    out = torch.empty((B, 1, H, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn, err_str, smem_bytes = _kernel()
    if smem_bytes(Dq, Dv, H // Hkv) > MAX_SMEM_BYTES:
        raise ValueError(f"flash_decode: group of {H // Hkv} heads at Dq={Dq}, Dv={Dv} "
                         "needs more shared memory than a block has")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kvl.data_ptr(), out.data_ptr(),
             B, S, H, Hkv, Dq, Dv, DTYPES[q.dtype], float(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_decode: kernel launch failed: {err_str(err).decode()}")
    launches += 1
    return out
