"""Mamba2 SSD scan: the CUDA kernel ``csrc/ssd_scan.cu``.

Port of ``repro/kernels/_ssd_pallas.py::ssd_pallas`` (a Pallas TPU kernel),
with the contract of ``ref.ssd``.  The source's header says how the Hopper
design differs from the TPU one.  For tensors on the CPU the wrapper takes
the plain version (``ref.ssd``, the sequential recurrence); for CUDA tensors
it launches the kernel or raises.  There is no backward: the reference has
no backward kernel for this scan, and training the SSM families is later
work, so a CUDA input that requires a gradient raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.decode_attention import MAX_SMEM_BYTES
from repro_torch.kernels.flash_attention import DTYPES

launches = 0      # kernel launches made by this wrapper

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("ssd_scan")
        fn = lib.ssd_scan_fwd
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
        _fn = (fn, lib.ssd_scan_error_string, lib.ssd_scan_smem_bytes)
    return _fn


def _check(x, dt, A_log, Bm, Cm, D, init_state):
    if x.ndim != 4:
        raise ValueError("ssd: x must be 4-d (B,S,H,P)")
    B, S, H, P = x.shape
    N = Bm.shape[-1] if Bm.ndim == 3 else -1
    want = {"dt": (dt, (B, S, H)), "Bm": (Bm, (B, S, N)), "Cm": (Cm, (B, S, N)),
            "A_log": (A_log, (H,)), "D": (D, (H,))}
    if init_state is not None:
        want["init_state"] = (init_state, (B, H, P, N))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"ssd: {name} has shape {tuple(t.shape)}, expected {shape} "
                             f"for x {tuple(x.shape)}")
    if x.dtype not in DTYPES or any(t.dtype != x.dtype for t in (dt, Bm, Cm)):
        raise TypeError(f"ssd: dtypes x {x.dtype} dt {dt.dtype} Bm {Bm.dtype} Cm {Cm.dtype}; "
                        "the kernel takes float32 or bfloat16, one dtype for the four")
    if not all(t.is_contiguous() for t in (x, dt, Bm, Cm)):
        raise ValueError("ssd: x, dt, Bm, Cm must be contiguous")
    if max(t.numel() for t in (x, Bm)) >= 2**62:
        raise ValueError("ssd: tensor too large")


def ssd(x, dt, A_log, Bm, Cm, D, *, init_state=None, return_state=False):
    """Contract of ``ref.ssd``: x (B,S,H,P), dt (B,S,H), A_log (H,), Bm/Cm
    (B,S,N), D (H,), init_state (B,H,P,N) fp32 or None -> y (B,S,H,P) in
    x's dtype, and the fp32 final state if ``return_state``."""
    global launches
    tensors = [t for t in (x, dt, A_log, Bm, Cm, D, init_state) if t is not None]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"ssd: inputs on different devices {devices}")
    if x.device.type == "cpu":
        return ref.ssd(x, dt, A_log, Bm, Cm, D, init_state=init_state,
                       return_state=return_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd: no kernel for device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("ssd: the CUDA kernel has no backward; training the SSM "
                           "families is not ported yet")
    _check(x, dt, A_log, Bm, Cm, D, init_state)
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    A_log = A_log.to(torch.float32).contiguous()
    D = D.to(torch.float32).contiguous()
    if init_state is not None:
        init_state = init_state.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        state.copy_(init_state if init_state is not None else torch.zeros_like(state))
        return (y, state) if return_state else y
    fn, err_str, smem_bytes = _kernel()
    if smem_bytes(P, N) > MAX_SMEM_BYTES:
        raise ValueError(f"ssd: P={P}, N={N} need more shared memory than a block has")
    err = fn(x.data_ptr(), dt.data_ptr(), A_log.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
             D.data_ptr(), init_state.data_ptr() if init_state is not None else None,
             y.data_ptr(), state.data_ptr(), B, S, H, P, N, DTYPES[x.dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd: kernel launch failed: {err_str(err).decode()}")
    launches += 1
    return (y, state) if return_state else y
