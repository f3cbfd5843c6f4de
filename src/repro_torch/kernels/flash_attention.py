"""Flash attention forward: the CUDA kernel ``csrc/flash_attention.cu``.

Port of ``repro/kernels/flash_attention.py::flash`` (a Pallas TPU kernel).
The source's header says how the Hopper design differs from the TPU one.
For a tensor on the CPU the wrapper takes the plain version
(``ref.attention``), which autograd differentiates directly; for a CUDA
tensor it launches the kernel or raises, and under autograd the kernel's
output gets the plain version's gradient (``_Flash``).  For a ``meta``
tensor it returns an empty output of the kernel's shape and dtype and
launches nothing (the dry run of ``launch/dryrun.py``).  A call charges
``costs.flash`` to an active cost recorder.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build, costs, ref

# head-dim pairs (Dq, Dv) the kernel is instantiated for
SUPPORTED_DIMS = frozenset([(dq, dv) for dq in (32, 64, 128) for dv in (32, 64, 128)]
                           + [(192, 128), (48, 32)])     # MLA prefill, full and reduced
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
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash: q, k, v must start on a 16-byte boundary")
    if max(t.numel() for t in (q, k, v)) >= 2**62:
        raise ValueError("flash: tensor too large")


@costs.charged("flash", costs.flash_call)
def flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
          causal: bool = True, scale=None) -> torch.Tensor:
    """q: (B,Sq,H,Dq); k: (B,Skv,Hkv,Dq); v: (B,Skv,Hkv,Dv) -> (B,Sq,H,Dv).

    On the card the dtype picks the kernel: bfloat16 runs on the tensor
    cores (P rounded to bfloat16 before P V, fp32 accumulation), float32 on
    the CUDA cores in exact fp32.  Both are the kernel; neither stands in
    for the other, and a failure of either raises.

    Differentiable: where a CUDA input requires a gradient, the kernel's
    output carries a backward (``_Flash``)."""
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"flash: q, k, v on different devices {devices}")
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, scale=scale)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash: no kernel for device {q.device}")
    _check(q, k, v)
    if scale is None:
        scale = 1.0 / float(np.sqrt(q.shape[-1]))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _Flash.apply(q, k, v, causal, scale)
    return _launch(q, k, v, causal, scale)


class _Flash(torch.autograd.Function):
    """Forward: the CUDA kernel.  Backward: the gradient of the plain version
    (``ref.attention``), recomputed from the saved q, k, v.  The reference
    package has no backward kernel either: its training path differentiates
    plain XLA attention.  A hand-written backward kernel is later speed work."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return _launch(q, k, v, causal, scale)

    @staticmethod
    def backward(ctx, grad_out):
        grads = ref.recompute_grads(ref.attention, ctx.saved_tensors, ctx.needs_input_grad[:3],
                                    (grad_out,), causal=ctx.causal, scale=ctx.scale)
        return (*grads, None, None)


def _launch(q, k, v, causal: bool, scale: float) -> torch.Tensor:
    global launches
    B, Sq, H, Dq = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0 or out.is_meta:
        return out
    fn, err_str = _kernel()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             B, Sq, Skv, H, Hkv, Dq, Dv, DTYPES[q.dtype], int(bool(causal)),
             float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash: kernel launch failed: {err_str(err).decode()}")
    launches += 1
    return out
