"""RWKV6 WKV recurrence: the CUDA kernels of ``csrc/wkv6.cu``.

Port of ``repro/kernels/_rwkv6_pallas.py::wkv6_pallas`` (a Pallas TPU
kernel), with the contract of ``ref.wkv6``.  The dtype picks the kernel:
bfloat16 runs a tensor-core chunked form whose every decay is 2^(cw_a -
cw_b) with cw_a <= cw_b, so no factor exceeds 1 (64 state columns per CTA,
or D if less); float32 runs the recurrence token by token on the CUDA
cores.  Neither takes the TPU kernel's exp(-cumulative decay) factor, which
overflows at rwkv6's own decay initialisation (the source's header says
more).  For tensors on the CPU the wrapper takes the plain version
(``ref.wkv6``), which autograd differentiates directly; for CUDA tensors it
launches the kernel or raises, and under autograd the kernel's output gets
the plain version's gradient (``_WKV6``).  For ``meta`` tensors it returns
empty outputs of the kernel's shapes and dtypes (the final state
included) and launches nothing; a call charges ``costs.wkv6`` to an active
cost recorder.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, costs, ref
from repro_torch.kernels.flash_attention import DTYPES

HEAD_DIMS = (16, 32, 64, 128)     # head dims the kernel is instantiated for

launches = 0      # kernel launches made by this wrapper

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("wkv6")
        fn = lib.wkv6_fwd
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.wkv6_error_string.argtypes = [ctypes.c_int]
        lib.wkv6_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.wkv6_error_string)
    return _fn


def _check(r, k, v, w, u, init_state):
    if r.ndim != 4:
        raise ValueError("wkv6: r must be 4-d (B,S,H,D)")
    B, S, H, D = r.shape
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape:
            raise ValueError(f"wkv6: {name} has shape {tuple(t.shape)}, r {tuple(r.shape)}")
    if tuple(u.shape) != (H, D):
        raise ValueError(f"wkv6: u has shape {tuple(u.shape)}, expected {(H, D)}")
    if init_state is not None and tuple(init_state.shape) != (B, H, D, D):
        raise ValueError(f"wkv6: init_state has shape {tuple(init_state.shape)}, "
                         f"expected {(B, H, D, D)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"wkv6: head dim {D} not supported; supported: {HEAD_DIMS}")
    if r.dtype not in DTYPES or any(t.dtype != r.dtype for t in (k, v, w)):
        raise TypeError(f"wkv6: dtypes {r.dtype}/{k.dtype}/{v.dtype}/{w.dtype}; the kernel "
                        "takes float32 or bfloat16, one dtype for r, k, v and w")
    if not all(t.is_contiguous() for t in (r, k, v, w)):
        raise ValueError("wkv6: r, k, v, w must be contiguous")
    if r.numel() >= 2**62:
        raise ValueError("wkv6: tensor too large")


@costs.charged("wkv6", costs.wkv6_call)
def wkv6(r, k, v, w, u, *, init_state=None, return_state=False):
    """Contract of ``ref.wkv6``: r/k/v/w (B,S,H,D), u (H,D), init_state
    (B,H,D,D) fp32 or None -> y (B,S,H,D) in r's dtype, and the fp32 final
    state if ``return_state``."""
    tensors = [t for t in (r, k, v, w, u, init_state) if t is not None]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"wkv6: inputs on different devices {devices}")
    if r.device.type == "cpu":
        return ref.wkv6(r, k, v, w, u, init_state=init_state, return_state=return_state)
    if r.device.type not in ("cuda", "meta"):
        raise ValueError(f"wkv6: no kernel for device {r.device}")
    _check(r, k, v, w, u, init_state)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        if init_state is not None and init_state.requires_grad:
            raise RuntimeError("wkv6: under autograd the initial state takes no gradient "
                               "(training passes none); detach it")
        return _WKV6.apply(r, k, v, w, u, init_state, return_state)
    return _launch(r, k, v, w, u, init_state, return_state)


class _WKV6(torch.autograd.Function):
    """Forward: the CUDA kernel.  Backward: the gradient of the plain version
    (``ref.wkv6``, the sequential recurrence), recomputed from the caller's
    saved inputs (before the kernel's aligned copies) and differentiated for
    the incoming gradient; each input's gradient comes back in its own
    dtype.  The reference package has no backward kernel either: its
    training path differentiates the XLA forms of the recurrence.  A
    hand-written backward kernel is later speed work."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, init_state, return_state):
        ctx.save_for_backward(r, k, v, w, u, init_state)
        ctx.return_state = return_state
        ctx.set_materialize_grads(False)
        return _launch(r, k, v, w, u, init_state, return_state)

    @staticmethod
    def backward(ctx, *grad_outs):
        *saved, init_state = ctx.saved_tensors
        grads = ref.recompute_grads(ref.wkv6, saved, ctx.needs_input_grad[:5], grad_outs,
                                    init_state=init_state, return_state=ctx.return_state)
        return (*grads, None, None)


def _launch(r, k, v, w, u, init_state, return_state):
    global launches
    B, S, H, D = r.shape
    u = u.to(torch.float32).contiguous()
    if init_state is not None:
        init_state = init_state.to(torch.float32).contiguous()
    y = torch.empty_like(r)
    state = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    if r.is_meta:
        return (y, state) if return_state else y
    if r.numel() == 0:
        state.copy_(init_state if init_state is not None else torch.zeros_like(state))
        return (y, state) if return_state else y
    if r.dtype == torch.bfloat16:
        # the bfloat16 kernel copies rows in 16-byte pieces (cp.async); a view
        # that starts off a 16-byte boundary is copied to one that starts on one
        r, k, v, w = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (r, k, v, w))
    fn, err_str = _kernel()
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
             init_state.data_ptr() if init_state is not None else None,
             y.data_ptr(), state.data_ptr(), B, S, H, D, DTYPES[r.dtype],
             torch.cuda.current_stream(r.device).cuda_stream)
    if err:
        raise RuntimeError(f"wkv6: kernel launch failed: {err_str(err).decode()}")
    launches += 1
    return (y, state) if return_state else y
