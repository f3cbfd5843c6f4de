"""Mamba2 SSD scan: the CUDA kernels of ``csrc/ssd_scan.cu``.

Port of ``repro/kernels/_ssd_pallas.py::ssd_pallas`` (a Pallas TPU kernel),
with the contract of ``ref.ssd``.  The dtype picks the kernel: bfloat16 runs
the tensor-core chunked scan (64 columns of P per CTA, N up to 128), float32
the CUDA-core one (exact fp32 sums).  The source's header
says how the Hopper design differs from the TPU one.  For tensors on the
CPU the wrapper takes the plain version (``ref.ssd``, the sequential
recurrence), which autograd differentiates directly; for CUDA tensors it
launches the kernel or raises, and under autograd the kernel's output gets
the plain version's gradient (``_SSD``).  For ``meta`` tensors it returns
empty outputs of the kernel's shapes and dtypes (the final state
included) and launches nothing; a call charges ``costs.ssd`` to an active
cost recorder.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, costs, ref
from repro_torch.kernels.decode_attention import MAX_SMEM_BYTES
from repro_torch.kernels.flash_attention import DTYPES

launches = 0      # kernel launches made by this wrapper
MAX_N_BF16 = 128  # the bfloat16 kernel's widest state (N padded to 16, 32, 64 or 128)

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
    if x.dtype == torch.bfloat16 and N > MAX_N_BF16:
        raise ValueError(f"ssd: the bfloat16 kernel takes N up to {MAX_N_BF16}, got {N}")
    if not all(t.is_contiguous() for t in (x, dt, Bm, Cm)):
        raise ValueError("ssd: x, dt, Bm, Cm must be contiguous")
    if max(t.numel() for t in (x, Bm)) >= 2**62:
        raise ValueError("ssd: tensor too large")


@costs.charged("ssd", costs.ssd_call)
def ssd(x, dt, A_log, Bm, Cm, D, *, init_state=None, return_state=False):
    """Contract of ``ref.ssd``: x (B,S,H,P), dt (B,S,H), A_log (H,), Bm/Cm
    (B,S,N), D (H,), init_state (B,H,P,N) fp32 or None -> y (B,S,H,P) in
    x's dtype, and the fp32 final state if ``return_state``."""
    tensors = [t for t in (x, dt, A_log, Bm, Cm, D, init_state) if t is not None]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"ssd: inputs on different devices {devices}")
    if x.device.type == "cpu":
        return ref.ssd(x, dt, A_log, Bm, Cm, D, init_state=init_state,
                       return_state=return_state)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssd: no kernel for device {x.device}")
    _check(x, dt, A_log, Bm, Cm, D, init_state)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        if init_state is not None and init_state.requires_grad:
            raise RuntimeError("ssd: under autograd the initial state takes no gradient "
                               "(training passes none); detach it")
        return _SSD.apply(x, dt, A_log, Bm, Cm, D, init_state, return_state)
    return _launch(x, dt, A_log, Bm, Cm, D, init_state, return_state)


class _SSD(torch.autograd.Function):
    """Forward: the CUDA kernel.  Backward: the gradient of the plain version
    (``ref.ssd``, the sequential recurrence), recomputed from the caller's
    saved inputs (before the kernel's padding and aligned copies) and
    differentiated for the incoming gradient; each input's gradient comes
    back in its own dtype.  The reference package has no backward kernel
    either: its training path differentiates the XLA forms of the scan.  A
    hand-written backward kernel is later speed work."""

    @staticmethod
    def forward(ctx, x, dt, A_log, Bm, Cm, D, init_state, return_state):
        ctx.save_for_backward(x, dt, A_log, Bm, Cm, D, init_state)
        ctx.return_state = return_state
        ctx.set_materialize_grads(False)
        return _launch(x, dt, A_log, Bm, Cm, D, init_state, return_state)

    @staticmethod
    def backward(ctx, *grad_outs):
        *saved, init_state = ctx.saved_tensors
        grads = ref.recompute_grads(ref.ssd, saved, ctx.needs_input_grad[:6], grad_outs,
                                    init_state=init_state, return_state=ctx.return_state)
        return (*grads, None, None)


def _launch(x, dt, A_log, Bm, Cm, D, init_state, return_state):
    global launches
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    A_log = A_log.to(torch.float32).contiguous()
    D = D.to(torch.float32).contiguous()
    if init_state is not None:
        init_state = init_state.to(torch.float32).contiguous()
    if x.is_meta:
        y = torch.empty_like(x)
        state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
        return (y, state) if return_state else y
    if x.numel() == 0:
        state = (init_state.clone() if init_state is not None else
                 torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device))
        return (torch.empty_like(x), state) if return_state else torch.empty_like(x)
    fn, err_str, smem_bytes = _kernel()
    Pk, Nk = P, N
    if x.dtype == torch.float32:
        if smem_bytes(P, N) > MAX_SMEM_BYTES:
            raise ValueError(f"ssd: P={P}, N={N} need more shared memory than a block has")
    else:
        # the bfloat16 kernel copies rows in 16-byte pieces (cp.async): P and
        # N are zero-padded to multiples of 8 (a zero column of x or of B and
        # C adds exact zeros), and a view off a 16-byte boundary is copied
        Pk, Nk = -(-P // 8) * 8, -(-N // 8) * 8
        if (Pk, Nk) != (P, N):
            x = F.pad(x, (0, Pk - P))
            Bm, Cm = F.pad(Bm, (0, Nk - N)), F.pad(Cm, (0, Nk - N))
            if init_state is not None:
                init_state = F.pad(init_state, (0, Nk - N, 0, Pk - P))
        x, Bm, Cm = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, Bm, Cm))
    y = torch.empty_like(x)
    state = torch.empty((B, H, Pk, Nk), dtype=torch.float32, device=x.device)
    err = fn(x.data_ptr(), dt.data_ptr(), A_log.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
             D.data_ptr(), init_state.data_ptr() if init_state is not None else None,
             y.data_ptr(), state.data_ptr(), B, S, H, Pk, Nk, DTYPES[x.dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd: kernel launch failed: {err_str(err).decode()}")
    launches += 1
    if (Pk, Nk) != (P, N):
        y, state = y[..., :P].contiguous(), state[:, :, :P, :N].contiguous()
    return (y, state) if return_state else y
