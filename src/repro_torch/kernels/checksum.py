"""Chunk fingerprints and checksum: the CUDA kernels ``csrc/checksum.cu``.

Port of ``repro/kernels/checksum.py`` (``chunk_fingerprints_pallas`` and
``checksum_pallas``, Pallas TPU kernels).  Both hash a uint32 word stream
with the mix ``(w ^ i*16777619) * (i|1)`` and reduce XOR + wrapping SUM:
one value per fixed-size chunk with a chunk-local ``i`` (the delta plane's
dirty-chunk filter, run on every device-fingerprinted save and pre-dump),
or one digest with the global ``i``.  Both are bound by the bytes they
read; the source's header says how the Hopper design meets that.

Words come as an ``int32`` or ``uint32`` tensor, and results are ``int32``
tensors that hold the uint32 bits (``.view(torch.uint32)`` or numpy's
``.view(np.uint32)`` reads them as unsigned): int32 has every operation the
callers need on every PyTorch build, uint32 does not.  For a tensor on the
CPU a wrapper takes the plain version (``ref``); for a CUDA tensor it
launches the kernel or raises; for a ``meta`` tensor it returns an empty
result of the kernel's shape and launches nothing.  A call charges
``costs.chunk_fingerprints`` or ``costs.checksum`` to an active cost
recorder.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, costs, ref

WORD_DTYPES = (torch.int32, torch.uint32)

fingerprint_launches = 0    # chunk_fingerprints kernel launches
checksum_launches = 0       # checksum kernel launches

_fns = None


def require_pow2(value: int, name: str = "block") -> None:
    """``chunk_words`` and ``block`` must be positive powers of two, as the
    reference's kernels demand (their XOR fold halves the tile); raised
    before any launch so every impl fails the same way."""
    if value < 1 or value & (value - 1):
        raise ValueError(f"{name} must be a positive power of two, got {value}")


def _kernels():
    global _fns
    if _fns is None:
        lib = _build.load("checksum")
        fp = lib.chunk_fingerprints_u32
        fp.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_void_p]
        fp.restype = ctypes.c_int
        ck = lib.checksum_u32
        ck.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_void_p]
        ck.restype = ctypes.c_int
        lib.checksum_error_string.argtypes = [ctypes.c_int]
        lib.checksum_error_string.restype = ctypes.c_char_p
        _fns = (fp, ck, lib.checksum_error_string)
    return _fns


def _check(words: torch.Tensor, what: str) -> None:
    if words.ndim != 1:
        raise ValueError(f"{what}: words must be 1-d, got shape {tuple(words.shape)}")
    if words.dtype not in WORD_DTYPES:
        raise TypeError(f"{what}: words must be int32 or uint32, got {words.dtype}")
    if not words.is_contiguous():
        raise ValueError(f"{what}: words must be contiguous")
    if words.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{what}: no kernel for device {words.device}")


@costs.charged("chunk_fingerprints", costs.chunk_fingerprints_call)
def chunk_fingerprints(words: torch.Tensor, chunk_words: int) -> torch.Tensor:
    """(N,) words -> (ceil(N / chunk_words),) int32 (uint32 bits), one value
    per chunk; the tail chunk reads as zero-padded."""
    global fingerprint_launches
    require_pow2(chunk_words, name="chunk_words")
    _check(words, "chunk_fingerprints")
    if words.device.type == "cpu":
        return ref.chunk_fingerprints(words, chunk_words)
    n = words.numel()
    out = torch.empty((-(-n // chunk_words),), dtype=torch.int32, device=words.device)
    if n == 0 or out.is_meta:
        return out
    fp, _, err_str = _kernels()
    err = fp(words.data_ptr(), n, chunk_words, out.data_ptr(),
             torch.cuda.current_stream(words.device).cuda_stream)
    if err:
        raise RuntimeError(f"chunk_fingerprints: kernel launch failed: {err_str(err).decode()}")
    fingerprint_launches += 1
    return out


@costs.charged("checksum", costs.checksum_call)
def checksum(words: torch.Tensor, block: int = 2048) -> torch.Tensor:
    """(N,) words -> 0-d int32 (uint32 bits): the digest of the stream
    zero-padded to a multiple of ``block``; 0 for an empty stream."""
    global checksum_launches
    require_pow2(block)
    _check(words, "checksum")
    n = words.numel()
    if n == 0:
        return torch.zeros((), dtype=torch.int32, device=words.device)
    if words.is_meta:
        return torch.empty((), dtype=torch.int32, device=words.device)
    padded = -(-n // block) * block
    if words.device.type == "cpu":
        return ref.checksum(torch.cat([words.view(torch.int32),
                                       words.new_zeros(padded - n, dtype=torch.int32)]))
    acc = torch.empty((4,), dtype=torch.int32, device=words.device)
    _, ck, err_str = _kernels()
    err = ck(words.data_ptr(), n, padded, acc.data_ptr(),
             torch.cuda.current_stream(words.device).cuda_stream)
    if err:
        raise RuntimeError(f"checksum: kernel launch failed: {err_str(err).decode()}")
    checksum_launches += 1
    return acc[3]
