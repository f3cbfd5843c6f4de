"""Dispatch over the kernels, by the tensor's device.

A CUDA tensor goes to the hand-written kernel (``flash`` for a sequence,
``flash_decode`` for one token against a cache, ``ssd`` and ``wkv6`` for the
SSM scans, ``chunk_fingerprints`` and ``checksum`` for word streams); a CPU
tensor goes to the plain version in ``ref``, and a ``meta`` tensor to the
kernel's shapes with no launch, the dry run's (each wrapper makes that
choice).  ``impl`` keeps the reference
package's names:

  auto, pallas       the kernel on CUDA, the plain version on the CPU; on the
                     CPU a causal prefill longer than 2048 tokens takes the
                     blockwise path (``xla_attention.causal_blockwise``)
  xla, xla_chunked,  the plain version, and only on the CPU: asking for it
  ref                on a CUDA tensor raises, so nothing on the card's path
                     quietly skips its kernel; ``xla_chunked`` attention is
                     the blockwise path
  ring               attention of a prefill or a training step as a ring over
                     the ambient mesh's "model" axis where that axis holds
                     more than one rank (``ring_attention``, the reference's
                     non-Pallas path); a ring of one rank is attention, so
                     there (the card's (1, 1) mesh), with no mesh in context,
                     on a decode step, and for every other op: ``auto``
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import checksum as CK
from repro_torch.kernels import decode_attention, flash_attention
from repro_torch.kernels import ssd as SSD
from repro_torch.kernels import wkv6 as WKV
from repro_torch.kernels.ring_attention import ring_attention
from repro_torch.kernels.xla_attention import causal_blockwise
from repro_torch.parallel.context import current_mesh

KERNEL_IMPLS = ("auto", "pallas", "ring")
PLAIN_IMPLS = ("xla", "xla_chunked", "ref")
_NAIVE_MAX_SEQ = 2048


def _resolve(impl, device: torch.device, what: str) -> str:
    impl = impl or "auto"
    if impl not in KERNEL_IMPLS + PLAIN_IMPLS:
        raise ValueError(f"{what} impl {impl!r} is not available in this package; "
                         f"choose from {KERNEL_IMPLS + PLAIN_IMPLS}")
    if device.type in ("cuda", "meta") and impl in PLAIN_IMPLS:
        raise ValueError(f"{what} impl {impl!r} is the plain version, which runs "
                         "on CPU tensors only; CUDA (and meta) tensors go through the kernel")
    return impl


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, kv_len=None, impl: str = "auto",
              decode: bool = False, scale=None, return_lse: bool = False):
    """``return_lse`` (one query token only): also the float32 log-sum-exp
    of the scaled scores, (B,1,H), as ``flash_decode`` returns it."""
    impl = _resolve(impl, q.device, "attention")
    Sq = q.shape[1]
    one_token = decode or Sq == 1
    if return_lse and not one_token:
        raise ValueError("return_lse is flash_decode's: one query token against a cache")
    if impl == "ring" and not one_token and kv_len is None:
        mesh = current_mesh()
        if mesh is not None and dict(zip(mesh.axis_names, mesh.shape)).get("model", 1) > 1:
            return ring_attention(q, k, v, mesh=mesh, scale=scale, causal=causal)
    # each wrapper takes the plain version for CPU tensors, the kernel for CUDA
    if one_token:
        return decode_attention.flash_decode(q, k, v, kv_len=kv_len, scale=scale,
                                             return_lse=return_lse)
    if kv_len is not None:
        raise ValueError("flash takes no kv_len; a prefill attends to its whole input")
    if q.device.type == "cpu" and causal and (
            impl == "xla_chunked" or (impl in ("auto", "ring") and Sq > _NAIVE_MAX_SEQ)):
        return causal_blockwise(q, k, v, scale=scale)
    return flash_attention.flash(q, k, v, causal=causal, scale=scale)


# ----------------------------------------------------------------------------------
# SSM scans over a whole sequence (prefill); decode steps are plain PyTorch
# (``ssd_scan.ssd_step``, ``rwkv6_scan.wkv6_step``), as in the reference
# ----------------------------------------------------------------------------------


def ssd(x, dt, A_log, Bm, Cm, D, *, chunk: int = 256, impl: str = "auto",
        init_state=None, return_state: bool = False):
    """Mamba2 SSD scan (contract of ``ref.ssd``).  ``chunk`` is accepted for
    the reference's signature; neither path depends on it: the kernel's
    chunk is its own constant and the plain version is the sequential
    recurrence."""
    _resolve(impl, x.device, "ssd")
    return SSD.ssd(x, dt, A_log, Bm, Cm, D, init_state=init_state,
                   return_state=return_state)


def wkv6(r, k, v, w, u, *, impl: str = "auto", init_state=None,
         return_state: bool = False, chunk: int = 128):
    """RWKV6 WKV recurrence (contract of ``ref.wkv6``).  ``chunk`` is
    accepted for the reference's signature; the kernel runs the recurrence
    token by token, so neither path depends on it."""
    _resolve(impl, r.device, "wkv6")
    return WKV.wkv6(r, k, v, w, u, init_state=init_state, return_state=return_state)


# ----------------------------------------------------------------------------------
# Word streams: checksum and chunk fingerprints (the delta plane's dirty filter)
# ----------------------------------------------------------------------------------


def checksum(words: torch.Tensor, *, impl: str = "auto", block: int = 2048) -> torch.Tensor:
    """Digest of an int32/uint32 word stream, zero-padded to a ``block``
    multiple so every impl agrees bit for bit; a 0-d int32 holding the
    uint32 value (0 for an empty stream).  The wrapper takes the plain
    version for CPU words, which is what the plain impls ask for."""
    _resolve(impl, words.device, "checksum")
    return CK.checksum(words, block=block)


def chunk_fingerprints(words: torch.Tensor, *, chunk_words: int,
                       impl: str = "auto") -> torch.Tensor:
    """Per-chunk fingerprints of an int32/uint32 word stream (index mixing
    chunk-local, the tail chunk zero-padded): an int32 tensor holding one
    uint32 per chunk, bit-identical across impls and with the host's
    ``serialization.fingerprint_chunks``."""
    _resolve(impl, words.device, "chunk_fingerprints")
    return CK.chunk_fingerprints(words, chunk_words)


def byte_view(t: torch.Tensor) -> torch.Tensor:
    """A tensor's payload bytes as a flat uint8 tensor on its device, without
    a copy where it is contiguous (bool is one byte of 0/1 per element, as
    in numpy)."""
    if t.numel() == 0:
        return torch.zeros(0, dtype=torch.uint8, device=t.device)
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _words_of_bytes(u8: torch.Tensor) -> torch.Tensor:
    """Little-endian int32 words over a uint8 span whose length is a
    multiple of 4; a copy only where the span does not start on a word."""
    if u8.storage_offset() % 4:
        u8 = u8.clone()
    return u8.view(torch.int32)


def leaf_words(arr):
    """Little-endian uint32 word stream over a leaf's payload bytes,
    zero-padded to a word boundary: exactly the stream
    ``serialization.fingerprint_chunks`` views host-side.  A torch tensor
    gives int32 words (the uint32 bits) on its own device, a view where its
    bytes are whole words; anything else takes the host path, a numpy
    ``<u4`` array (zero-copy where the payload is word-aligned)."""
    if isinstance(arr, torch.Tensor):
        u8 = byte_view(arr)
        pad = (-u8.numel()) % 4
        if pad:
            u8 = torch.cat([u8, u8.new_zeros(pad)])
        return _words_of_bytes(u8)
    a = np.ascontiguousarray(np.asarray(arr)).reshape(-1)
    buf = a.view(np.uint8)
    pad = (-buf.nbytes) % 4
    if pad:
        padded = np.zeros(buf.nbytes + pad, np.uint8)
        padded[:buf.nbytes] = buf
        buf = padded
    return buf.view("<u4")


def tree_chunk_fingerprints(named_leaves, chunk_bytes: int, *,
                            impl: str = "auto") -> dict:
    """``{name: np.uint32[n_chunks]}`` per-chunk fingerprints for a list of
    ``(name, leaf)`` pairs, computed on the leaves' device: only the
    fingerprint vectors, a few bytes per MiB of state, cross to the host.

    Values are bit-identical to ``serialization.fingerprint_chunks`` on the
    same leaf bytes.  Each leaf's bytes split into an aligned body of whole
    chunks, fingerprinted in place (one launch per leaf that has one), and a
    ragged tail; all tails of one device are zero-padded to a chunk each and
    batched into one more launch for the whole tree.  numpy leaves take the
    host path (the plain version on the CPU).  Inputs are only read."""
    if chunk_bytes < 4 or chunk_bytes % 4:
        raise ValueError(f"chunk_bytes must be a multiple of 4, got {chunk_bytes}")
    chunk_words = chunk_bytes // 4
    CK.require_pow2(chunk_words, name="chunk_words")
    out: dict = {}
    body_fp: dict = {}
    tails: dict = {}                     # device -> [(name, tail bytes)]
    for name, leaf in named_leaves:
        if isinstance(leaf, torch.Tensor):
            u8 = byte_view(leaf)
        else:
            a = np.ascontiguousarray(np.asarray(leaf)).reshape(-1)
            if not a.flags.writeable:       # torch.from_numpy wants a writeable array
                a = a.copy()
            u8 = torch.from_numpy(a.view(np.uint8))
        nbytes = u8.numel()
        if nbytes == 0:
            out[name] = np.zeros(0, np.uint32)
            continue
        nbody = nbytes - nbytes % chunk_bytes
        if nbody:
            body_fp[name] = chunk_fingerprints(_words_of_bytes(u8[:nbody]),
                                               chunk_words=chunk_words, impl=impl)
        if nbody < nbytes:
            tails.setdefault(u8.device, []).append((name, u8[nbody:]))
    tail_fp: dict = {}
    for device, group in tails.items():
        buf = torch.zeros(len(group) * chunk_bytes, dtype=torch.uint8, device=device)
        for i, (_, tail) in enumerate(group):
            buf[i * chunk_bytes:i * chunk_bytes + tail.numel()].copy_(tail)
        fps = _host_u32(chunk_fingerprints(buf.view(torch.int32),
                                           chunk_words=chunk_words, impl=impl))
        for i, (name, _) in enumerate(group):
            tail_fp[name] = fps[i]
    for name, fp in body_fp.items():
        out[name] = _host_u32(fp)
    for name, fp in tail_fp.items():
        prev = out.get(name)
        out[name] = (np.append(prev, fp) if prev is not None
                     else np.asarray([fp], np.uint32))
    return out


def _host_u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)
