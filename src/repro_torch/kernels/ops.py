"""Dispatch over the attention kernels, by the tensor's device.

A CUDA tensor goes to the hand-written kernel (``flash`` for a sequence,
``flash_decode`` for one token against a cache); a CPU tensor goes to the
plain version in ``ref`` (each wrapper makes that choice).  ``impl`` keeps
the reference package's names:

  auto, pallas       the kernel on CUDA, the plain version on the CPU
  xla, xla_chunked,  the plain version, and only on the CPU: asking for it
  ref                on a CUDA tensor raises, so nothing on the card's path
                     quietly skips its kernel
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention, flash_attention

KERNEL_IMPLS = ("auto", "pallas")
PLAIN_IMPLS = ("xla", "xla_chunked", "ref")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, kv_len=None, impl: str = "auto",
              decode: bool = False, scale=None) -> torch.Tensor:
    impl = impl or "auto"
    if impl not in KERNEL_IMPLS + PLAIN_IMPLS:
        raise ValueError(f"attention impl {impl!r} is not available in this package; "
                         f"choose from {KERNEL_IMPLS + PLAIN_IMPLS}")
    if q.device.type == "cuda" and impl in PLAIN_IMPLS:
        raise ValueError(f"attention impl {impl!r} is the plain version, which runs "
                         "on CPU tensors only; CUDA tensors go through the kernel")
    # each wrapper takes the plain version for CPU tensors, the kernel for CUDA
    if decode or q.shape[1] == 1:
        return decode_attention.flash_decode(q, k, v, kv_len=kv_len, scale=scale)
    if kv_len is not None:
        raise ValueError("flash takes no kv_len; a prefill attends to its whole input")
    return flash_attention.flash(q, k, v, causal=causal, scale=scale)
