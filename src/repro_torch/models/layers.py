"""Parameter specs + basic layers, on torch tensors.

Every parameter is declared once as a :class:`ParamSpec` carrying its shape,
its logical axes and its initializer, in the same tree and layout as
``repro/models/layers.py``: a linear layer's ``w`` is ``(d_in, d_out)`` and the
layer computes ``x @ w``.  Model code is plain functions over nested dicts of
tensors.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.utils.tree import tree_map_with_path


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype string ("float32", "bfloat16", ...) as a torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# ----------------------------------------------------------------------------------
# Param specs
# ----------------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple              # logical axis name (or None) per dim; len == len(shape)
    init: str = "normal"     # normal | zeros | ones | embed | small
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"spec shape {self.shape} and axes {self.axes} differ in rank")


def _init_leaf(gen: torch.Generator, spec: ParamSpec, dtype) -> torch.Tensor:
    shape = spec.shape
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=dtype)
    if spec.init == "ones":
        return torch.ones(shape, dtype=dtype)
    if spec.init == "normal":
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = spec.scale / np.sqrt(max(fan_in, 1))
        return (torch.randn(shape, generator=gen) * std).to(dtype)
    if spec.init in ("embed", "small"):
        return (torch.randn(shape, generator=gen) * (0.02 * spec.scale)).to(dtype)
    raise ValueError(f"init {spec.init!r} is not ported")


def leaf_seed(seed: int, path: str) -> int:
    """Per-leaf generator seed from the run's seed and crc32 of the leaf's
    path.  crc32, NOT python hash(): hash() is salted per process and would
    make init differ across restarts.  32 bits, because the CPU generator
    keeps only the low 32 bits of its seed; the odd multiplier maps distinct
    seeds to distinct values for every path."""
    return (zlib.crc32(path.encode()) ^ (int(seed) * 0x9E3779B1)) & 0xFFFFFFFF


def materialize(specs, seed: int, dtype=torch.float32, device="cpu"):
    """Spec tree -> tensor tree.  Each leaf draws from its own CPU generator
    (``leaf_seed``), so the values depend on neither the process nor the
    device they end up on."""
    def make(path, spec):
        gen = torch.Generator(device="cpu").manual_seed(leaf_seed(seed, path))
        return _init_leaf(gen, spec, dtype).to(device)

    return tree_map_with_path(make, specs)


def abstract_params(specs, dtype=torch.float32):
    """Spec tree -> tree of tensors on the ``meta`` device (shapes, no storage)."""
    return tree_map_with_path(
        lambda _p, s: torch.empty(s.shape, dtype=dtype, device="meta"), specs)


# ----------------------------------------------------------------------------------
# Layers
# ----------------------------------------------------------------------------------


def rms_norm_spec(dim: int) -> dict:
    return {"scale": ParamSpec((dim,), (None,), "ones")}


def rms_norm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dt)


def linear_spec(d_in: int, d_out: int, in_ax, out_ax, bias: bool = False,
                init: str = "normal", scale: float = 1.0) -> dict:
    s = {"w": ParamSpec((d_in, d_out), (in_ax, out_ax), init, scale)}
    if bias:
        s["b"] = ParamSpec((d_out,), (out_ax,), "zeros")
    return s


def linear(p, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    w = p["w"]
    if compute_dtype is not None:
        w = w.to(compute_dtype)
        x = x.to(compute_dtype)
    y = x @ w
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def swiglu_spec(d_model: int, d_ff: int, in_ax="embed", mid_ax="mlp") -> dict:
    return {
        "gate": linear_spec(d_model, d_ff, in_ax, mid_ax),
        "up": linear_spec(d_model, d_ff, in_ax, mid_ax),
        "down": linear_spec(d_ff, d_model, mid_ax, in_ax),
    }


def swiglu(p, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    g = linear(p["gate"], x, compute_dtype)
    u = linear(p["up"], x, compute_dtype)
    return linear(p["down"], F.silu(g) * u, compute_dtype)


def embedding_spec(vocab: int, dim: int) -> dict:
    return {"table": ParamSpec((vocab, dim), ("vocab", "embed"), "embed")}


def embed(p, ids: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    # gather first, then cast: the same values as casting the whole table,
    # without writing a cast copy of it on every step
    h = p["table"][ids.long()]
    return h if compute_dtype is None else h.to(compute_dtype)


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    """Logits in fp32 for loss stability."""
    return x.float() @ p["table"].float().T


# ----------------------------------------------------------------------------------
# Rotary position embedding
# ----------------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    dt = x.dtype
    head_dim = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(head_dim, theta), dtype=torch.float32,
                            device=x.device)
    angles = positions.float()[..., None] * freqs          # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dt)
