"""Parameter specs + basic layers, on torch tensors.

Every parameter is declared once as a :class:`ParamSpec` carrying its shape,
its logical axes and its initializer, in the same tree and layout as
``repro/models/layers.py``: a linear layer's ``w`` is ``(d_in, d_out)`` and the
layer computes ``x @ w``.  Model code is plain functions over nested dicts of
tensors.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import zlib
from concurrent.futures import ThreadPoolExecutor
import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.parallel import tp
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
    init: str = "normal"     # normal | zeros | ones | embed | small | ssm_a | decay
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
    if spec.init == "ssm_a":  # mamba2 A_log: log of Uniform[1, 16]
        return torch.log(torch.rand(shape, generator=gen) * 15.0 + 1.0).to(dtype)
    if spec.init == "decay":  # rwkv decay base, negative-ish
        return (torch.randn(shape, generator=gen) * 0.5 - 1.0).to(dtype)
    raise ValueError(f"init {spec.init!r} is not ported")


def leaf_seed(seed: int, path: str) -> int:
    """Per-leaf generator seed from the run's seed and crc32 of the leaf's
    path.  crc32, NOT python hash(): hash() is salted per process and would
    make init differ across restarts.  32 bits, because the CPU generator
    keeps only the low 32 bits of its seed; the odd multiplier maps distinct
    seeds to distinct values for every path."""
    return (zlib.crc32(path.encode()) ^ (int(seed) * 0x9E3779B1)) & 0xFFFFFFFF


# a leaf of more elements than SLICE_ABOVE is drawn in slices along its leading
# dimensions, each of at most SLICE_ELEMS elements where its shape allows
SLICE_ABOVE = 2**30
SLICE_ELEMS = 2**24


def leaf_slices(shape: tuple) -> tuple[list, int]:
    """(the leading-index tuples of a large leaf's slices, how many leading
    dimensions they index).  The leading dimensions are indexed until a
    slice (the trailing dimensions, never fewer than the last two) holds at
    most SLICE_ELEMS elements; a leaf of two dimensions has none (0)."""
    k = 0
    while k < len(shape) - 2 and int(np.prod(shape[k:])) > SLICE_ELEMS:
        k += 1
    return list(itertools.product(*(range(n) for n in shape[:k]))), k


def materialize(specs, seed: int, dtype=torch.float32, device="cpu"):
    """Spec tree -> tensor tree.  Each leaf draws from its own CPU generator
    (``leaf_seed``), so the values depend on neither the process nor the
    device they end up on, nor on the order the leaves are drawn in: a pool
    of threads draws them, largest first (a 4B-parameter model takes the
    time of its largest leaf, not of the sum).  A leaf of more than
    SLICE_ABOVE elements (deepseek-v3's stacked experts) is drawn in slices
    (``leaf_slices``), slice i from its own generator seeded with
    ``leaf_seed(seed, f"{path}#{i}")``, on the same pool and straight into
    the leaf on ``device``: the host never holds the whole leaf in float32."""
    def make(path, spec):
        gen = torch.Generator(device="cpu").manual_seed(leaf_seed(seed, path))
        return _init_leaf(gen, spec, dtype).to(device)

    def fill(out, idx, spec, slice_seed):
        gen = torch.Generator(device="cpu").manual_seed(slice_seed)
        out[idx].copy_(_init_leaf(gen, spec, dtype))

    named = []
    tree_map_with_path(lambda path, spec: named.append((path, spec)), specs)
    jobs, sliced = [], {}                 # jobs: (elements, key, fn, args)
    for path, spec in named:
        n = int(np.prod(spec.shape))
        idxs, k = leaf_slices(spec.shape) if n > SLICE_ABOVE else ([], 0)
        if not k:                         # small, or no leading dimension to slice
            jobs.append((n, path, make, (path, spec)))
            continue
        out = sliced[path] = torch.empty(spec.shape, dtype=dtype, device=device)
        sub = ParamSpec(spec.shape[k:], spec.axes[k:], spec.init, spec.scale)
        for i, idx in enumerate(idxs):
            jobs.append((int(np.prod(sub.shape)), (path, i), fill,
                         (out, idx, sub, leaf_seed(seed, f"{path}#{i}"))))
    jobs.sort(key=lambda job: -job[0])
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        futures = {key: pool.submit(fn, *args) for _, key, fn, args in jobs}
        for f in futures.values():
            f.result()
    return tree_map_with_path(
        lambda path, _spec: sliced[path] if path in sliced else futures[path].result(), specs)


def abstract_params(specs, dtype=torch.float32):
    """Spec tree -> tree of tensors on the ``meta`` device (shapes, no storage)."""
    return tree_map_with_path(
        lambda _p, s: torch.empty(s.shape, dtype=dtype, device="meta"), specs)


def logical_axes(specs):
    """Spec tree -> tree of each leaf's logical axes (``parallel/mesh_rules``)."""
    return tree_map_with_path(lambda _p, s: s.axes, specs)


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


def group_norm(x: torch.Tensor, num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over the last dim, without affine (RWKV6's wkv output)."""
    dt = x.dtype
    *lead, d = x.shape
    g = x.float().reshape(*lead, num_groups, d // num_groups)
    mu = torch.mean(g, dim=-1, keepdim=True)
    var = torch.var(g, dim=-1, keepdim=True, unbiased=False)
    g = (g - mu) * torch.rsqrt(var + eps)
    return g.reshape(*lead, d).to(dt)


def linear_spec(d_in: int, d_out: int, in_ax, out_ax, bias: bool = False,
                init: str = "normal", scale: float = 1.0) -> dict:
    s = {"w": ParamSpec((d_in, d_out), (in_ax, out_ax), init, scale)}
    if bias:
        s["b"] = ParamSpec((d_out,), (out_ax,), "zeros")
    return s


def linear(p, x: torch.Tensor, compute_dtype=None, spec=None) -> torch.Tensor:
    """``x @ w (+ b)``.  ``spec``: the layer's ``linear_spec``, passed only
    where the step computes on blocks (``tp.on_blocks``).  Where ``p`` holds
    this rank's "model" block of its weight (``tp.block_dim``), the
    product runs on the block: split along the output dim (column-parallel)
    it gives this rank's block of the output, and ``x`` must come through
    ``tp.copy_to_model``; split along the input dim (row-parallel) ``x`` is
    the matching block of the input and the output is summed over "model"."""
    w = p["w"]
    split = None if spec is None else tp.block_dim(w, spec["w"])
    if compute_dtype is not None:
        w = w.to(compute_dtype)
        x = x.to(compute_dtype)
    y = x @ w
    if split is not None:
        tp.COUNTS["block_products"] += 1
        if split == 0:
            y = tp.reduce_from_model(y)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def swiglu_spec(d_model: int, d_ff: int, in_ax="embed", mid_ax="mlp") -> dict:
    return {
        "gate": linear_spec(d_model, d_ff, in_ax, mid_ax),
        "up": linear_spec(d_model, d_ff, in_ax, mid_ax),
        "down": linear_spec(d_ff, d_model, mid_ax, in_ax),
    }


def swiglu(p, x: torch.Tensor, compute_dtype=None, spec=None) -> torch.Tensor:
    """``spec``: the layer's ``swiglu_spec``, as ``linear``'s; where ``p``
    holds "model" blocks of it ("mlp" on "model"), gate and up are
    column-parallel and down row-parallel."""
    spec = spec or {}
    if spec and tp.block_dim(p["gate"]["w"], spec["gate"]["w"]) is not None:
        x = tp.copy_to_model(x)
    g = linear(p["gate"], x, compute_dtype, spec.get("gate"))
    u = linear(p["up"], x, compute_dtype, spec.get("up"))
    return linear(p["down"], F.silu(g) * u, compute_dtype, spec.get("down"))


def embedding_spec(vocab: int, dim: int) -> dict:
    return {"table": ParamSpec((vocab, dim), ("vocab", "embed"), "embed")}


def embed(p, ids: torch.Tensor, compute_dtype=None, spec=None) -> torch.Tensor:
    """``spec``: the table's ``ParamSpec``, as ``linear``'s; where
    ``p["table"]`` is a block of it, ``tp.vocab_parallel_embed``."""
    # gather first, then cast: the same values as casting the whole table,
    # without writing a cast copy of it on every step.  index_select, not
    # advanced indexing: its backward (index_add) is deterministic on CUDA
    table = p["table"]
    start = None if spec is None else tp.vocab_start(table, spec)
    if start is not None:
        h = tp.vocab_parallel_embed(table, ids, start)
    else:
        h = torch.index_select(table, 0, ids.reshape(-1).long())
        h = h.reshape(*ids.shape, table.shape[-1])
    return h if compute_dtype is None else h.to(compute_dtype)


def unembed(p, x: torch.Tensor, spec=None) -> torch.Tensor:
    """Logits in fp32 for loss stability; this rank's block of them where
    ``p["table"]`` is a block of the table ``spec`` declares (as ``embed``)."""
    if spec is not None and tp.vocab_start(p["table"], spec) is not None:
        tp.COUNTS["block_products"] += 1
        x = tp.copy_to_model(x)
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
