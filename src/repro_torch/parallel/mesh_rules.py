"""Logical-axis -> mesh-axis resolution with divisibility fallback.

Every tensor in the framework is annotated with *logical* axis names (see
models/layers.py).  A :class:`Rules` object maps those names onto the
mesh (``launch/mesh.py``).  Assignment is greedy in priority order: each mesh
axis is used at most once per tensor, and a candidate is skipped when the
dim size doesn't divide the mesh-axis size (qwen2's 14 heads can't split
16-way, so they fall back to replicated while its MLP still shards).

The table and the resolution are the reference's (``repro/parallel/
mesh_rules.py``), entry for entry: FSDP = param "embed"/"expert" dims on the
data axis, TP = heads/mlp/vocab dims on the model axis, EP = expert dim on
(pod,data), DP = batch on (pod,data).  ``spec`` gives the reference's
PartitionSpec entries as a tuple; ``placements`` the ``DTensor`` placements
of the same layout, one per mesh dim; ``local_slices`` the block of the
global array that a mesh coordinate holds, as JAX's
``NamedSharding.devices_indices_map`` gives it.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

# (priority, candidates) per logical axis name.  Lower priority assigns first.
# Candidates are tuples of mesh axes tried in order.
_DEFAULT_RULES: dict[str, tuple[int, list[tuple[str, ...]]]] = {
    # --- activations ---------------------------------------------------------
    "batch":          (0, [("pod", "data"), ("data",)]),
    "exp_group":      (0, [("pod", "data"), ("data",)]),
    "seq":            (5, []),                 # sequence parallelism: opt-in (perf pass)
    "cache_seq":      (4, [("model",)]),       # used when head dims can't shard
    "heads_dim":      (1, [("model",)]),
    "kv_heads_dim":   (1, [("model",)]),
    "ssm_heads_dim":  (1, [("model",)]),
    "mlp":            (1, [("model",)]),
    # --- params ---------------------------------------------------------------
    "expert":         (0, [("pod", "data"), ("data",)]),
    # MoE capacity slots: EP fallback when num_experts doesn't divide the data
    # axis (granite-moe's 40 experts on 16 shards) — slots shard instead, expert
    # compute stays fully local, dispatch/combine become bf16 all-to-alls.
    "moe_cap":        (1, [("pod", "data"), ("data",)]),
    "heads":          (1, [("model",)]),
    "kv_heads":       (1, [("model",)]),
    "vocab":          (1, [("model",)]),
    "ssm_inner":      (1, [("model",)]),
    "ssm_heads":      (3, []),                 # tiny per-head vectors: replicate
    "embed":          (2, [("data",)]),        # FSDP shard of the param matrix
    "layers":         (5, []),
}


def is_axes(x) -> bool:
    """A leaf of a logical-axes tree: a tuple of names (or None), () for a
    0-d leaf."""
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def named_axes(axes_tree, path: tuple = ()) -> list[tuple[str, tuple]]:
    """(leaf path, logical axes) of an axes tree, with the names and order of
    ``utils.tree.flatten_with_names`` over the tree it annotates."""
    if is_axes(axes_tree):
        return [("/".join(path), axes_tree)]
    if isinstance(axes_tree, dict):
        return [kv for k in sorted(axes_tree)
                for kv in named_axes(axes_tree[k], path + (str(k),))]
    raise TypeError(f"not a logical-axes tree node at {'/'.join(path)!r}: {axes_tree!r}")


class Rules:
    def __init__(self, mesh, overrides: Optional[dict] = None, fsdp: bool = True):
        self.mesh = mesh
        table = dict(_DEFAULT_RULES)
        if not fsdp:
            table["embed"] = (2, [])
        if overrides:
            table.update(overrides)
        self.table = table
        self.axis_sizes = dict(zip(mesh.axis_names, mesh.shape))

    # ------------------------------------------------------------------
    def shard_count(self, mesh_axes) -> int:
        """How many blocks a dim split over ``mesh_axes`` falls into."""
        return math.prod(self.axis_sizes[a] for a in mesh_axes)

    def spec(self, axes: Sequence[Optional[str]], shape: Sequence[int]) -> tuple:
        """Resolve one tensor's logical axes to the reference's PartitionSpec
        entries: per dim None, a mesh axis, or a tuple of mesh axes, with
        trailing Nones dropped."""
        assert len(axes) == len(shape), (axes, shape)
        order = sorted(
            range(len(axes)),
            key=lambda i: self.table.get(axes[i], (9, []))[0] if axes[i] else 9,
        )
        used: set[str] = set()
        assign: list[Optional[tuple[str, ...]]] = [None] * len(axes)
        for i in order:
            name = axes[i]
            if name is None or name not in self.table:
                continue
            for cand in self.table[name][1]:
                cand = tuple(a for a in cand if a in self.axis_sizes)
                if not cand or any(a in used for a in cand):
                    continue
                if shape[i] % self.shard_count(cand) != 0:
                    # try a shorter suffix of the candidate (e.g. ('data',) of
                    # ('pod','data')) before giving up
                    ok = False
                    for k in range(1, len(cand)):
                        sub = cand[k:]
                        if (shape[i] % self.shard_count(sub) == 0
                                and not any(a in used for a in sub)):
                            cand, ok = sub, True
                            break
                    if not ok:
                        continue
                assign[i] = cand
                used.update(cand)
                break
        parts = [a if a is None else (a[0] if len(a) == 1 else a) for a in assign]
        while parts and parts[-1] is None:
            parts.pop()
        return tuple(parts)

    def dim_axes(self, axes, shape) -> list[tuple[str, ...]]:
        """``spec`` as a tuple of mesh axes per tensor dim (() unsharded)."""
        sp = self.spec(axes, shape)
        out = [() if e is None else (e,) if isinstance(e, str) else tuple(e) for e in sp]
        return out + [()] * (len(shape) - len(out))

    def placements(self, axes, shape) -> list:
        """The DTensor placements of ``spec``: per mesh dim ``Shard(d)`` where
        tensor dim d is split over it, else ``Replicate()``.  A dim split over
        several mesh axes is split major to minor in their order, as
        DTensor splits it in mesh-dim order; an order against the mesh's is
        refused."""
        from torch.distributed.tensor import Replicate, Shard

        out = [Replicate() for _ in self.mesh.axis_names]
        for d, mesh_axes in enumerate(self.dim_axes(axes, shape)):
            idx = [self.mesh.axis_names.index(a) for a in mesh_axes]
            if idx != sorted(idx):
                raise ValueError(f"dim {d} is split over {mesh_axes}, against the mesh's "
                                 f"order {self.mesh.axis_names}")
            for j in idx:
                out[j] = Shard(d)
        return out

    def is_replicated(self, axes, shape) -> bool:
        return all(self.shard_count(a) == 1 for a in self.dim_axes(axes, shape))

    def local_slices(self, axes, shape, coordinate: Optional[Sequence[int]] = None) -> tuple:
        """The block of the global ``shape`` that the mesh coordinate
        (default: this rank's) holds: per dim, the dim's mesh axes index it
        major to minor, as ``devices_indices_map`` does."""
        coord = dict(zip(self.mesh.axis_names,
                         self.mesh.coordinate if coordinate is None else coordinate))
        out = []
        for n, mesh_axes in zip(shape, self.dim_axes(axes, shape)):
            idx = 0
            for a in mesh_axes:
                idx = idx * self.axis_sizes[a] + coord[a]
            block = n // self.shard_count(mesh_axes)
            out.append(slice(idx * block, (idx + 1) * block))
        return tuple(out)

    def axis_group_size(self, name: str) -> int:
        """Total shard count the first viable candidate of ``name`` provides."""
        for cand in self.table.get(name, (9, []))[1]:
            cand = tuple(a for a in cand if a in self.axis_sizes)
            if cand:
                return self.shard_count(cand)
        return 1

    # ------------------------------------------------------------------
    def tree_placements(self, axes_tree, tree) -> dict:
        """{leaf path: placements} of a tree (tensors or arrays; meta tensors
        do) and the logical-axes tree that annotates it."""
        from repro_torch.utils.tree import flatten_with_names

        axes = dict(named_axes(axes_tree))
        return {n: self.placements(axes[n], tuple(x.shape)) for n, x in flatten_with_names(tree)}


def batch_logical_axes(batch: dict) -> dict:
    """Logical axes for an input batch pytree."""
    out = {}
    for k, v in batch.items():
        if k == "tokens":
            out[k] = ("batch", "seq") + ((None,) if v.ndim == 3 else ())
        elif k == "image_embeds":
            out[k] = ("batch", None, None)
        elif k == "loss_mask":
            out[k] = ("batch", "seq")
        else:
            out[k] = (None,) * v.ndim
    return out
