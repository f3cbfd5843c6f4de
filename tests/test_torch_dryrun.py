"""The port's dry run (``launch/dryrun.py``) against real ranks and the reference.

Reduced qwen2-0.5b (and, for the train step's collectives, reduced
granite-moe-3b-a800m), train B8 S32, prefill B8 S32, decode B8 at a cache of
64:

1. At (2, 4) and (4, 2), the collectives the dry run counts on rank 0 of a
   fake group (meta tensors) equal, by kind, in count and in bytes, what the
   same walk counts on rank 0 of 8 gloo CPU ranks running the same step on
   real tensors (tests/torch_gloo.py).
2. At those meshes, ``argument_size`` (rank 0's bytes of its arguments)
   equals the reference's per-device shard bytes: each leaf's
   ``NamedSharding.shard_shape`` under the reference's rules, in a JAX
   subprocess.
3. At (1, 1), the dry run's FLOPs against the reference's ``analyze_hlo_text``
   of its compiled step (``impl="xla"``, JAX subprocess).  The difference is
   accounted for item by item, and the test holds it exactly:
   - prefill: the reference's XLA attention computes every (query, key)
     pair, 2 B H S^2 (Dq + Dv) a layer; the port's ``flash`` kernel computes
     the causal half, S(S+1)/2 pairs.  The rest (the projections, the MLP,
     the last position's logits) is the same products.  So the port counts
     ``2 B H L (S^2 - S(S+1)/2)(Dq + Dv)`` fewer: 8,126,464 of 319,815,680,
     2.54% at this shape;
   - decode: equal (both read the whole cache: the port charges
     ``flash_decode`` its cache length when kv_len is a tensor);
   - train: the port counts the ``flash`` kernel's forward in addition: its
     backward recomputes the plain attention (every pair) and
     differentiates that, as the reference's XLA path does with its one
     forward, so the kernel's own forward is the surplus: 8,650,752 of
     1,056,964,608 (0.82%).
   The stated tolerance, before the correction: 2.6% for prefill, 0.9% for
   train, exact for decode; after it, exact.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch_gloo import launch, last_json

SRC = str(Path(__file__).resolve().parents[1] / "src")
MESHES = [(2, 4), (4, 2)]
# (kind, seq_len, global batch)
KINDS = [("train", 32, 8), ("prefill", 32, 8), ("decode", 64, 8)]
CASES = [("qwen2-0.5b", k) for k in KINDS] + [("granite-moe-3b-a800m", KINDS[0])]

_PORT = """
import json
from repro_torch.configs.base import ShapeConfig, get_config, reduced
from repro_torch.launch import dryrun as D
out = {}
for mesh in [(1, 1), (2, 4), (4, 2)]:
    for arch, (kind, seq, batch) in CASES:
        if mesh == (1, 1) and arch != "qwen2-0.5b":
            continue
        walk, _ = D.walk_cell(reduced(get_config(arch)), ShapeConfig(kind, kind, seq, batch), mesh)
        c = walk.costs()
        out[f"{mesh}|{arch}|{kind}"] = {
            "flops": c["flops"], "collectives": c["collectives"],
            "collective_counts": c["collective_counts"],
            "kernels": {k: v["calls"] for k, v in c["kernels"].items()},
            "argument_size": walk.memory["argument_size"]}
print(json.dumps(out))
"""

_GLOO = """
from torch.distributed.tensor import DTensor
from repro_torch.configs.base import ShapeConfig, get_config, reduced
from repro_torch.launch import dryrun as D
from repro_torch.launch.hlo_costs import analyze_step
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel.mesh_rules import Rules
from repro_torch.utils.tree import tree_map

CASES = json.loads(ARGS[0])


def real(x):
    # the dry run's meta argument as zeros on the CPU, placed alike
    if isinstance(x, DTensor):
        return DTensor.from_local(torch.zeros(x.to_local().shape, dtype=x.dtype),
                                  x.device_mesh, x.placements, run_check=False)
    return torch.zeros(x.shape, dtype=x.dtype)


out = {}
for mesh in [(2, 4), (4, 2)]:
    rules = Rules(make_mesh(mesh))
    for arch, (kind, seq, batch) in CASES:
        step, args = D.build_step(reduced(get_config(arch)), ShapeConfig(kind, kind, seq, batch),
                                  rules)
        c = analyze_step(step, *tree_map(real, list(args)))
        out[f"{mesh}|{arch}|{kind}"] = {"collectives": c["collectives"],
                                        "collective_counts": c["collective_counts"]}
if RANK == 0:
    print(json.dumps(out))
"""

_REF = """
import json
from repro.launch import dryrun as D      # forces 512 host devices: this process only
import jax
import numpy as np
from jax.sharding import AxisType
from repro.configs.base import ShapeConfig, get_config, reduced
from repro.launch import specs as SP
from repro.launch.hlo_costs import analyze_hlo_text
from repro.models import model as M
from repro.parallel.mesh_rules import Rules, batch_logical_axes
from repro.train.step import state_logical_axes

cfg = reduced(get_config("qwen2-0.5b"))
KINDS = json.loads(__import__("sys").argv[1])


def is_axes(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def mesh_of(shape):
    return jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2)


out = {"shard_bytes": {}, "flops": {}}
for mesh_shape in [(2, 4), (4, 2)]:
    rules = Rules(mesh_of(mesh_shape))
    for kind, seq, batch in KINDS:
        _, args = SP.input_specs(cfg, ShapeConfig(kind, kind, seq, batch))
        if kind == "train":
            axes = (state_logical_axes(cfg), batch_logical_axes(args[1]))
        elif kind == "prefill":
            axes = (M.param_logical_axes(cfg), batch_logical_axes(args[1]))
        else:
            axes = (M.param_logical_axes(cfg), M.cache_specs(cfg, batch, seq)[1], ("batch",))
        per_leaf = jax.tree_util.tree_map(
            lambda ax, s: int(np.prod(rules.sharding(ax, s.shape).shard_shape(s.shape)))
            * s.dtype.itemsize, axes, tuple(args), is_leaf=is_axes)
        out["shard_bytes"][f"{mesh_shape}|{kind}"] = sum(jax.tree_util.tree_leaves(per_leaf))
mesh = mesh_of((1, 1))
for kind, seq, batch in KINDS:
    step, args, in_sh = D.build_step(cfg, ShapeConfig(kind, kind, seq, batch), mesh, impl="xla")
    args = jax.tree_util.tree_map(
        lambda s, sh: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=sh), args, in_sh)
    with mesh:
        out["flops"][kind] = analyze_hlo_text(step.lower(*args).compile().as_text())["flops"]
print(json.dumps(out))
"""


def _env():
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    return env


def _last_json(code, *args):
    r = subprocess.run([sys.executable, "-c", code, *args], env=_env(), capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-6000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port():
    """The dry run's records, from a process of their own (a cell starts
    and destroys a fake process group)."""
    return _last_json(f"CASES = {CASES!r}\n" + _PORT)


@pytest.fixture(scope="module")
def reference():
    pytest.importorskip("jax")
    return _last_json(_REF, json.dumps(KINDS))


def test_fake_group_collectives_equal_8_gloo_ranks(port, tmp_path):
    outs = launch(_GLOO, 8, tmp_path, json.dumps(CASES), timeout=400)
    gloo = last_json(outs[0])
    assert set(gloo) == {f"{m}|{a}|{k[0]}" for m in MESHES for a, k in CASES}
    for key, want in gloo.items():
        got = port[key]
        assert (got["collectives"], got["collective_counts"]) == \
            (want["collectives"], want["collective_counts"]), key
        assert got["collective_counts"], key            # every step here communicates
    # the train step: each parameter gathered over its non-"model" axes, the
    # activations of the tensor-parallel products summed over "model", the
    # gradients reduce-scattered to their blocks (the replicated ones summed)
    assert set(gloo["(2, 4)|qwen2-0.5b|train"]["collectives"]) == {
        "all-gather", "all-reduce", "reduce-scatter"}


def test_argument_size_equals_the_references_shard_bytes(port, reference):
    for mesh in MESHES:
        for kind, _, _ in KINDS:
            assert port[f"{mesh}|qwen2-0.5b|{kind}"]["argument_size"] == \
                reference["shard_bytes"][f"{mesh}|{kind}"], (mesh, kind)


def test_flops_at_one_rank_against_the_references_compiled_step(port, reference):
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.kernels import costs

    cfg = reduced(get_config("qwen2-0.5b"))
    L, H, Dh = cfg.num_layers, cfg.num_heads, cfg.head_dim
    ref = reference["flops"]
    got = {k: port[f"(1, 1)|qwen2-0.5b|{k}"]["flops"] for k, _, _ in KINDS}
    B, S = 8, 32
    masked_half = 2 * B * H * L * (S * S - S * (S + 1) // 2) * (2 * Dh)
    assert abs(got["prefill"] - ref["prefill"]) <= 0.026 * ref["prefill"]
    assert got["prefill"] + masked_half == ref["prefill"]
    assert got["decode"] == ref["decode"]
    kernel_forward = port["(1, 1)|qwen2-0.5b|train"]["kernels"]["flash"] * \
        costs.flash(B // 4, S, S, H, cfg.num_kv_heads, Dh, Dh, 2)[0]     # 4 microbatches
    assert abs(got["train"] - ref["train"]) <= 0.009 * ref["train"]
    assert got["train"] == ref["train"] + kernel_forward
