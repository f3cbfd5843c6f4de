"""The port's mesh rules, meshes and placement against the reference's.

1. ``Rules.spec`` equals the reference's PartitionSpec for every leaf of the
   param, train-state, cache and batch trees of all ten archs at full width,
   at the production meshes (16, 16) and (2, 16, 16) and at (4, 2), (2, 4),
   (8, 1), (1, 8), (2, 2, 2) and (1, 1), also with overrides and without
   FSDP; the logical-axes trees equal the reference's.  The reference's
   ``Rules`` reads only ``mesh.axis_names`` and ``mesh.devices.shape``, so a
   stand-in with those two gives it the production meshes without 256
   devices.  ``axis_group_size`` equals the reference's.
2. The ambient mesh context nests and resets.
3. Each mesh coordinate's block of a leaf (``Rules.local_slices``) equals
   JAX's ``NamedSharding.devices_indices_map`` at (4, 2) and (2, 2, 2), in a
   JAX subprocess with 8 forced host devices.
4. On 8 gloo ranks at (4, 2) and (2, 2, 2): ``place_tree`` gives each rank
   that block as a ``DTensor`` whose ``full_tensor()`` is the host leaf, and
   ``fetch_tree`` gives the host tree back bit for bit.
"""
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs.base import get_config as ref_get_config
from repro.models import model as RM
from repro.parallel import mesh_rules as RMR
from repro.train import step as RTS
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_mesh, make_production_mesh
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.parallel.context import current_mesh, current_rules, use_mesh_context
from repro_torch.parallel.mesh_rules import Rules, batch_logical_axes, named_axes
from repro_torch.train import step as TS
from repro_torch.utils.tree import flatten_with_names
from torch_gloo import SRC, launch, last_json

MESHES = [(16, 16), (2, 16, 16), (4, 2), (2, 4), (8, 1), (1, 8), (2, 2, 2), (1, 1)]
VARIANTS = [{}, {"fsdp": False},
            {"overrides": {"seq": (5, [("model",)]), "heads": (1, []),
                           "vocab": (1, [("data",), ("model",)]),
                           "expert": (0, [("data",)])}}]


def _names(shape):
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def _ref_rules(shape, **kw):
    stand_in = types.SimpleNamespace(axis_names=_names(shape),
                                     devices=np.empty(shape, dtype=object))
    return RMR.Rules(stand_in, **kw)


def _port_rules(shape, **kw):
    return Rules(Mesh(shape, _names(shape)), **kw)


def _batches(cfg):
    """Batches of the shapes the train step sees (B 256, which every mesh
    splits, and B 12, which falls back), with their extra inputs."""
    out = []
    for B in (256, 12):
        tok = np.zeros((B, 32, cfg.num_codebooks) if cfg.num_codebooks else (B, 32), np.int32)
        b = {"tokens": tok, "loss_mask": np.ones((B, 32), np.float32)}
        if cfg.num_image_tokens:
            b["image_embeds"] = np.zeros((B, cfg.num_image_tokens, cfg.d_model), np.float32)
        out.append(b)
    return out


def _trees(arch):
    """[(tree, port axes, reference axes, {path: shape})] of the param,
    train-state, cache and batch trees at full width."""
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    oc = adamw.OptConfig()
    trees = [("params", M.param_logical_axes(cfg), RM.param_logical_axes(rcfg),
              M.abstract_params(cfg)),
             ("state", TS.state_logical_axes(cfg), RTS.state_logical_axes(rcfg),
              TS.abstract_train_state(cfg, oc))]
    for batch, max_seq in ((16, 1024), (4, 96)):
        _, rax = RM.cache_specs(rcfg, batch, max_seq)
        shapes = M.cache_specs(cfg, batch, max_seq)
        trees.append((f"cache B{batch}", M.cache_logical_axes(cfg, batch, max_seq), rax,
                      {n: s for n, (s, _) in _cache_leaves(shapes)}))
    for b in _batches(cfg):
        trees.append((f"batch B{b['tokens'].shape[0]}", batch_logical_axes(b),
                      RMR.batch_logical_axes(b), b))
    return [(what, dict(named_axes(ax)), dict(named_axes(rax)),
             tree if what.startswith("cache") else
             {n: tuple(x.shape) for n, x in flatten_with_names(tree)})
            for what, ax, rax, tree in trees]


def _cache_leaves(specs, path=()):
    for k in sorted(specs):
        v = specs[k]
        if isinstance(v, dict):
            yield from _cache_leaves(v, path + (k,))
        else:
            yield "/".join(path + (k,)), v


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_equals_the_reference_for_every_leaf(arch):
    trees = _trees(arch)
    for what, ax, rax, shapes in trees:
        assert ax == rax, f"{arch} {what}: logical axes differ from the reference's"
        assert set(shapes) == set(ax), f"{arch} {what}: leaves and axes differ"
    checked = 0
    for shape in MESHES:
        for kw in VARIANTS:
            port, ref = _port_rules(shape, **kw), _ref_rules(shape, **kw)
            for what, ax, _, shapes in trees:
                for name, leaf_shape in shapes.items():
                    got = port.spec(ax[name], leaf_shape)
                    want = tuple(ref.spec(ax[name], leaf_shape))
                    assert got == want, (arch, shape, kw, what, name, got, want)
                    checked += 1
    assert checked > 1000


@pytest.mark.parametrize("shape", MESHES)
def test_axis_group_size_and_placements(shape):
    for kw in VARIANTS:
        port, ref = _port_rules(shape, **kw), _ref_rules(shape, **kw)
        for name in list(port.table) + ["unknown"]:
            assert port.axis_group_size(name) == ref.axis_group_size(name), (shape, kw, name)
    # placements: Shard(d) on each mesh dim that splits tensor dim d
    from torch.distributed.tensor import Replicate, Shard

    rules = _port_rules(shape)
    names = _names(shape)
    cfg = get_config("granite-moe-3b-a800m")
    state = TS.abstract_train_state(cfg, adamw.OptConfig())
    ax = dict(named_axes(TS.state_logical_axes(cfg)))
    assert rules.tree_placements(TS.state_logical_axes(cfg), state) == {
        n: rules.placements(ax[n], tuple(x.shape)) for n, x in flatten_with_names(state)}
    for axes, dims in ((("batch", "seq"), (256, 32)), (("expert", "embed", "mlp"), (256, 64, 64)),
                       (("vocab", "embed"), (1024, 64))):
        pl = rules.placements(axes, dims)
        assert len(pl) == len(names)
        for j, a in enumerate(names):
            split = [d for d, e in enumerate(rules.dim_axes(axes, dims)) if a in e]
            assert pl[j] == (Shard(split[0]) if split else Replicate()), (shape, axes, pl)


def test_production_and_host_meshes():
    m = make_production_mesh()
    assert (m.shape, m.axis_names, m.device_mesh) == ((16, 16), ("data", "model"), None)
    m = make_production_mesh(multi_pod=True)
    assert (m.shape, m.axis_names) == ((2, 16, 16), ("pod", "data", "model"))
    assert Rules(m).axis_group_size("batch") == 32
    h = make_host_mesh()
    assert (h.shape, h.axis_names, h.device_mesh, h.coordinate) == ((1, 1), ("data", "model"),
                                                                    None, (0, 0))
    assert not torch.distributed.is_initialized()
    assert h.group(("data",)) is None and h.group(("data", "model")) is None
    assert make_mesh((1, 1)).shape == (1, 1)
    with pytest.raises(ValueError, match="process group"):
        make_mesh((4, 2))
    with pytest.raises(ValueError, match="no rank"):
        _ = m.coordinate
    rules = Rules(h)
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        ax = dict(named_axes(TS.state_logical_axes(cfg)))
        for n, x in flatten_with_names(TS.abstract_train_state(cfg, adamw.OptConfig())):
            assert rules.is_replicated(ax[n], tuple(x.shape)), (arch, n)
    assert rules.axis_group_size("batch") == 1


def test_mesh_context_nests_and_resets():
    assert current_mesh() is None and current_rules() is None
    a, b = make_production_mesh(), make_host_mesh()
    ra, rb = Rules(a), Rules(b)
    with use_mesh_context(a, ra):
        assert current_mesh() is a and current_rules() is ra
        with use_mesh_context(b, rb):
            assert current_mesh() is b and current_rules() is rb
        assert current_mesh() is a and current_rules() is ra
        with use_mesh_context(b):
            assert current_mesh() is b and current_rules() is None
        assert current_rules() is ra
    assert current_mesh() is None and current_rules() is None


# ---------------------------------------------------------------------------
# 3-4. each coordinate's block: JAX's devices_indices_map, and DTensor's
# ---------------------------------------------------------------------------

BLOCK_MESHES = [(4, 2), (2, 2, 2)]


def _block_cases():
    """(logical axes, shape) of real leaves: reduced llama3.2-1b's params,
    full-width granite-moe and deepseek-v3 expert leaves (split over
    ("pod", "data") at (2, 2, 2)), a cache and a batch."""
    from repro_torch.configs.base import reduced

    cfg = reduced(get_config("llama3.2-1b"))
    ax = dict(named_axes(M.param_logical_axes(cfg)))
    cases = [(ax[n], tuple(x.shape)) for n, x in flatten_with_names(M.abstract_params(cfg))]
    for arch in ("granite-moe-3b-a800m", "deepseek-v3-671b"):
        big = get_config(arch)
        bax = dict(named_axes(M.param_logical_axes(big)))
        cases += [(bax[n], tuple(x.shape)) for n, x in flatten_with_names(M.abstract_params(big))
                  if "wi_gate" in n]
    cax = dict(named_axes(M.cache_logical_axes(cfg, 8, 64)))
    cases += [(cax[n], s) for n, (s, _) in _cache_leaves(M.cache_specs(cfg, 8, 64))]
    cases += [(("batch", "seq"), (8, 32)), (("batch", "seq", None), (8, 32, 4))]
    return cases


_JAX_BLOCKS = """
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
cases = json.loads(sys.stdin.read())
out = {}
for mesh_shape in [(4, 2), (2, 2, 2)]:
    names = ("data", "model") if len(mesh_shape) == 2 else ("pod", "data", "model")
    mesh = jax.make_mesh(mesh_shape, names)
    res = []
    for spec, shape in cases[str(mesh_shape)]:
        spec = [tuple(e) if isinstance(e, list) else e for e in spec]
        idx = NamedSharding(mesh, P(*spec)).devices_indices_map(tuple(shape))
        per = {}
        for coord in np.ndindex(mesh.devices.shape):
            sl = idx[mesh.devices[coord]]
            per[",".join(map(str, coord))] = [list(s.indices(n)[:2]) for s, n in zip(sl, shape)]
        res.append(per)
    out[str(mesh_shape)] = res
print(json.dumps(out))
"""


def test_blocks_equal_jax_devices_indices_map():
    cases = _block_cases()
    payload = {str(m): [[[list(e) if isinstance(e, tuple) else e
                          for e in _port_rules(m).spec(ax, s)], list(s)] for ax, s in cases]
               for m in BLOCK_MESHES}
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _JAX_BLOCKS], input=json.dumps(payload), env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    want = json.loads(r.stdout.strip().splitlines()[-1])
    split_two = 0
    for m in BLOCK_MESHES:
        rules = _port_rules(m)
        for (ax, shape), per in zip(cases, want[str(m)]):
            split_two += any(len(e) > 1 for e in rules.dim_axes(ax, shape))
            for coord in np.ndindex(m):
                got = [[s.start, s.stop] for s in rules.local_slices(ax, shape, coord)]
                assert got == per[",".join(map(str, coord))], (m, ax, shape, coord)
    assert split_two >= 4          # dims split over ("pod", "data") were among them


_PLACE = """
from repro_torch.checkpoint.serialization import host_array
from repro_torch.configs.base import get_config, reduced
from repro_torch.core.virtualization import fetch_tree, place_tree
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as M
from repro_torch.parallel.mesh_rules import Rules, named_axes
from repro_torch.utils.tree import flatten_with_names, tree_map

# bfloat16 leaves too: their blocks travel as the raw 2-byte payload
cfg = reduced(get_config("granite-moe-3b-a800m")).replace(param_dtype="bfloat16")
host = tree_map(host_array, M.init_params(cfg, 7, "cpu").tree)
axes = M.param_logical_axes(cfg)
ax = dict(named_axes(axes))
hflat = dict(flatten_with_names(host))
report = {}
for shape in [(4, 2), (2, 2, 2)]:
    mesh = make_mesh(shape)
    rules = Rules(mesh)
    placed = place_tree(host, axes, rules, "cpu")
    n_dt = ok_local = ok_full = 0
    for n, x in flatten_with_names(placed):
        h = hflat[n]
        if hasattr(x, "to_local"):
            n_dt += 1
            loc = x.to_local()
            ok_local += bool(np.array_equal(host_array(loc), h[rules.local_slices(ax[n], h.shape)]))
            ok_full += bool(np.array_equal(host_array(x.full_tensor()), h))
        else:
            ok_local += 1
            ok_full += bool(np.array_equal(host_array(x), h))
    back = dict(flatten_with_names(fetch_tree(placed)))
    same = all(back[n].dtype == hflat[n].dtype and back[n].tobytes() == hflat[n].tobytes()
               for n in hflat)
    g = mesh.group(("pod", "data")) if len(shape) == 3 else mesh.group(("data",))
    t = torch.ones(()) * (RANK + 1)
    dist.all_reduce(t, group=g)
    report[str(shape)] = {"leaves": len(hflat), "dtensors": n_dt, "local": ok_local,
                          "full": ok_full, "fetch_same": same, "coord": list(mesh.coordinate),
                          "group_sum": float(t)}
print(json.dumps(report))
"""


def test_place_tree_blocks_on_eight_gloo_ranks(tmp_path):
    outs = launch(_PLACE, 8, tmp_path)
    for rank, out in enumerate(outs):
        rep = last_json(out)
        for shape, r in rep.items():
            assert r["dtensors"] > 0, (rank, shape)
            assert r["local"] == r["leaves"] and r["full"] == r["leaves"], (rank, shape, r)
            assert r["fetch_same"], (rank, shape)
            assert tuple(r["coord"]) == np.unravel_index(rank, eval(shape)), (rank, shape)
        # ("pod","data") at (2,2,2): the four ranks of one "model" coordinate
        peers = [q for q in range(8) if q % 2 == rank % 2]
        assert rep["(2, 2, 2)"]["group_sum"] == sum(q + 1 for q in peers)
        assert rep["(4, 2)"]["group_sum"] == sum(q + 1 for q in peers)


def test_engine_routes_with_the_batch_shard_count(monkeypatch):
    """The engine's MoE group count is the rules' batch shard count, as the
    reference's prefill step takes it: 1 on one rank, 32 on (2, 16, 16)."""
    from repro_torch.configs.base import reduced
    from repro_torch.serve.engine import Engine

    cfg = reduced(get_config("granite-moe-3b-a800m"))
    model = M.init_params(cfg, 0, "cpu")
    assert Engine(cfg, model, batch=2, max_seq=16,
                  rules=Rules(make_production_mesh(multi_pod=True))).moe_groups == 32
    eng = Engine(cfg, model, batch=2, max_seq=16)
    seen = []
    prefill = M.prefill

    def spy(*a, **kw):
        seen.append(kw["moe_groups"])
        return prefill(*a, **kw)

    monkeypatch.setattr(M, "prefill", spy)
    eng.prefill({"tokens": torch.zeros((2, 8), dtype=torch.int32)})
    assert eng.moe_groups == 1 and seen == [1]
