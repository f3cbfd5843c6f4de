"""Expert parallelism (``parallel/ep.py``, ``models/moe.py`` on the mesh) on
gloo CPU ranks (tests/torch_gloo.py), against the port at one rank, the
reference's loss and the reference's compiled per-device FLOPs.

Inputs: reduced granite-moe-3b-a800m (4 MoE layers of 8 experts, top-2,
``moe_d_ff`` 64, float32) and deepseek-v3-671b (1 dense MLA layer, 3 MoE
layers with a shared expert, the MTP block; float64, as
tests/test_torch_tp_mla.py finds necessary), at capacity factor 4, where no
expert overflows (ROADMAP §3 fault 8), so the routing groups of a mesh do
not change which tokens an expert takes; the train state of
``init_train_state(cfg, oc, 3)`` and ``SyntheticTokens(cfg, 8, 64, seed=5)``
(B8 S64), made alike in every process.

(a) ``moe_ffn`` under ``tp.computing_on_blocks`` on 2 and 4 ranks at (n, 1),
    (1, n) and (2, 2), on this rank's rows and blocks of the rules (the
    experts over "data" where 8 divides it, ``moe_d_ff`` and the shared
    expert over "model"), routed with the batch shard count as the train
    step routes, against the whole weights at one rank: outputs within 1e-5,
    input and weight gradients within 1e-5 of each one's largest |gradient|
    (float32), the 16-bit and the int8 dispatch.  All-to-alls run exactly
    where the experts split; at one rank (no rules) ``moe_ffn`` is the plain
    path, bit for bit, and runs none.
(b) Both archs trained at (2, 1), (2, 4), (4, 2) and (1, 8): step 0's
    gradients (gathered whole) within 1e-5 of each leaf's largest
    |gradient| of the port's at (1, 1), step 0's clip norm within rtol
    1e-5, four losses within 5e-4; the first loss at (2, 4) within 1e-5 of
    the reference's one-device ``loss_fn`` (``impl="xla"``).
(c) The dry run's walks (``launch/dryrun.walk_cell``, a fake group) against
    the reference's compiled per-device FLOPs (``build_step(impl="xla")``,
    in a JAX subprocess as tests/test_torch_tp_mla.py (c) runs it), at B8:
    train S64 at most 1.10x (granite-moe) and 1.15x (deepseek-v3) at (2, 4)
    and (4, 2), at most 2.0x at (1, 8), and the parent's counts at (1, 1)
    for train, prefill S32 and decode at a cache of 64.  The walk's
    "experts" section holds exactly the routed experts' products: over the
    MoE layers and microbatches 2 * 3 * G * E * C * D * F (times 3 for the
    train step's backward) over the shard counts the rules give "expert"
    and "mlp".  The serving walks fall from the walk with the experts read
    whole and decode routed per rank by exactly the products that split
    and the change to one routing group.
(d) In the train walks no expert leaf's gradient is all-reduced or
    reduce-scattered over its expert axes, and no whole gradient of a leaf
    split over "model" is all-reduced.
(e) Both archs served at (2, 1) and (2, 2): tokens equal one rank's.  The
    reference's decode routes the batch as one group (ROADMAP §3 fault 14):
    a decode batch of 16 rows at (2, 1), the router weighted so that more
    than C entries pick one expert, drops exactly the entries that one
    group over all 16 rows drops (a per-token oracle), and its output
    equals the port's at one rank.
(f) A checkpoint that the (2, 4) ranks of (b) write restores at one rank to
    the same bytes, and the next step's loss equals the continuing run's
    within 5e-4.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_config, reduced
from torch_gloo import launch, last_json

SRC = str(Path(__file__).resolve().parents[1] / "src")
GRANITE, DEEPSEEK = "granite-moe-3b-a800m", "deepseek-v3-671b"
ARCHS = [GRANITE, DEEPSEEK]
OUT_TOL = 1e-5
GRAD_TOL = 1e-5          # of a leaf's largest |gradient|


def config_of(arch, dtype=None):
    cfg = reduced(get_config(arch)).replace(capacity_factor=4.0)
    dtype = dtype or ("float64" if arch == DEEPSEEK else "float32")
    return cfg.replace(param_dtype=dtype, compute_dtype=dtype)


# ---------------------------------------------------------------------------
# (a): moe_ffn on blocks against whole weights
# ---------------------------------------------------------------------------

_OPS = """
from repro_torch.configs.base import get_config, reduced
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.parallel import ep, tp
from repro_torch.parallel.context import use_mesh_context
from repro_torch.parallel.mesh_rules import Rules
from repro_torch.utils.tree import flatten_with_names, unflatten_like

shape = eval(ARGS[0])
rules = Rules(make_mesh(shape))
data = rules.mesh.group(("data",))
B, S = 4, 16
rows = rules.local_slices(("batch", "seq"), (B, S))[0]
report = {}
for arch in ("granite-moe-3b-a800m", "deepseek-v3-671b"):
    for bits in (16, 8):
        cfg = reduced(get_config(arch)).replace(capacity_factor=4.0, moe_dispatch_bits=bits)
        specs = MOE.moe_spec(cfg)
        whole = L.materialize(specs, 11, torch.float32)
        rng = np.random.default_rng(7)          # the same draws on every rank
        x = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model)).astype(np.float32))
        g = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model)).astype(np.float32))
        groups = rules.axis_group_size("batch")

        def run(tree, xs, gs, **kw):
            leaves = {k: t.detach().clone().requires_grad_(True)
                      for k, t in flatten_with_names(tree)}
            xr = xs.detach().clone().requires_grad_(True)
            out, aux = MOE.moe_ffn(unflatten_like(tree, leaves), cfg, xr, **kw)
            (torch.sum(out * gs) + aux).backward()
            return out.detach(), float(aux), xr.grad, {k: t.grad for k, t in leaves.items()}

        out_w, aux_w, gx_w, grads_w = run(whole, x, g, moe_groups=groups)
        own = {}
        for k, s in flatten_with_names(specs):
            over = ("model",) + (ep.expert_axes(rules, s) if k in ("wi_gate", "wi_up", "wo")
                                 else ())
            own[k] = tuple(sl if set(a) <= set(over) else slice(None) for sl, a in
                           zip(rules.local_slices(s.axes, s.shape),
                               rules.dim_axes(s.axes, s.shape)))
        blk = unflatten_like(whole, {k: t[own[k]] for k, t in flatten_with_names(whole)})
        ep.COUNTS["all_to_all"] = 0
        tp.COUNTS["block_products"] = 0
        with use_mesh_context(rules.mesh, rules), tp.computing_on_blocks():
            out_b, aux_b, gx_b, grads_b = run(blk, x[rows], g[rows], batch_group=data,
                                              moe_groups=groups // (B // (rows.stop - rows.start)))
        shapes = {k: tuple(t.shape) for k, t in flatten_with_names(whole)}
        errs = {"a2a": ep.COUNTS["all_to_all"], "block_products": tp.COUNTS["block_products"],
                "split": sorted(k for k, t in flatten_with_names(blk)
                                if tuple(t.shape) != shapes[k])}
        aux_t = torch.tensor(aux_b)
        if data is not None:
            dist.all_reduce(aux_t, group=data)
        errs["aux"] = abs(float(aux_t) - aux_w)
        errs["forward"] = float((out_b - out_w[rows]).abs().max())
        errs["input backward"] = float((gx_b - gx_w[rows]).abs().max() / gx_w.abs().max())
        wb = 0.0
        for k, gb in grads_b.items():
            split_ex = k in ("wi_gate", "wi_up", "wo") and ep.expert_axes(rules, specs[k]) != ()
            if data is not None and not split_ex:       # a share of this rank's rows
                dist.all_reduce(gb, group=data)
            ref = grads_w[k][own[k]]
            wb = max(wb, float((gb - ref).abs().max() / grads_w[k].abs().max()))
        errs["weight backward"] = wb
        report[f"{arch}|{bits}"] = errs
if RANK == 0:
    print(json.dumps(report))
"""


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2), (4, 1), (1, 4), (2, 2)], ids=str)
def test_moe_ffn_on_blocks_matches_whole_weights(mesh, tmp_path):
    """(a) on ranks."""
    rep = last_json(launch(_OPS, int(np.prod(mesh)), tmp_path, str(mesh))[0])
    experts_split = mesh[0] > 1
    for key, errs in rep.items():
        arch, bits = key.split("|")
        want = (["wi_gate", "wi_up", "wo"] if experts_split or mesh[1] > 1 else [])
        if arch == DEEPSEEK and mesh[1] > 1:
            want = sorted(want + ["shared/down/w", "shared/gate/w", "shared/up/w"])
        assert errs["split"] == want, (key, errs["split"])
        # forward: to and from the experts; backward: both reversed
        assert errs["a2a"] == ((5 if bits == "8" else 4) if experts_split else 0), (key, errs)
        per_call = (3 if mesh[1] > 1 else 0) * (2 if arch == DEEPSEEK else 1)
        assert errs["block_products"] == per_call, (key, errs)
        for name in ("aux", "forward", "input backward", "weight backward"):
            assert errs[name] <= OUT_TOL, (key, name, errs[name])


def test_moe_ffn_at_one_rank_is_the_plain_path():
    """(a) at one rank: no rules, every leaf whole, no all-to-all."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    from repro_torch.parallel import ep, tp

    for arch in ARCHS:
        for bits in (16, 8):
            cfg = config_of(arch, "float32").replace(moe_dispatch_bits=bits)
            p = L.materialize(MOE.moe_spec(cfg), 11, torch.float32)
            x = torch.from_numpy(np.random.default_rng(2).standard_normal(
                (2, 8, cfg.d_model)).astype(np.float32))
            want = MOE.moe_ffn(p, cfg, x, 2)
            want_dec = MOE.moe_ffn(p, cfg, x[:, :1], 1)
            ep.COUNTS["all_to_all"] = tp.COUNTS["block_products"] = 0
            with tp.computing_on_blocks():
                got = MOE.moe_ffn(p, cfg, x, 2)
                got_dec = MOE.moe_ffn(p, cfg, x[:, :1], 1, row_axes=())
            assert ep.COUNTS["all_to_all"] == 0 and tp.COUNTS["block_products"] == 0
            for w, g in zip(want + want_dec[:1], got + got_dec[:1]):
                assert torch.equal(w, g)


# ---------------------------------------------------------------------------
# (b), (f): training on gloo ranks against the port at one rank; C/R
# ---------------------------------------------------------------------------

TRAIN_MESHES = ["(2, 1)", "(2, 4)", "(4, 2)", "(1, 8)"]
CKPT_MESH = "(2, 4)"
B, S, STEPS = 8, 64, 4
OPT = dict(warmup_steps=1, decay_steps=10)
LOSS_TOL = 5e-4          # the reference's elastic limit
REF_LOSS_TOL = 1e-5
NORM_RTOL = 1e-5

_RANK = """
from pathlib import Path
from torch.distributed.tensor import DTensor
from repro_torch.checkpoint.manager import CheckpointManager, CheckpointPolicy
from repro_torch.checkpoint.store import TieredStore
from repro_torch.configs.base import get_config, reduced
from repro_torch.core.virtualization import fetch_tree, place_tree
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim import adamw
from repro_torch.parallel import ep, tp
from repro_torch.parallel.mesh_rules import Rules
from repro_torch.train import step as TS
from repro_torch.utils.tree import flatten_with_names

shape, work, save_at = eval(ARGS[0]), Path(ARGS[1]), int(ARGS[2])
archs, steps = json.loads(ARGS[3])
oc = adamw.OptConfig(**json.loads(ARGS[4]))
rules = Rules(make_mesh(shape))
captured = []
apply_updates = adamw.apply_updates


def capture(params, grads, *a, **kw):
    if not captured:
        captured.append(grads)
    return apply_updates(params, grads, *a, **kw)


adamw.apply_updates = capture
report = {}
for arch in archs:
    dtype = "float64" if arch == "deepseek-v3-671b" else "float32"
    cfg = reduced(get_config(arch)).replace(capacity_factor=4.0, param_dtype=dtype,
                                            compute_dtype=dtype)
    pipe = SyntheticTokens(cfg, 8, 64, seed=5)
    host = fetch_tree(TS.init_train_state(cfg, oc, 3, "cpu"))
    state = place_tree(host, TS.state_logical_axes(cfg), rules, "cpu")
    step = TS.make_train_step(cfg, oc, rules=rules)
    captured.clear()
    tp.COUNTS["block_products"] = ep.COUNTS["all_to_all"] = 0
    losses, norms = [], []
    for i in range(steps):
        if i == save_at:                    # a checkpoint before step i
            whole = fetch_tree(state)       # a collective: every rank gathers
            if RANK == 0:
                mgr = CheckpointManager(TieredStore(work / f"ckpt-{arch}"),
                                        CheckpointPolicy(delta=True))
                mgr.save(i, whole)
                mgr.commit(i)
                mgr.close()
                np.savez(work / f"state-{arch}.npz", **{
                    n: np.ascontiguousarray(x).view(np.uint8)
                    for n, x in flatten_with_names(whole)})
            dist.barrier()
        state, m = step(state, {k: torch.from_numpy(v) for k, v in pipe.batch_at(i).items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    grads = {}
    for n, p in flatten_with_names(state["params"]):
        g = dict(flatten_with_names(captured[0]))[n]
        if isinstance(p, DTensor):
            g = DTensor.from_local(g, p.device_mesh, p.placements, run_check=False).full_tensor()
        grads[n] = g.numpy()
    if RANK == 0:
        np.savez(work / f"grads-{arch}.npz", **grads)
    report[arch] = {"losses": losses, "grad_norm": norms[0],
                    "block_products": tp.COUNTS["block_products"],
                    "all_to_all": ep.COUNTS["all_to_all"]}
if RANK == 0:
    print(json.dumps(report))
"""


def _one_rank(arch):
    """(losses, step 0's gradients, step 0's clip norm) of the port at (1, 1)."""
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.optim import adamw
    from repro_torch.train import step as TS
    from repro_torch.utils.tree import flatten_with_names

    cfg = config_of(arch)
    oc = adamw.OptConfig(**OPT)
    pipe = SyntheticTokens(cfg, B, S, seed=5)
    state = TS.init_train_state(cfg, oc, 3, "cpu")
    captured = []
    apply_updates = adamw.apply_updates

    def capture(params, g, *a, **kw):
        if not captured:
            captured.append(g)
        return apply_updates(params, g, *a, **kw)

    losses, norms = [], []
    adamw.apply_updates = capture
    try:
        step = TS.make_train_step(cfg, oc)
        for i in range(STEPS):
            state, m = step(state, {k: torch.from_numpy(v) for k, v in pipe.batch_at(i).items()})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    finally:
        adamw.apply_updates = apply_updates
    return losses, {n: g.numpy() for n, g in flatten_with_names(captured[0])}, norms[0]


@pytest.fixture(scope="module")
def one_rank():
    return {arch: _one_rank(arch) for arch in ARCHS}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{mesh: (the rank-0 report, its folder)}, each mesh's ranks started
    when first asked for; the (2, 4) ranks also save before step 3."""
    done = {}

    def run(mesh):
        if mesh not in done:
            work = tmp_path_factory.mktemp("ep-ranks")
            outs = launch(_RANK, int(np.prod(eval(mesh))), work, mesh, work,
                          3 if mesh == CKPT_MESH else -1, json.dumps([ARCHS, STEPS]),
                          json.dumps(OPT), timeout=300)
            done[mesh] = (last_json(outs[0]), work)
        return done[mesh]

    return run


@pytest.mark.parametrize("mesh", TRAIN_MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_training_on_expert_blocks_matches_one_rank(mesh, arch, ranks, one_rank):
    """(b)."""
    rep, work = ranks(mesh)
    got = rep[arch]
    want_losses, want_grads, want_norm = one_rank[arch]
    shape = eval(mesh)
    assert (got["all_to_all"] > 0) == (shape[0] > 1), got      # 8 experts split over "data"
    assert (got["block_products"] > 0) == (shape[1] > 1), got
    assert abs(got["grad_norm"] - want_norm) <= NORM_RTOL * want_norm, \
        (got["grad_norm"], want_norm)
    have = np.load(work / f"grads-{arch}.npz")
    assert sorted(have.files) == sorted(want_grads)
    bad = {}
    for n, w in want_grads.items():
        e, scale = float(np.abs(have[n] - w).max(initial=0.0)), \
            float(np.abs(w).max(initial=0.0))
        if e > GRAD_TOL * max(scale, 1e-30):
            bad[n] = (e, scale)
    assert not bad, bad
    assert np.abs(np.array(got["losses"]) - np.array(want_losses)).max() <= LOSS_TOL, \
        (got["losses"], want_losses)


def _nest(named: dict) -> dict:
    out: dict = {}
    for n, x in named.items():
        *path, leaf = n.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = x
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_first_loss_at_2x4_matches_the_reference_loss_fn(arch, ranks):
    """(b), the reference."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs.base import get_config as ref_get_config
    from repro.configs.base import reduced as ref_reduced
    from repro.models import model as RM
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.optim import adamw
    from repro_torch.train import step as TS
    from repro_torch.utils.tree import flatten_with_names

    rep, _ = ranks("(2, 4)")
    cfg = config_of(arch, "float32")
    rcfg = ref_reduced(ref_get_config(arch)).replace(capacity_factor=4.0)
    params = TS.init_train_state(cfg, adamw.OptConfig(**OPT), 3, "cpu")["params"]
    tree = _nest({n: jnp.asarray(x.numpy()) for n, x in flatten_with_names(params)})
    batch = {k: jnp.asarray(v) for k, v in SyntheticTokens(cfg, B, S, seed=5).batch_at(0).items()}
    # the reference's one device routes the batch as one group; (2, 4)
    # routes two, which take the same tokens at capacity factor 4
    want, _ = jax.jit(lambda p, b: RM.loss_fn(p, rcfg, b, moe_groups=1, z_loss=1e-4,
                                              impl="xla"))(tree, batch)
    got = rep[arch]["losses"][0]
    assert abs(got - float(want)) <= REF_LOSS_TOL, (got, float(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_of_ep_ranks_restores_at_one_rank(arch, ranks):
    """(f): the (2, 4) ranks' checkpoint before step 3, restored at one
    rank: the same bytes, and step 3's loss within 5e-4 of theirs."""
    from repro_torch.checkpoint.manager import CheckpointManager, CheckpointPolicy
    from repro_torch.checkpoint.store import TieredStore
    from repro_torch.core.virtualization import place_tree
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import adamw
    from repro_torch.parallel.mesh_rules import Rules
    from repro_torch.train import step as TS
    from repro_torch.utils.tree import flatten_with_names

    rep, work = ranks(CKPT_MESH)
    cfg = config_of(arch)
    oc = adamw.OptConfig(**OPT)
    mgr = CheckpointManager(TieredStore(work / f"ckpt-{arch}"), CheckpointPolicy(delta=True))
    host, _ = mgr.restore(TS.abstract_train_state(cfg, oc), promote=False)
    mgr.close()
    saved = np.load(work / f"state-{arch}.npz")
    named = dict(flatten_with_names(host))
    assert sorted(named) == sorted(saved.files)
    for n, x in named.items():
        assert np.ascontiguousarray(x).view(np.uint8).tobytes() == saved[n].tobytes(), n
    rules = Rules(make_host_mesh("cpu"))
    state = place_tree(host, TS.state_logical_axes(cfg), rules, "cpu")
    step = TS.make_train_step(cfg, oc, rules=rules)
    batch = SyntheticTokens(cfg, B, S, seed=5).batch_at(3)
    _, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(m["loss"]) - rep[arch]["losses"][3]) <= LOSS_TOL, \
        (float(m["loss"]), rep[arch]["losses"][3])


# ---------------------------------------------------------------------------
# (c), (d): the dry run's FLOPs a rank, its experts' section, its gradient
# collectives
# ---------------------------------------------------------------------------

WALK_MESHES = [(1, 1), (2, 4), (4, 2), (1, 8)]
SERVE_KINDS = [("prefill", 32), ("decode", 64)]        # (kind, seq), B8
# the parent's walk at (1, 1), before the experts computed on blocks
PARENT_AT_ONE = {
    GRANITE: {"train": 1_808_269_312, "prefill": 238_288_896, "decode": 17_891_328},
    DEEPSEEK: {"train": 3_162_782_720, "prefill": 300_744_704, "decode": 17_874_944},
}
TRAIN_RATIO = {GRANITE: {"(2, 4)": 1.10, "(4, 2)": 1.10, "(1, 8)": 2.0},
               DEEPSEEK: {"(2, 4)": 1.15, "(4, 2)": 1.15, "(1, 8)": 2.0}}

_PORT_WALK = """
import json
import torch.distributed as dist
from repro_torch.configs.base import ShapeConfig, get_config, reduced
from repro_torch.launch import dryrun as D
from repro_torch.models import model as M
from repro_torch.serve import engine as E
from repro_torch.train import step as TS

leaf, seen = [], []
own_block, all_reduce, reduce_scatter = TS.own_block, dist.all_reduce, TS._reduce_scatter
patched = {"tp_leaves": M.tp_leaves, "ep_leaves": M.ep_leaves, "_row_axes": E._row_axes}


def spy_own_block(rules, g, shape, axes, batch_axes):
    dims = rules.dim_axes(axes, shape)
    leaf.append({"shape": list(shape), "expert": "expert" in axes, "all_reduces": [],
                 "model": rules.axis_sizes["model"] > 1 and ("model",) in dims,
                 "reduce_scatters": 0})
    try:
        return own_block(rules, g, shape, axes, batch_axes)
    finally:
        seen.append(leaf.pop())


def spy_all_reduce(t, *a, **kw):
    if leaf:
        leaf[-1]["all_reduces"].append(list(t.shape))
    return all_reduce(t, *a, **kw)


def spy_reduce_scatter(*a, **kw):
    leaf[-1]["reduce_scatters"] += 1
    return reduce_scatter(*a, **kw)


def whole_experts():
    # the parent's serving: the MoE layers' leaves read whole, decode routed per rank
    M.tp_leaves = lambda cfg: {n for n in patched["tp_leaves"](cfg)
                               if not (n.split("/")[0] in moe_segs(cfg) and "/ffn/" in n)}
    M.ep_leaves = lambda cfg: set()
    E._row_axes = lambda rules, batch: ()


def moe_segs(cfg):
    return {f"seg{i}" for i, s in enumerate(M.layer_plan(cfg)) if s.kind.endswith("moe")}


TS.own_block, dist.all_reduce, TS._reduce_scatter = (spy_own_block, spy_all_reduce,
                                                     spy_reduce_scatter)
out = {}
for arch in ARCHS:
    cfg = reduced(get_config(arch))
    for mesh in MESHES:
        mesh = tuple(mesh)
        seen.clear()
        walk, _ = D.walk_cell(cfg, ShapeConfig("train", "train", 64, 8), mesh)
        c = walk.costs()
        out[f"{arch}|train|{mesh}"] = {"flops": c["flops"],
                                       "experts": c["section_flops"]["experts"],
                                       "leaves": seen[:]}
        for kind, seq in SERVE_KINDS:
            for name in ("blocks", "whole"):
                if name == "whole":
                    whole_experts()
                walk, _ = D.walk_cell(cfg, ShapeConfig(kind, kind, seq, 8), mesh)
                for k, v in patched.items():
                    setattr(M if k != "_row_axes" else E, k, v)
                c = walk.costs()
                out[f"{arch}|{kind}|{mesh}|{name}"] = {
                    "flops": c["flops"], "experts": c["section_flops"]["experts"]}
print(json.dumps(out))
"""

_REF_WALK = """
import json
from repro.launch import dryrun as D      # forces 512 host devices: this process only
import jax
from jax.sharding import AxisType
from repro.configs.base import ShapeConfig, get_config, reduced
from repro.launch.hlo_costs import analyze_hlo_text

out = {}
for arch in ARCHS:
    for shape in MESHES:
        mesh = jax.make_mesh(tuple(shape), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
        for kind, seq in JOBS:
            step, args, in_sh = D.build_step(reduced(get_config(arch)),
                                             ShapeConfig(kind, kind, seq, 8), mesh, impl="xla")
            args = jax.tree_util.tree_map(
                lambda s, sh: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=sh), args, in_sh)
            with mesh:
                out[f"{arch}|{kind}|{tuple(shape)}"] = analyze_hlo_text(
                    step.lower(*args).compile().as_text())["flops"]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def walks():
    """(the port's walks, the reference's compiled FLOPs), from five
    subprocesses run side by side: the port's walks, and for each arch the
    reference's train step and its serving steps."""
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    pre = f"MESHES = {[list(m) for m in WALK_MESHES]!r}\nSERVE_KINDS = {SERVE_KINDS!r}\n"
    codes = [f"ARCHS = {ARCHS!r}\n" + _PORT_WALK]
    for arch in ARCHS:
        for jobs in ([("train", 64)], SERVE_KINDS):
            codes.append(f"ARCHS = {[arch]!r}\nJOBS = {jobs!r}\n" + _REF_WALK)
    procs = [subprocess.Popen([sys.executable, "-c", pre + code], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for code in codes]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, out[-3000:] + err[-6000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    return outs[0], {k: v for o in outs[1:] for k, v in o.items()}


def _shards(mesh):
    """(expert shards, "mlp" shards) of the reduced archs' experts at
    ``mesh``: 8 experts over "data", ``moe_d_ff`` 64 over "model"."""
    return (mesh[0] if 8 % mesh[0] == 0 else 1), mesh[1]


def _expert_products(arch, kind, mesh) -> int:
    """The routed experts' products a rank: over the MoE layers and
    (micro)batches 2 * 3 * G * E * C * D * F, times 3 for the train step,
    over the expert and "mlp" shards; G the (micro)batch's routing groups
    (the batch shard count, one at decode) and C their capacity."""
    from repro_torch.configs.base import TRAIN_MICROBATCHES
    from repro_torch.models import moe as MOE
    from repro_torch.models.model import layer_plan
    from repro_torch.train.step import effective_microbatches

    cfg = reduced(get_config(arch))
    layers = sum(s.count for s in layer_plan(cfg) if s.kind.endswith("moe"))
    E, D, F = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    Pb = mesh[0] if 8 % mesh[0] == 0 else 1
    if kind == "train":
        mbs = effective_microbatches(8, TRAIN_MICROBATCHES[arch], mesh[0])
        T, passes = 8 // mbs * 64, 3 * mbs
    else:
        T, passes = 8 * (32 if kind == "prefill" else 1), 1
    G = MOE.groups(T, Pb) if kind != "decode" else 1
    C = MOE.capacity(T // G, cfg)
    pe, pm = _shards(mesh)
    return layers * passes * 2 * 3 * G * E * C * D * F // (pe * pm)


def _serving_account(arch, kind, mesh) -> int:
    """The FLOPs a rank that a serving step no longer computes at ``mesh``
    against the experts read whole and decode routed per rank: (P-1)/P of
    the routed experts' and the shared expert's products that split over
    "model" (P ranks; the expert split leaves a rank's products as they
    were, its E/P experts on every rank's groups); at decode also the
    change from a group of this rank's rows (router, capacity) to one group
    of all 8 rows."""
    from repro_torch.models import moe as MOE
    from repro_torch.models.model import layer_plan

    cfg = reduced(get_config(arch))
    layers = sum(s.count for s in layer_plan(cfg) if s.kind.endswith("moe"))
    E, D, F = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    Fs = F * cfg.num_shared_experts
    pe, pm = _shards(mesh)
    rows = 8 // (mesh[0] if 8 % mesh[0] == 0 else 1)
    if kind == "prefill":
        T = rows * 32
        C = MOE.capacity(T, cfg)              # one group a rank
        whole = 6 * E * C * D * F + 6 * T * D * Fs
        return layers * whole * (pm - 1) // pm
    whole = 2 * rows * D * E + 6 * E * MOE.capacity(rows, cfg) * D * F + 6 * rows * D * Fs
    blocks = 2 * 8 * D * E + 6 * (E // pe) * MOE.capacity(8, cfg) * D * (F // pm) \
        + 6 * rows * D * Fs // pm
    return layers * (whole - blocks)


@pytest.mark.parametrize("mesh", WALK_MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_flops_a_rank_against_the_references_compiled_step(walks, arch, mesh):
    """(c), the train step, and its experts' section."""
    port, ref = walks
    got = port[f"{arch}|train|{mesh}"]
    assert got["experts"] == _expert_products(arch, "train", mesh), (got["experts"], mesh)
    if mesh == (1, 1):
        assert got["flops"] == PARENT_AT_ONE[arch]["train"]
    else:
        want = ref[f"{arch}|train|{mesh}"]
        assert got["flops"] <= TRAIN_RATIO[arch][str(mesh)] * want, \
            (got["flops"], want, got["flops"] / want)


@pytest.mark.parametrize("mesh", WALK_MESHES, ids=str)
@pytest.mark.parametrize("kind", [k for k, _ in SERVE_KINDS])
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_flops_a_rank_fall_by_their_account(walks, arch, kind, mesh):
    """(c), the serving steps: the experts' section, the fall from the
    experts read whole, and at (1, 1) the parent's counts."""
    port, _ = walks
    got, whole = port[f"{arch}|{kind}|{mesh}|blocks"], port[f"{arch}|{kind}|{mesh}|whole"]
    assert got["experts"] == _expert_products(arch, kind, mesh), (got["experts"], mesh)
    if mesh == (1, 1):
        assert got["flops"] == whole["flops"] == PARENT_AT_ONE[arch][kind]
    else:
        assert got["flops"] == whole["flops"] - _serving_account(arch, kind, mesh), \
            (got["flops"], whole["flops"])


@pytest.mark.parametrize("mesh", WALK_MESHES[1:], ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_no_expert_gradient_is_summed_over_its_expert_axes(walks, arch, mesh):
    """(d): every batch axis of these meshes carries the experts where it
    splits them, so an expert leaf's gradient takes no collective; no whole
    gradient of a leaf split over "model" is all-reduced."""
    recs = walks[0][f"{arch}|train|{mesh}"]["leaves"]
    experts = [r for r in recs if r["expert"]]
    assert experts and len(experts) % 3 == 0       # wi_gate, wi_up, wo a microbatch
    for r in experts:
        assert r["all_reduces"] == [] and r["reduce_scatters"] == 0, (mesh, r)
    for r in recs:
        if r["model"]:
            size = int(np.prod(r["shape"]))
            assert all(int(np.prod(s)) * mesh[1] <= size for s in r["all_reduces"]), r


# ---------------------------------------------------------------------------
# (e): serving on expert blocks; decode routed as one group (fault 14)
# ---------------------------------------------------------------------------

SERVE_MESHES = ["(2, 1)", "(2, 2)"]
SB, PROMPT, MAX_SEQ, GEN = 8, 12, 32, 8
LOGIT_TOL = 1e-4          # of the largest |logit|
ROWS14 = 16               # fault 14's decode batch

_SERVE = """
from pathlib import Path
from repro_torch.configs.base import get_config, reduced
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.parallel import ep, tp
from repro_torch.parallel.context import use_mesh_context
from repro_torch.parallel.mesh_rules import Rules
from repro_torch.serve.engine import Engine
from repro_torch.utils.tree import flatten_with_names, unflatten_like

shape, work = eval(ARGS[0]), Path(ARGS[1])
B, PROMPT, MAX_SEQ, GEN, ROWS14 = json.loads(ARGS[2])
rules = Rules(make_mesh(shape))
report = {}
for arch in ("granite-moe-3b-a800m", "deepseek-v3-671b"):
    cfg = reduced(get_config(arch)).replace(capacity_factor=4.0)
    model = M.init_params(cfg, 1, "cpu")
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    prompts = {"tokens": torch.from_numpy(tokens)}
    ep.COUNTS["all_to_all"] = 0
    eng = Engine(cfg, model, batch=B, max_seq=MAX_SEQ, rules=rules)
    first = eng.whole_rows(eng.prefill(prompts))
    tokens = eng.generate(GEN)
    logits = eng.whole_rows(eng.last_logits)
    if RANK == 0:
        np.savez(work / f"serve-{arch}.npz", first=first.numpy(), tokens=tokens,
                 logits=logits.numpy())
    report[arch] = {"all_to_all": ep.COUNTS["all_to_all"]}

# fault 14: one decode step's MoE layer over ROWS14 rows, expert 0 over capacity
if shape == (2, 1):
    cfg = reduced(get_config("granite-moe-3b-a800m"))          # capacity factor 1.25
    specs = MOE.moe_spec(cfg)
    whole = L.materialize(specs, 5, torch.float32)
    whole["router"] = whole["router"] * 0.1
    whole["router"][0, 0] = 8.0                 # a positive first coordinate picks expert 0
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (ROWS14, 1, cfg.d_model)).astype(np.float32))
    x[..., 0] = x[..., 0].abs() + 1.0
    rows = rules.local_slices(("batch",), (ROWS14,))[0]
    own = {k: tuple(sl if a == ("data",) and n == "expert" else slice(None) for sl, a, n in
                    zip(rules.local_slices(s.axes, s.shape), rules.dim_axes(s.axes, s.shape),
                        s.axes))
           for k, s in flatten_with_names(specs)}
    blk = unflatten_like(whole, {k: t[own[k]] for k, t in flatten_with_names(whole)})
    ep.COUNTS["all_to_all"] = 0
    with torch.no_grad(), use_mesh_context(rules.mesh, rules), tp.computing_on_blocks():
        out, _ = MOE.moe_ffn(blk, cfg, x[rows], 1, row_axes=("data",))
    np.save(work / f"fault14-{RANK}.npy", out.numpy())
    report["fault14"] = {"split": sorted(k for k, t in flatten_with_names(blk)
                                         if t.shape != whole[k].shape),
                         "all_to_all": ep.COUNTS["all_to_all"]}
if RANK == 0:
    print(json.dumps(report))
"""


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    done = {}

    def run(mesh):
        if mesh not in done:
            work = tmp_path_factory.mktemp("ep-serve")
            outs = launch(_SERVE, int(np.prod(eval(mesh))), work, mesh, work,
                          json.dumps([SB, PROMPT, MAX_SEQ, GEN, ROWS14]), timeout=300)
            done[mesh] = (last_json(outs[0]), work)
        return done[mesh]

    return run


def _one_rank_serving(arch):
    """(first token, GEN decoded tokens, the last logits) of the port at one
    rank: prefill routed with 2 groups, as (2, ·)'s ranks route it, decode
    with the whole batch as one group."""
    from repro_torch.models import model as M

    cfg = reduced(get_config(arch)).replace(capacity_factor=4.0)
    model = M.init_params(cfg, 1, "cpu")
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (SB, PROMPT)).astype(np.int32))
    logits, cache = M.prefill(model, cfg, {"tokens": tokens}, MAX_SEQ, moe_groups=2)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    first, out = tok, []
    for _ in range(GEN):
        logits, cache = M.decode_step(model, cfg, tok, cache)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok.numpy())
    return first.numpy(), np.stack(out, axis=1), logits.numpy()


@pytest.mark.parametrize("mesh", SERVE_MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_on_expert_blocks_equals_one_rank(mesh, arch, served):
    """(e): the engine's tokens at (2, 1) and (2, 2) equal one rank's."""
    rep, work = served(mesh)
    assert rep[arch]["all_to_all"] > 0                 # prefill moved the slots
    got = np.load(work / f"serve-{arch}.npz")
    first, tokens, logits = _one_rank_serving(arch)
    assert np.array_equal(got["first"], first)
    assert np.array_equal(got["tokens"], tokens)
    assert np.abs(got["logits"] - logits).max() <= LOGIT_TOL * np.abs(logits).max()


def _capacity_oracle(p, cfg, x):
    """Each token's top-k experts in token-major routing order over all its
    rows as one group, an entry dropped once its expert holds ``capacity``
    entries (tests/test_torch_moe.py's fault 8 oracle); with the number of
    entries dropped."""
    from repro_torch.models import moe as MOE

    xt = x.reshape(-1, x.shape[-1])
    C = MOE.capacity(xt.shape[0], cfg)
    probs = torch.softmax(xt @ p["router"], dim=-1)
    top_p, top_e = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    used, dropped = [0] * cfg.num_experts, 0
    out = torch.zeros_like(xt)
    for t in range(xt.shape[0]):
        for k in range(cfg.num_experts_per_tok):
            e = int(top_e[t, k])
            if used[e] >= C:
                dropped += 1
                continue
            used[e] += 1
            h = torch.nn.functional.silu(xt[t] @ p["wi_gate"][e]) * (xt[t] @ p["wi_up"][e])
            out[t] += top_p[t, k] * (h @ p["wo"][e])
    return out.reshape(x.shape), dropped


def test_decode_routes_the_whole_batch_as_one_group(served):
    """(e), fault 14: the (2, 1) ranks' decode drops what one group of all
    16 rows drops (8 of expert 0's 16 entries, all in rank 1's rows), not
    what a group of each rank's 8 rows would (none), and equals the port's
    MoE layer at one rank."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE

    rep, work = served("(2, 1)")
    assert rep["fault14"]["split"] == ["wi_gate", "wi_up", "wo"]
    assert rep["fault14"]["all_to_all"] == 0           # decode gathers rows, no all-to-all
    got = np.concatenate([np.load(work / f"fault14-{r}.npy") for r in range(2)])
    cfg = reduced(get_config(GRANITE))
    p = L.materialize(MOE.moe_spec(cfg), 5, torch.float32)
    p["router"] = p["router"] * 0.1
    p["router"][0, 0] = 8.0
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (ROWS14, 1, cfg.d_model)).astype(np.float32))
    x[..., 0] = x[..., 0].abs() + 1.0
    with torch.no_grad():
        oracle, dropped = _capacity_oracle(p, cfg, x)
        per_rank = [_capacity_oracle(p, cfg, x[r * 8:(r + 1) * 8]) for r in range(2)]
        one_rank, _ = MOE.moe_ffn(p, cfg, x, 1)
    assert MOE.capacity(ROWS14, cfg) == 8 and dropped == 8
    assert sum(d for _, d in per_rank) == 0            # the fault: groups of 8 drop nothing
    np.testing.assert_allclose(got, oracle.numpy(), rtol=0, atol=OUT_TOL)
    np.testing.assert_allclose(got, one_rank.numpy(), rtol=0, atol=OUT_TOL)
    assert np.abs(got[8:] - torch.cat([o for o, _ in per_rank])[8:].numpy()).max() > 1e-2
