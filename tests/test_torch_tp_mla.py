"""MLA's tensor-parallel compute over "model" (``models/attention.py``'s
``mla_full`` / ``mla_decode`` on this rank's heads, ``models/model.py``'s
``tp_leaves`` with the MLA segments, ``mla_dense``'s SwiGLU and the MTP
block) on gloo CPU ranks (tests/torch_gloo.py), against the port at one
rank, the reference's loss and the reference's compiled per-device FLOPs.

Inputs: reduced deepseek-v3 (d_model 128, 4 heads, q_lora 64, kv_lora 32,
nope 32, rope 16, v 32, d_ff 256, 8 experts of 64, vocab 512, float32) cut
to one layer (``num_layers=1``: one ``mla_dense`` layer and the MTP block,
an empty ``mla_moe`` segment) or whole (4 layers: 1 ``mla_dense`` + 3
``mla_moe``); the train state of ``init_train_state(cfg, oc, 3)`` and
``SyntheticTokens(cfg, 8, 64, seed=5)`` (B8 S64), made alike in every
process.  MoE at capacity factor 4, where no expert overflows, so that the
routing groups of a mesh do not change which tokens an expert takes.

(a) ``mla_full`` and ``mla_decode`` under ``tp.computing_on_blocks`` on 2, 4
    and 8 ranks of a (1, n) mesh, on this rank's blocks of the rules, against
    the whole weights: outputs within 1e-5, ``mla_full``'s input and weight
    gradients within 1e-5 of each one's largest |gradient| (float32).  At 2 and 4 ranks the heads split (4
    products on blocks: ``wq_b``, ``wk_b``, ``wv_b``, ``wo``); at 8 the 4
    heads do not, every head is attended and only ``wo`` is a block.  Decode
    holds the cache as this rank's ``cache_seq`` block, at positions in the
    first, a middle and the last block.  At one rank (no rules) both are the
    plain path, bit for bit, and count no product on a block.
(b) Both cuts at (2, 4), (4, 2) and (1, 8) in float64 (the parameters the
    float32 draws, held in float64): step 0's gradients (gathered whole)
    within 1e-5 of each leaf's largest |gradient| of the port's at (1, 1),
    step 0's clip norm within rtol 1e-5, four steps' losses within 5e-4;
    the first loss at (2, 4) within 1e-5 of the reference's one-device
    ``loss_fn`` (``impl="xla"``, float32).  Float64, because this model's
    float32 gradients are not good to 1e-5 at one rank: they lie 2.8e-5 (one
    layer) and 5.2e-4 (four layers) of a leaf's largest |gradient| from the
    float64 ones, so a change of reduction order alone moves them past the
    limit.
(c) The dry run's FLOPs a rank (``launch/dryrun.walk_cell``, a fake group)
    of the one-layer cut's train step at B8 S64 against the reference's
    compiled per-device FLOPs (``build_step(impl="xla")``, in a JAX
    subprocess as tests/test_torch_tp.py (d) runs it): exactly 1,554,824,192
    at (1, 1), at most 1.10x at (2, 4) and (4, 2), at most 2.0x at (1, 8).
    The whole model's serving steps (prefill B8 S32, decode B8 at a cache
    of 64) at (1, 1) unchanged, decode equal to the reference's; elsewhere
    against their itemised account: the walk with the MLA and dense
    FFN leaves read whole (``tp_leaves`` less MLA's and the dense SwiGLU's
    leaves, as before MLA computed on blocks) less (P-1)/P of the products
    that now split, at each mesh: MLA's head products (every one where the
    heads split, ``wo``'s alone where they do not), ``flash``'s prefill
    attention where the heads split, and ``mla_dense``'s SwiGLU.  The MoE
    layers compute alike in both walks (on their experts' blocks since they
    split over the mesh, tests/test_torch_ep.py).
(d) In the train walks no all-reduce of the gradient reduction carries a
    whole gradient of an MLA or MTP leaf that the rules split over "model";
    where its other split lies along the batch ranks, it is reduce-scattered.
(e) The reference's fault (ROADMAP §3 fault 13): on the one-layer cut, whose
    ``mla_moe`` segment is empty, ``repro``'s ``prefill`` raises
    ``TypeError``; the port's engine serves the cut: its prefill's logits and
    its fourth decode step's are the forward's at the last position.
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
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.optim import adamw
from repro_torch.train import step as TS
from repro_torch.utils.tree import flatten_with_names
from torch_gloo import launch, last_json

SRC = str(Path(__file__).resolve().parents[1] / "src")
ARCH = "deepseek-v3-671b"
CUTS = [1, 4]                       # layers
MESHES = ["(2, 4)", "(4, 2)", "(1, 8)"]
B, S, STEPS = 8, 64, 4
OPT = dict(warmup_steps=1, decay_steps=10)
OUT_TOL = 1e-5
GRAD_TOL = 1e-5          # of a leaf's largest |gradient|
LOSS_TOL = 5e-4          # the reference's elastic limit
REF_LOSS_TOL = 1e-5
NORM_RTOL = 1e-5
FLOPS_AT_ONE = 1_554_824_192
FLOPS_RATIO = {"(2, 4)": 1.10, "(4, 2)": 1.10, "(1, 8)": 2.0}
SERVE_KINDS = [("prefill", 32), ("decode", 64)]        # (kind, seq), B8


def config_of(layers: int, dtype="float32"):
    return reduced(get_config(ARCH)).replace(num_layers=layers, capacity_factor=4.0,
                                             param_dtype=dtype, compute_dtype=dtype)


# ---------------------------------------------------------------------------
# (a): mla_full and mla_decode on blocks against whole weights
# ---------------------------------------------------------------------------

_OPS = """
from repro_torch.configs.base import get_config, reduced
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.parallel import tp
from repro_torch.parallel.context import use_mesh_context
from repro_torch.parallel.mesh_rules import Rules
from repro_torch.utils.tree import flatten_with_names, unflatten_like

n, r = WORLD, RANK
rules = Rules(make_mesh((1, n)))
rng = np.random.default_rng(7)        # the same draws on every rank


def T(*shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def leaf(x):
    return x.detach().clone().requires_grad_(True)


errs = {}


def err(name, got, want):
    errs[name] = max(errs.get(name, 0.0), float((got - want).abs().max()))


cfg = reduced(get_config("deepseek-v3-671b"))
specs = A.mla_spec(cfg)
whole = L.materialize(specs, 11, torch.float32)
for name in ("q_norm", "kv_norm"):
    whole[name]["scale"] = whole[name]["scale"] + 0.1 * T(*whole[name]["scale"].shape)
slices = {k: rules.local_slices(s.axes, s.shape) for k, s in flatten_with_names(specs)}
blk = unflatten_like(whole, {k: t[slices[k]] for k, t in flatten_with_names(whole)})
errs["split"] = sorted(k for k, t in flatten_with_names(blk)
                       if tuple(t.shape) != tuple(dict(flatten_with_names(whole))[k].shape))
x, g = T(2, 16, cfg.d_model), T(2, 16, cfg.d_model)
pos = torch.arange(16)[None].expand(2, 16)

with use_mesh_context(rules.mesh, rules), tp.computing_on_blocks():
    def run(tree):
        leaves = {k: leaf(t) for k, t in flatten_with_names(tree)}
        xr = leaf(x)
        out, ckv = A.mla_full(unflatten_like(tree, leaves), cfg, xr, pos)
        out.backward(g)
        return out, ckv, xr.grad, {k: t.grad for k, t in leaves.items()}

    out_w, ckv_w, gx_w, grads_w = run(whole)
    tp.COUNTS["block_products"] = 0
    out_b, ckv_b, gx_b, grads_b = run(blk)
    errs["full block products"] = tp.COUNTS["block_products"]
    err("full forward", out_b, out_w)
    err("full cache", ckv_b, ckv_w)
    err("full input backward", gx_b / gx_w.abs().max(), gx_w / gx_w.abs().max())
    for k, gb in grads_b.items():
        err("full weight backward", gb / grads_w[k].abs().max(),
            grads_w[k][slices[k]] / grads_w[k].abs().max())

    S_cache = 32
    cache = T(2, S_cache, cfg.mla_cache_dim)
    start, size = tp.seq_block(S_cache)
    tp.COUNTS["block_products"] = 0
    with torch.no_grad():
        for t_pos in (3, 17, S_cache - 1):
            t = torch.tensor(t_pos, dtype=torch.int32)
            x1 = T(2, 1, cfg.d_model)
            cw = cache.clone()
            out_w, _ = A.mla_decode(whole, cfg, x1, cw, t)
            cb = cache[:, start:start + size].clone()
            out_b, _ = A.mla_decode(blk, cfg, x1, cb, t, seq_len=S_cache)
            err("decode forward", out_b, out_w)
            err("decode cache", cb, cw[:, start:start + size])
    errs["decode block products"] = tp.COUNTS["block_products"]
if RANK == 0:
    print(json.dumps(errs))
"""


@pytest.mark.parametrize("world", [2, 4, 8])
def test_mla_on_blocks_matches_whole_weights(world, tmp_path):
    """(a) on ranks."""
    errs = last_json(launch(_OPS, world, tmp_path)[0])
    heads_split = world in (2, 4)
    split = errs.pop("split")
    assert split == (["wk_b", "wo/w", "wq_b", "wv_b"] if heads_split else ["wo/w"]), split
    per_call = 4 if heads_split else 1
    assert errs.pop("full block products") == per_call
    assert errs.pop("decode block products") == 3 * per_call
    assert errs.pop("full cache") == 0.0
    assert errs.pop("decode cache") == 0.0
    for name, e in errs.items():          # sums in another order
        assert e <= OUT_TOL, (name, e)
    assert set(errs) == {"full forward", "full input backward", "full weight backward",
                         "decode forward"}


def test_mla_at_one_rank_is_the_plain_path():
    """(a) at one rank: no rules, every leaf whole."""
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.parallel import tp

    cfg = reduced(get_config(ARCH))
    p = L.materialize(A.mla_spec(cfg), 11, torch.float32)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32))
    pos = torch.arange(8)[None].expand(2, 8)
    cache = torch.from_numpy(rng.standard_normal((2, 16, cfg.mla_cache_dim)).astype(np.float32))
    t = torch.tensor(5, dtype=torch.int32)
    want = A.mla_full(p, cfg, x, pos)
    want_dec = A.mla_decode(p, cfg, x[:, :1], cache.clone(), t)
    tp.COUNTS["block_products"] = 0
    with tp.computing_on_blocks():
        assert A._mla_heads(p, cfg) == (False, (False, A.mla_spec(cfg)["wo"]))
        got = A.mla_full(p, cfg, x, pos)
        got_dec = A.mla_decode(p, cfg, x[:, :1], cache.clone(), t)
    assert tp.COUNTS["block_products"] == 0
    for w, g in zip(want + want_dec, got + got_dec):
        assert torch.equal(w, g)


# ---------------------------------------------------------------------------
# (b): training on gloo ranks against the port at one rank and the reference
# ---------------------------------------------------------------------------

_RANK = """
from torch.distributed.tensor import DTensor
from repro_torch.configs.base import get_config, reduced
from repro_torch.core.virtualization import fetch_tree, place_tree
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim import adamw
from repro_torch.parallel import tp
from repro_torch.parallel.mesh_rules import Rules
from repro_torch.train import step as TS
from repro_torch.utils.tree import flatten_with_names

shape, work = eval(ARGS[0]), ARGS[1]
cuts, steps = json.loads(ARGS[2])
oc = adamw.OptConfig(**json.loads(ARGS[3]))
rules = Rules(make_mesh(shape))
captured = []
apply_updates = adamw.apply_updates


def capture(params, grads, *a, **kw):
    if not captured:
        captured.append(grads)
    return apply_updates(params, grads, *a, **kw)


adamw.apply_updates = capture
report = {}
for layers in cuts:
    cfg = reduced(get_config("deepseek-v3-671b")).replace(
        num_layers=layers, capacity_factor=4.0, param_dtype="float64", compute_dtype="float64")
    pipe = SyntheticTokens(cfg, 8, 64, seed=5)
    host = fetch_tree(TS.init_train_state(cfg, oc, 3, "cpu"))
    state = place_tree(host, TS.state_logical_axes(cfg), rules, "cpu")
    step = TS.make_train_step(cfg, oc, rules=rules)
    captured.clear()
    tp.COUNTS["block_products"] = 0
    losses, norms = [], []
    for i in range(steps):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in pipe.batch_at(i).items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    whole = {}
    for n, p in flatten_with_names(state["params"]):
        g = dict(flatten_with_names(captured[0]))[n]
        if isinstance(p, DTensor):
            g = DTensor.from_local(g, p.device_mesh, p.placements, run_check=False).full_tensor()
        whole[n] = g.numpy()
    if RANK == 0:
        np.savez(f"{work}/layers{layers}.npz", **whole)
    report[layers] = {"losses": losses, "grad_norm": norms[0],
                      "block_products": tp.COUNTS["block_products"]}
if RANK == 0:
    print(json.dumps(report))
"""


def _one_rank(layers):
    """(losses, step 0's gradients, step 0's clip norm) of the port at (1, 1)."""
    cfg = config_of(layers, "float64")
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
    return {layers: _one_rank(layers) for layers in CUTS}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{mesh: (the rank-0 report, the folder of its gradients)}, each mesh's
    eight ranks started when first asked for."""
    done = {}

    def run(mesh):
        if mesh not in done:
            work = tmp_path_factory.mktemp("mla-ranks")
            outs = launch(_RANK, 8, work, mesh, work,
                          json.dumps([CUTS, STEPS]), json.dumps(OPT),
                          timeout=300)
            done[mesh] = (last_json(outs[0]), work)
        return done[mesh]

    return run


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("layers", CUTS)
def test_training_on_model_blocks_matches_one_rank(mesh, layers, ranks, one_rank):
    """(b)."""
    rep, work = ranks(mesh)
    got = rep[str(layers)]
    want_losses, want_grads, want_norm = one_rank[layers]
    assert got["block_products"] > 0
    assert abs(got["grad_norm"] - want_norm) <= NORM_RTOL * want_norm, \
        (got["grad_norm"], want_norm)
    have = np.load(work / f"layers{layers}.npz")
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


@pytest.mark.parametrize("layers", CUTS)
def test_first_loss_at_2x4_matches_the_reference_loss_fn(layers, ranks):
    """(b), the reference."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs.base import get_config as ref_get_config
    from repro.configs.base import reduced as ref_reduced
    from repro.models import model as RM

    rep, _ = ranks("(2, 4)")
    cfg = config_of(layers)
    rcfg = ref_reduced(ref_get_config(ARCH)).replace(num_layers=layers, capacity_factor=4.0)
    params = TS.init_train_state(cfg, adamw.OptConfig(**OPT), 3, "cpu")["params"]
    tree = _nest({n: jnp.asarray(x.numpy()) for n, x in flatten_with_names(params)})
    assert all(x.dtype == jnp.float32 for x in jax.tree_util.tree_leaves(tree))
    batch = {k: jnp.asarray(v) for k, v in SyntheticTokens(cfg, B, S, seed=5).batch_at(0).items()}
    want, _ = jax.jit(lambda p, b: RM.loss_fn(p, rcfg, b, moe_groups=1, z_loss=1e-4,
                                              impl="xla"))(tree, batch)
    got = rep[str(layers)]["losses"][0]
    assert abs(got - float(want)) <= REF_LOSS_TOL, (got, float(want))


def _nest(named: dict) -> dict:
    out: dict = {}
    for n, x in named.items():
        *path, leaf = n.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = x
    return out


@pytest.mark.parametrize("layers", CUTS)
def test_float32_gradients_at_one_rank_are_not_good_to_the_limit(layers):
    """(b)'s float64: at one rank, the float32 gradients of step 0 stand
    further from the float64 ones than GRAD_TOL of a leaf's largest
    |gradient| (2.8e-5 at one layer, 5.2e-4 at four), so two float32
    evaluations in different orders cannot be held to it."""
    def grads(dtype):
        cfg = config_of(layers, dtype)
        params = TS.init_train_state(cfg, adamw.OptConfig(**OPT), 3, "cpu")["params"]
        batch = SyntheticTokens(cfg, B, S, seed=5).batch_at(0)
        _, _, g = TS.loss_and_grads(params, cfg, {k: torch.from_numpy(v) for k, v in
                                                  batch.items()}, z_loss=1e-4, moe_groups=1)
        return {n: x.double().numpy() for n, x in flatten_with_names(g)}

    g32, g64 = grads("float32"), grads("float64")
    worst = max(float(np.abs(g32[n] - w).max(initial=0.0)) / max(float(np.abs(w).max(
        initial=0.0)), 1e-30) for n, w in g64.items())
    assert worst > GRAD_TOL, worst


# ---------------------------------------------------------------------------
# (c), (d): the dry run's FLOPs a rank and its gradient collectives
# ---------------------------------------------------------------------------

_WALK_MESHES = [(1, 1), (2, 4), (4, 2), (1, 8)]

_PORT_WALK = """
import json
import torch.distributed as dist
from repro_torch.configs.base import ShapeConfig, get_config, reduced
from repro_torch.launch import dryrun as D
from repro_torch.models import model as M
from repro_torch.train import step as TS

whole = reduced(get_config("deepseek-v3-671b"))
cut = whole.replace(num_layers=1)
leaf, seen = [], []
own_block, all_reduce, reduce_scatter = TS.own_block, dist.all_reduce, TS._reduce_scatter
tp_leaves = M.tp_leaves


def spy_own_block(rules, g, shape, axes, batch_axes):
    dims = rules.dim_axes(axes, shape)
    leaf.append({"shape": list(shape), "axes": list(axes), "all_reduces": [],
                 "model": rules.axis_sizes["model"] > 1 and ("model",) in dims,
                 "batch_split": any(a and a != ("model",) and set(a) <= set(batch_axes)
                                    for a in dims),
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


def parent_leaves(cfg):
    # MLA and its dense FFNs read whole: the leaves of the embedding, the head
    # and the MoE layers only
    moe = tuple(f"seg{i}/ffn/" for i, s in enumerate(M.layer_plan(cfg)) if s.kind.endswith("moe"))
    return {n for n in tp_leaves(cfg) if n.startswith(("embed/", "head") + moe)}


TS.own_block, dist.all_reduce, TS._reduce_scatter = (spy_own_block, spy_all_reduce,
                                                     spy_reduce_scatter)
out = {}
for mesh in MESHES:
    seen.clear()
    walk, _ = D.walk_cell(cut, ShapeConfig("train", "train", 64, 8), tuple(mesh))
    out[str(tuple(mesh))] = {"flops": walk.costs()["flops"], "leaves": seen[:]}
    for kind, seq in SERVE_KINDS:
        for name, leaves in (("blocks", tp_leaves), ("whole", parent_leaves)):
            M.tp_leaves = leaves
            walk, _ = D.walk_cell(whole, ShapeConfig(kind, kind, seq, 8), tuple(mesh))
            out[f"{kind}|{tuple(mesh)}|{name}"] = walk.costs()["flops"]
        M.tp_leaves = tp_leaves
print(json.dumps(out))
"""

_REF_WALK = """
import json
from repro.launch import dryrun as D      # forces 512 host devices: this process only
import jax
from jax.sharding import AxisType
from repro.configs.base import ShapeConfig, get_config, reduced
from repro.launch.hlo_costs import analyze_hlo_text

whole = reduced(get_config("deepseek-v3-671b"))
out = {}
for shape in MESHES:
    mesh = jax.make_mesh(tuple(shape), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    for kind, seq in JOBS:
        cfg = whole.replace(num_layers=1) if kind == "train" else whole
        step, args, in_sh = D.build_step(cfg, ShapeConfig(kind, kind, seq, 8), mesh, impl="xla")
        args = jax.tree_util.tree_map(
            lambda s, sh: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=sh), args, in_sh)
        with mesh:
            out[f"{kind}|{tuple(shape)}"] = analyze_hlo_text(
                step.lower(*args).compile().as_text())["flops"]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def walks():
    """(the port's walks, the reference's compiled FLOPs), from three
    subprocesses run side by side: the port's walks, the reference's train
    step, the reference's serving steps."""
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    pre = (f"MESHES = {[list(m) for m in _WALK_MESHES]!r}\n"
           f"SERVE_KINDS = {SERVE_KINDS!r}\n")
    codes = [_PORT_WALK, f"JOBS = {[('train', S)]!r}\n" + _REF_WALK,
             f"JOBS = {SERVE_KINDS!r}\n" + _REF_WALK]
    procs = [subprocess.Popen([sys.executable, "-c", pre + code], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for code in codes]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, out[-3000:] + err[-6000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    return outs[0], {**outs[1], **outs[2]}


@pytest.mark.parametrize("mesh", _WALK_MESHES, ids=str)
def test_train_flops_a_rank_against_the_references_compiled_step(walks, mesh):
    """(c), the train step."""
    port, ref = walks
    got, want = port[str(mesh)]["flops"], ref[f"train|{mesh}"]
    if mesh == (1, 1):
        assert got == FLOPS_AT_ONE
    else:
        assert got <= FLOPS_RATIO[str(mesh)] * want, (mesh, got, want, got / want)


def _split_products(kind: str, mesh) -> int:
    """The FLOPs a rank of the whole reduced model's serving step that MLA
    and ``mla_dense``'s SwiGLU no longer compute whole at ``mesh``: (P-1)/P
    of each product that splits over its "model" axis of P ranks."""
    from repro_torch.kernels import costs
    from repro_torch.models.model import layer_plan

    cfg = reduced(get_config(ARCH))
    P, rows = mesh[1], B // mesh[0]
    seq = dict(SERVE_KINDS)["prefill"]
    T = rows * (seq if kind == "prefill" else 1)
    D, H, R = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank
    nope, rope, v = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    per_layer = 2 * T * H * v * D                                   # wo
    if H % P == 0:                       # the heads split: their products, prefill's flash
        per_layer += 2 * T * H * (cfg.q_lora_rank * (nope + rope) + R * nope + R * v)
        if kind == "prefill":
            per_layer += costs.flash(rows, seq, seq, H, H, nope + rope, v, 4)[0]
    dense = sum(s.count for s in layer_plan(cfg) if s.kind == "mla_dense")
    ffn = dense * 2 * T * 3 * D * cfg.d_ff
    return (cfg.num_layers * per_layer + ffn) * (P - 1) // P


@pytest.mark.parametrize("mesh", _WALK_MESHES[1:], ids=str)
@pytest.mark.parametrize("kind", [k for k, _ in SERVE_KINDS])
def test_serving_flops_a_rank_fall_by_the_split_products(walks, mesh, kind):
    """(c), the serving steps."""
    port, _ = walks
    got, whole = port[f"{kind}|{mesh}|blocks"], port[f"{kind}|{mesh}|whole"]
    assert got == whole - _split_products(kind, mesh), (kind, mesh, got, whole)


def test_serving_flops_at_one_rank_are_unchanged(walks):
    """(c) at (1, 1): no leaf is a block, the walks with and without MLA's
    leaves in ``tp_leaves`` agree, and decode equals the reference's."""
    port, ref = walks
    for kind, _ in SERVE_KINDS:
        assert port[f"{kind}|(1, 1)|blocks"] == port[f"{kind}|(1, 1)|whole"], kind
    assert port["decode|(1, 1)|blocks"] == ref["decode|(1, 1)"]


@pytest.mark.parametrize("mesh", _WALK_MESHES[1:], ids=str)
def test_no_whole_gradient_of_a_split_mla_leaf_is_all_reduced(walks, mesh):
    """(d)."""
    from repro_torch.models import model as M

    cfg = reduced(get_config(ARCH)).replace(num_layers=1)
    specs = dict(flatten_with_names(M.param_specs(cfg)))
    keys = {n: (list(specs[n].shape), list(specs[n].axes)) for n in M.tp_leaves(cfg)
            if not n.startswith(("embed/", "head")) and np.prod(specs[n].shape)}
    recs = [r for r in walks[0][str(mesh)]["leaves"]
            if r["model"] and (r["shape"], r["axes"]) in keys.values()]
    # wq_b, wk_b, wv_b (where the 4 heads split), wo, gate, up, down: the layer's and MTP's
    reduced_here = {n for n, k in keys.items() if any((r["shape"], r["axes"]) == k for r in recs)}
    assert len(reduced_here) == (14 if mesh[1] in (2, 4) else 8), sorted(reduced_here)
    for r in recs:
        size = int(np.prod(r["shape"]))
        assert all(int(np.prod(s)) * mesh[1] <= size for s in r["all_reduces"]), r
        if mesh[0] > 1 and r["batch_split"]:
            assert r["reduce_scatters"] == 1, r


# ---------------------------------------------------------------------------
# (e): the reference's all-dense cut does not serve; the port's does
# ---------------------------------------------------------------------------


def test_references_prefill_fails_on_the_all_dense_cut_and_the_ports_serves():
    """(e)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs.base import get_config as ref_get_config
    from repro.configs.base import reduced as ref_reduced
    from repro.models import model as RM
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Engine

    rcfg = ref_reduced(ref_get_config(ARCH)).replace(num_layers=1)
    assert [s.count for s in RM.layer_plan(rcfg)] == [1, 0]
    prompts = np.random.default_rng(3).integers(0, rcfg.vocab_size, (2, 8)).astype(np.int32)
    params = RM.init_params(rcfg, jax.random.PRNGKey(0))
    with pytest.raises(TypeError):
        RM.prefill(params, rcfg, {"tokens": jnp.asarray(prompts)}, 16, impl="xla")

    cfg = config_of(1)
    model = M.init_params(cfg, 1, "cpu")
    eng = Engine(cfg, model, batch=2, max_seq=16)
    first = eng.prefill({"tokens": torch.from_numpy(prompts)}).numpy()[:, None]
    want = model(torch.from_numpy(prompts).long())[:, -1]
    assert float((eng.last_logits - want).abs().max()) <= 1e-5 * float(want.abs().max())
    tokens = eng.generate(4)
    assert tokens.shape == (2, 4)
    # the last decode step's logits: the forward's over prompt and tokens
    seq = torch.from_numpy(np.concatenate([prompts, first, tokens[:, :-1]], axis=1)).long()
    want = model(seq)[:, -1]
    assert float((eng.last_logits - want).abs().max()) <= 1e-4 * float(want.abs().max())
