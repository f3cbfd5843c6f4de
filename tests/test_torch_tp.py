"""Tensor-parallel compute over "model" (``parallel/tp.py`` and the modules
that use it) on gloo CPU ranks (tests/torch_gloo.py), against the port at
one rank, the reference's loss and the reference's compiled per-device
FLOPs.

Inputs: each arch's reduced config (4 layers, d_model 128, 4 / 2 heads of
32, d_ff 256, vocab 512, float32), the train state of
``init_train_state(cfg, oc, 3)`` and ``SyntheticTokens(cfg, 8, 64, seed=5)``
(B8 S64), made alike in every process.

(a) At (2, 4), (4, 2) and (1, 8), reduced qwen2-0.5b (qkv bias, tied
    embedding), qwen3-4b (qk_norm), llama3.2-1b and granite-8b (untied head),
    two microbatches: step 0's gradients (the blocks AdamW is given,
    gathered whole) within 1e-5 of each leaf's largest |gradient| of the
    port's at (1, 1), step 0's clip norm within rtol 1e-5, and four steps'
    losses within 5e-4, the reference's limit for a step under another
    reduction order (tests/test_elastic.py).
(b) At (2, 4), one step of each of the other six archs (their codebook
    and image-token modules gathered whole beside the tensor-parallel ones;
    the SSM mixers and zamba2's shared block on "model" blocks,
    tests/test_torch_tp_ssm.py; deepseek-v3's MLA, its dense SwiGLU and its MTP
    block on "model" blocks, tests/test_torch_tp_mla.py; the MoE experts on
    their blocks over "data" and "model", moved by all-to-alls,
    tests/test_torch_ep.py), one microbatch,
    held to ``loss_and_grads`` at one rank with the routing groups of
    (2, 4) (two): the same limits.  deepseek-v3 and rwkv6 run in float64
    (the parameters the float32 draws, held in float64): their float32
    gradients lie up to 5.2e-4 (deepseek-v3) and past 1e-5 (rwkv6) of a
    leaf's largest |gradient| from float64's at one rank
    (tests/test_torch_tp_mla.py, tests/test_torch_tp_ssm.py), so the order
    of the sums over the heads' blocks alone moves them past the limit.
(c) The first loss at (2, 4) of each arch of (a) within 1e-5 of the
    reference's one-device ``loss_fn`` (``impl="xla"``) on the same params.
(d) The dry run's FLOPs a rank (``launch/dryrun.walk_cell``, a fake group)
    of reduced qwen2-0.5b's train step at S64 B8 against the reference's
    compiled per-device FLOPs (``build_step(impl="xla")``, ``AxisType.Auto``
    meshes of 512 host devices, ``analyze_hlo_text``, in a JAX subprocess as
    tests/test_torch_dryrun.py runs it): exactly 2,248,671,232 at (1, 1)
    (tests/test_torch_dryrun.py accounts for the kernel's forward), at most
    1.10x at (2, 4) and (4, 2), at most 2.0x at (1, 8), where 4 heads do not
    split 8 ways and attention runs whole on every rank.
    The serving steps likewise (``serve/engine.py``'s, on "model" blocks):
    prefill B8 S32 and decode B8 at a cache of 64, at most 1.10x the
    reference's at (2, 4) and (4, 2); at (1, 8) the FLOPs a rank are held
    to their itemised account: the products and the last position's logits
    split 8 ways, and ``flash``'s causal attention over every head and row
    whole on every rank in prefill (4 heads do not split 8 ways); decode
    equal to the reference's at every mesh.
(e) In those walks no all-reduce of the gradient reduction carries a whole
    gradient of a leaf the rules split over "model"; such leaves are
    reduce-scattered.
(f) Each operation of ``parallel/tp.py`` on 2 and 4 ranks of a (1, n)
    mesh against its plain form, forward and backward (the vocab-parallel
    cross entropy with its z term), ``gqa_full`` on blocks under
    ``tp.computing_on_blocks`` against it on whole weights (8 / 2 heads:
    local kv heads at 2 ranks; at 4, kv blocks of half a head, gathered,
    and the kv head of this rank's q heads sliced out; 12 / 6 heads at 4,
    whose q heads read kv heads unevenly, refused), and at one rank (no
    rules), where each is the identity or the plain form.
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
DENSE = ["qwen2-0.5b", "qwen3-4b", "llama3.2-1b", "granite-8b"]
OTHERS = ["zamba2-1.2b", "rwkv6-1.6b", "granite-moe-3b-a800m", "deepseek-v3-671b",
          "musicgen-large", "llava-next-mistral-7b"]
MESHES = ["(2, 4)", "(4, 2)", "(1, 8)"]
B, S, STEPS = 8, 64, 4
OPT = dict(warmup_steps=1, decay_steps=10)
GRAD_TOL = 1e-5          # of a leaf's largest |gradient|
LOSS_TOL = 5e-4          # the reference's elastic limit
REF_LOSS_TOL = 1e-5
NORM_RTOL = 1e-5
# (d): per-device FLOPs of the walk over the reference's compiled step
FLOPS_AT_ONE = 2_248_671_232
FLOPS_RATIO = {"(2, 4)": 1.10, "(4, 2)": 1.10, "(1, 8)": 2.0}
SERVE_KINDS = [("prefill", 32), ("decode", 64)]        # (kind, seq), B8
SERVE_RATIO = 1.10
# held in float64 in (b): float32 is not good to GRAD_TOL for them at one rank
FLOAT64 = ["deepseek-v3-671b", "rwkv6-1.6b"]


def config_of(arch):
    cfg = reduced(get_config(arch))
    return cfg.replace(param_dtype="float64", compute_dtype="float64") \
        if arch in FLOAT64 else cfg

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
runs = json.loads(ARGS[2])              # [arch, steps, microbatches]
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
for arch, steps, mbs in runs:
    cfg = reduced(get_config(arch))
    if arch in FLOAT64:
        cfg = cfg.replace(param_dtype="float64", compute_dtype="float64")
    pipe = SyntheticTokens(cfg, 8, 64, seed=5)
    host = fetch_tree(TS.init_train_state(cfg, oc, 3, "cpu"))
    state = place_tree(host, TS.state_logical_axes(cfg), rules, "cpu")
    step = TS.make_train_step(cfg, oc, rules=rules, microbatches=mbs)
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
        np.savez(f"{work}/{arch}.npz", **whole)
    report[arch] = {"losses": losses, "grad_norm": norms[0],
                    "block_products": tp.COUNTS["block_products"]}
if RANK == 0:
    print(json.dumps(report))
"""


def _one_rank(arch, steps, microbatches):
    """(losses, step 0's gradients) of the port at (1, 1)."""
    cfg = reduced(get_config(arch))
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
        step = TS.make_train_step(cfg, oc, microbatches=microbatches)
        for i in range(steps):
            state, m = step(state, {k: torch.from_numpy(v) for k, v in pipe.batch_at(i).items()})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    finally:
        adamw.apply_updates = apply_updates
    return losses, {n: g.numpy() for n, g in flatten_with_names(captured[0])}, norms[0]


def _grad_errors(got_npz, want: dict) -> dict:
    """{leaf: (max |difference|, largest |gradient|)} for each leaf over its limit."""
    got = np.load(got_npz)
    assert sorted(got.files) == sorted(want)
    out = {}
    for n, w in want.items():
        err, scale = float(np.abs(got[n] - w).max()), float(np.abs(w).max())
        if err > GRAD_TOL * max(scale, 1e-30):
            out[n] = (err, scale)
    return out


@pytest.fixture(scope="module")
def one_rank():
    """The port at (1, 1): four steps of each arch of (a), with two
    microbatches, and (b)'s archs' step-0 losses and gradients at two
    routing groups, one microbatch."""
    out = {a: _one_rank(a, STEPS, 2) for a in DENSE}
    for a in OTHERS:
        cfg = config_of(a)
        batch = SyntheticTokens(cfg, B, S, seed=5).batch_at(0)
        loss, _, grads = TS.loss_and_grads(
            TS.init_train_state(cfg, adamw.OptConfig(**OPT), 3, "cpu")["params"], cfg,
            {k: torch.from_numpy(v) for k, v in batch.items()}, z_loss=1e-4,
            moe_groups=2 if cfg.num_experts else 1)
        out[a] = ([float(loss)], {n: g.numpy() for n, g in flatten_with_names(grads)},
                  float(adamw.global_norm(grads)))
    return out


def _run_mesh(mesh, tmp_path, runs):
    outs = launch(f"FLOAT64 = {FLOAT64!r}\n" + _RANK, 8, tmp_path, mesh, tmp_path,
                  json.dumps(runs), json.dumps(OPT),
                  timeout=400)
    return last_json(outs[0])


@pytest.mark.parametrize("mesh", MESHES)
def test_dense_archs_on_model_blocks_match_one_rank(mesh, one_rank, tmp_path):
    """(a), and at (2, 4) (b)."""
    runs = [[a, STEPS, 2] for a in DENSE]
    if mesh == "(2, 4)":
        runs += [[a, 1, 1] for a in OTHERS]
    rep = _run_mesh(mesh, tmp_path, runs)
    for arch, steps, _ in runs:
        want_losses, want_grads, want_norm = one_rank[arch]
        got = rep[arch]
        assert got["block_products"] > 0, arch
        # the clip norm sums each block once over the mesh
        assert abs(got["grad_norm"] - want_norm) <= NORM_RTOL * want_norm, \
            (arch, got["grad_norm"], want_norm)
        bad = _grad_errors(tmp_path / f"{arch}.npz", want_grads)
        assert not bad, (arch, bad)
        assert np.abs(np.array(got["losses"]) - np.array(want_losses[:steps])).max() \
            <= LOSS_TOL, (arch, got["losses"], want_losses)


def test_first_loss_at_2x4_matches_the_reference_loss_fn(tmp_path):
    """(c)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs.base import get_config as ref_get_config
    from repro.configs.base import reduced as ref_reduced
    from repro.models import model as RM

    rep = _run_mesh("(2, 4)", tmp_path, [[a, 1, 1] for a in DENSE])
    for arch in DENSE:
        cfg, rcfg = reduced(get_config(arch)), ref_reduced(ref_get_config(arch))
        params = TS.init_train_state(cfg, adamw.OptConfig(**OPT), 3, "cpu")["params"]
        named = {n: jnp.asarray(x.numpy()) for n, x in flatten_with_names(params)}
        tree = _nest(named)
        batch = {k: jnp.asarray(v) for k, v in
                 SyntheticTokens(cfg, B, S, seed=5).batch_at(0).items()}
        want, _ = jax.jit(lambda p, b, rcfg=rcfg: RM.loss_fn(p, rcfg, b, moe_groups=1,
                                                             z_loss=1e-4, impl="xla"))(tree, batch)
        assert abs(rep[arch]["losses"][0] - float(want)) <= REF_LOSS_TOL, \
            (arch, rep[arch]["losses"][0], float(want))


def _nest(named: dict) -> dict:
    out: dict = {}
    for n, x in named.items():
        *path, leaf = n.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = x
    return out


# ---------------------------------------------------------------------------
# (d), (e): the dry run's FLOPs a rank and its gradient collectives
# ---------------------------------------------------------------------------

_WALK_MESHES = [(1, 1), (2, 4), (4, 2), (1, 8)]

_PORT_WALK = """
import json
import torch.distributed as dist
from repro_torch.configs.base import ShapeConfig, get_config, reduced
from repro_torch.launch import dryrun as D
from repro_torch.parallel.mesh_rules import Rules
from repro_torch.train import step as TS

cfg = reduced(get_config("qwen2-0.5b"))
leaf, reduced_here = [], []
own_block, all_reduce = TS.own_block, dist.all_reduce


def spy_own_block(rules, g, shape, axes, batch_axes):
    split = rules.axis_sizes["model"] > 1 and ("model",) in rules.dim_axes(axes, shape)
    leaf.append((tuple(shape), split))
    try:
        return own_block(rules, g, shape, axes, batch_axes)
    finally:
        leaf.pop()


def spy_all_reduce(t, *a, **kw):
    if leaf:
        reduced_here.append({"shape": list(t.shape), "leaf": list(leaf[-1][0]),
                       "split": leaf[-1][1]})
    return all_reduce(t, *a, **kw)


TS.own_block, dist.all_reduce = spy_own_block, spy_all_reduce
out = {}
for mesh in MESHES:
    reduced_here.clear()
    walk, _ = D.walk_cell(cfg, ShapeConfig("train", "train", 64, 8), tuple(mesh))
    grads = [r for r in walk.table if r["section"] == "grads" and r["collective"]]
    out[str(tuple(mesh))] = {
        "flops": walk.costs()["flops"], "all_reduces": reduced_here[:],
        "reduce_scatters": sum(r["n"] for r in grads if r["collective"][0] == "reduce-scatter")}
    for kind, seq in SERVE_KINDS:
        walk, _ = D.walk_cell(cfg, ShapeConfig(kind, kind, seq, 8), tuple(mesh))
        out[f"{kind}|{tuple(mesh)}"] = walk.costs()["flops"]
print(json.dumps(out))
"""

_REF_WALK = """
import json
from repro.launch import dryrun as D      # forces 512 host devices: this process only
import jax
from jax.sharding import AxisType
from repro.configs.base import ShapeConfig, get_config, reduced
from repro.launch.hlo_costs import analyze_hlo_text

cfg = reduced(get_config("qwen2-0.5b"))
out = {}
for shape in MESHES:
    mesh = jax.make_mesh(tuple(shape), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    step, args, in_sh = D.build_step(cfg, ShapeConfig("train", "train", 64, 8), mesh,
                                     impl="xla")
    args = jax.tree_util.tree_map(
        lambda s, sh: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=sh), args, in_sh)
    with mesh:
        out[str(tuple(shape))] = analyze_hlo_text(step.lower(*args).compile().as_text())["flops"]
    for kind, seq in SERVE_KINDS:
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
    """(the port's walks, the reference's compiled FLOPs), each from a
    subprocess of its own, the two run side by side."""
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    pre = (f"MESHES = {[list(m) for m in _WALK_MESHES]!r}\n"
           f"SERVE_KINDS = {SERVE_KINDS!r}\n")
    procs = [subprocess.Popen([sys.executable, "-c", pre + code], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for code in (_PORT_WALK, _REF_WALK)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, out[-3000:] + err[-6000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    return outs


@pytest.mark.parametrize("mesh", _WALK_MESHES, ids=str)
def test_flops_a_rank_against_the_references_compiled_step(walks, mesh):
    """(d)."""
    port, ref = walks
    got, want = port[str(mesh)]["flops"], ref[str(mesh)]
    if mesh == (1, 1):
        assert got == FLOPS_AT_ONE
    else:
        assert got <= FLOPS_RATIO[str(mesh)] * want, (mesh, got, want, got / want)


@pytest.mark.parametrize("mesh", _WALK_MESHES[1:], ids=str)
@pytest.mark.parametrize("kind", [k for k, _ in SERVE_KINDS])
def test_serving_flops_a_rank_against_the_references_compiled_step(walks, mesh, kind):
    """(d), the serving steps."""
    from repro_torch.kernels import costs

    port, ref = walks
    got, want = port[f"{kind}|{mesh}"], ref[f"{kind}|{mesh}"]
    assert got <= SERVE_RATIO * want, (kind, mesh, got, want, got / want)
    if kind == "decode":
        assert got == want, (mesh, got, want)
    elif mesh == (1, 8):
        cfg = reduced(get_config("qwen2-0.5b"))
        D, F, V, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.num_layers
        H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        S = dict(SERVE_KINDS)["prefill"]
        per_token = 2 * L * (D * (2 * H + 2 * Hkv) * Dh + 3 * D * F)
        products = (B * S * per_token + 2 * B * D * V) // 8
        attention = L * costs.flash(B, S, S, H, Hkv, Dh, Dh, 4)[0]
        assert got == products + attention, (got, products, attention)


@pytest.mark.parametrize("mesh", _WALK_MESHES[1:], ids=str)
def test_no_whole_gradient_of_a_model_split_leaf_is_all_reduced(walks, mesh):
    """(e)."""
    rec = walks[0][str(mesh)]
    whole = [a for a in rec["all_reduces"] if a["split"] and a["shape"] == a["leaf"]]
    assert not whole, whole
    if mesh[0] > 1:             # the batch ranks' sums of the FSDP leaves
        assert rec["reduce_scatters"] > 0
        assert rec["all_reduces"]
    else:
        assert not rec["all_reduces"] and not rec["reduce_scatters"]


# ---------------------------------------------------------------------------
# (f): parallel/tp.py's operations against their plain forms
# ---------------------------------------------------------------------------

_OPS = """
from repro_torch.configs.base import get_config, reduced
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.parallel import tp
from repro_torch.parallel.context import use_mesh_context
from repro_torch.parallel.mesh_rules import Rules
from repro_torch.utils.tree import flatten_with_names, unflatten_like

n, r = WORLD, RANK
rules = Rules(make_mesh((1, n)))
rng = np.random.default_rng(7)        # the same draws on every rank


def T(*shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


errs = {}


def err(name, got, want):
    errs[name] = max(errs.get(name, 0.0), float((got - want).abs().max()))


def leaf(x):
    return x.detach().clone().requires_grad_(True)


with use_mesh_context(rules.mesh, rules):
    errs["rank"] = [list(tp.model_rank_size()), [r, n]]
    x, gs = T(3, 5), [T(3, 5) for _ in range(n)]
    xr = leaf(x)
    y = tp.copy_to_model(xr)
    y.backward(gs[r])
    err("copy forward", y, x)
    err("copy backward", xr.grad, sum(gs))
    xs, g = [T(3, 5) for _ in range(n)], T(3, 5)
    xr = leaf(xs[r])
    y = tp.reduce_from_model(xr)
    y.backward(g)
    err("reduce forward", y, sum(xs))
    err("reduce backward", xr.grad, g)
    for dim in (0, 1, -1):
        whole, g = T(2 * n, 2 * n, 2 * n), T(2 * n, 2 * n, 2 * n)
        xr = leaf(whole.chunk(n, dim)[r])
        y = tp.gather_from_model(xr, dim)
        y.backward(g)
        err("gather forward", y, whole)
        err("gather backward", xr.grad, g.chunk(n, dim)[r])
        xr = leaf(whole)
        y = tp.scatter_to_model(xr, dim)
        y.backward(g.chunk(n, dim)[r])
        err("scatter forward", y, whole.chunk(n, dim)[r])
        err("scatter backward", xr.grad, g)
    V, D = 4 * n, 6
    vb = V // n
    table, ids, g = T(V, D), torch.from_numpy(rng.integers(0, V, (2, 5))), T(2, 5, D)
    whole = leaf(table)
    torch.index_select(whole, 0, ids.reshape(-1)).reshape(2, 5, D).backward(g)
    blk = leaf(table[r * vb:(r + 1) * vb])
    y = tp.vocab_parallel_embed(blk, ids, r * vb)
    y.backward(g)
    err("embed forward", y, table[ids])
    err("embed backward", blk.grad, whole.grad[r * vb:(r + 1) * vb])
    logits = T(2, 5, V) * 3
    labels = torch.from_numpy(rng.integers(0, V, (2, 5)))
    mask = torch.from_numpy((rng.random((2, 5)) > 0.3).astype(np.float32))
    whole = leaf(logits)
    ce, z = M._ce_from_logits(whole, labels, mask)
    (ce + 0.1 * z).backward()
    blk = leaf(logits[..., r * vb:(r + 1) * vb])
    ce_b, z_b = tp.vocab_parallel_ce(blk, labels, mask, r * vb)
    (ce_b + 0.1 * z_b).backward()
    err("ce forward", ce_b, ce)
    err("z forward", z_b, z)
    err("ce backward", blk.grad, whole.grad[..., r * vb:(r + 1) * vb])
    # GQA on blocks: 8 / 2 heads of 8 with qk_norm and qkv bias; at 2 ranks
    # each keeps its q and kv heads, at 4 k and v (half a head a block) are
    # gathered and the kv head of this rank's two q heads is sliced out
    def gqa_cfg(heads, kv_heads):
        return reduced(get_config("qwen3-4b")).replace(
            num_heads=heads, num_kv_heads=kv_heads, head_dim=8, qkv_bias=True)

    def blocks_of(cfg):
        specs = A.gqa_spec(cfg)
        whole = L.materialize(specs, 11, torch.float32)
        for name in ("q_norm", "k_norm"):
            whole[name]["scale"] = whole[name]["scale"] + T(8)
        slices = {k: rules.local_slices(s.axes, s.shape) for k, s in flatten_with_names(specs)}
        cut = {k: t[slices[k]] for k, t in flatten_with_names(whole)}
        return whole, unflatten_like(whole, cut), slices

    cfg = gqa_cfg(8, 2)
    whole, blk, slices = blocks_of(cfg)
    x, g = T(2, 16, cfg.d_model), T(2, 16, cfg.d_model)
    pos = torch.arange(16)[None].expand(2, 16)

    def run(tree, cfg=cfg):
        leaves = {k: leaf(t) for k, t in flatten_with_names(tree)}
        xr = leaf(x)
        with tp.computing_on_blocks():
            out, _ = A.gqa_full(unflatten_like(tree, leaves), cfg, xr, pos)
        out.backward(g)
        return out, xr.grad, {k: t.grad for k, t in leaves.items()}

    out_w, gx_w, grads_w = run(whole)
    tp.COUNTS["block_products"] = 0
    out_b, gx_b, grads_b = run(blk)
    errs["gqa block products"] = tp.COUNTS["block_products"]
    if n == 4:
        try:
            run(blocks_of(gqa_cfg(12, 6))[1], gqa_cfg(12, 6))
            errs["gqa 12 / 6"] = "ran"
        except ValueError:
            errs["gqa 12 / 6"] = "refused"
    err("gqa forward", out_b, out_w)
    err("gqa input backward", gx_b, gx_w)
    for k, gb in grads_b.items():
        err("gqa weight backward", gb, grads_w[k][slices[k]])
    spec = L.linear_spec(8, 4 * n, "embed", "mlp")["w"]
    row = L.linear_spec(4 * n, 8, "mlp", "embed")["w"]
    errs["block_dim"] = [tp.block_dim(torch.zeros(8, 4), spec), tp.block_dim(torch.zeros(4, 8), row),
                         tp.block_dim(torch.zeros(8, 4 * n), spec)]
    try:
        tp.block_dim(torch.zeros(8, 3), spec)
        errs["block_dim"].append("accepted")
    except ValueError:
        errs["block_dim"].append("refused")
if RANK == 0:
    print(json.dumps(errs))
"""


@pytest.mark.parametrize("world", [2, 4])
def test_tp_operations_on_ranks_match_their_plain_forms(world, tmp_path):
    errs = last_json(launch(_OPS, world, tmp_path)[0])
    assert errs.pop("rank") == [[0, world], [0, world]]
    assert errs.pop("block_dim") == [1, 0, None, "refused"]
    assert errs.pop("gqa block products") == 4            # wq, wk, wv, wo
    if world == 4:
        assert errs.pop("gqa 12 / 6") == "refused"
    for name in ("copy forward", "gather forward", "gather backward", "scatter forward",
                 "scatter backward", "embed forward", "embed backward", "reduce backward"):
        assert errs.pop(name) == 0.0, name
    assert errs, "no operation compared"
    for name, e in errs.items():          # sums in another order
        assert e <= 1e-5, (name, e)


def test_tp_operations_at_one_rank_are_the_identity():
    from repro_torch.models import model as M
    from repro_torch.parallel import tp

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))
    assert tp.model_group() is None and tp.model_rank_size() == (0, 1)
    for y in (tp.copy_to_model(x), tp.reduce_from_model(x), tp.gather_from_model(x, 0),
              tp.scatter_to_model(x, 1)):
        assert y is x
    table = torch.from_numpy(rng.standard_normal((16, 6)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 16, (2, 5)))
    assert torch.equal(tp.vocab_parallel_embed(table, ids, 0), table[ids])
    logits = torch.from_numpy(rng.standard_normal((2, 5, 16)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 16, (2, 5)))
    mask = torch.ones(2, 5)
    a, b = logits.clone().requires_grad_(True), logits.clone().requires_grad_(True)
    want = M._ce_from_logits(a, labels, mask)
    got = tp.vocab_parallel_ce(b, labels, mask, 0)
    (want[0] + 0.1 * want[1]).backward()
    (got[0] + 0.1 * got[1]).backward()
    for w, g in zip(want, got):
        assert abs(w.item() - g.item()) <= 1e-5 * abs(w.item())
    assert float((a.grad - b.grad).abs().max()) <= 1e-6
