"""The SSM families served over "model" blocks (``serve/engine.py`` on a mesh:
Mamba2's ``ssm`` and RWKV6's ``wkv`` states as this rank's heads, zamba2's
shared block's ``shared_k`` / ``shared_v`` on ``kv_heads_dim`` or
``cache_seq``, the Mamba2 conv window whole over "model"), on gloo CPU ranks
(tests/torch_gloo.py) against the port at one rank, and the dry run's FLOPs
a rank against the reference's compiled steps.

Inputs: reduced zamba2-1.2b (8 SSM heads of 32, state 16, 2 groups of 2
Mamba2 layers and the shared GQA block of 4 heads / 2 kv heads) and reduced
rwkv6-1.6b (4 heads of 32), float32, parameters from ``init_params(cfg, 1)``
made in every process as numpy and loaded through ``params_from_numpy``,
prompts B8 of 12 tokens from ``default_rng(3)``, a cache of 32 positions.

(a) At (1, 2) and (1, 4): prefill and 8 decode steps, the greedy tokens
    equal the port's at one rank and every row's logits within 1e-4 of the
    largest |logit|; the cache's blocks: the SSM states this rank's heads
    (8 / n of zamba2's, 4 / n of rwkv6's), zamba2's shared cache a kv head a
    rank at (1, 2) and 8 positions a rank at (1, 4) (its 2 kv heads do not
    split 4 ways), the conv windows and token-shift rows whole.
(b) A snapshot at token 4 taken at (1, 2) restores at (1, 1) (in this
    process), and one taken at (1, 1) restores at (1, 2) (on the ranks): the
    4 tokens after it equal the snapshotting engine's, the last logits
    within 1e-4 of the largest |logit|.  The (1, 2) snapshot has the
    one-rank engine's snapshot's leaf paths, shapes and dtypes.
(c) The dry run's FLOPs a rank (``launch/dryrun.walk_cell``, a fake group)
    of both models' train step (B8 S64), prefill (B8 S32) and decode (B8,
    cache 64) at (1, 1), (2, 4), (4, 2) and (1, 8), against the reference's
    compiled per-device FLOPs (``build_step(impl="xla")``, in JAX
    subprocesses as tests/test_torch_tp_mla.py (c) runs it) and the
    parent's walks (``PARENT``, the port before the SSM mixers computed on
    "model" blocks): at (1, 1) equal to the parent's to the digit; at most
    1.25x the reference's at (2, 4) and (4, 2), train at most 2.0x at
    (1, 8), serving at (1, 8) below the parent's.  Every all-reduce and
    all-gather the step calls through ``torch.distributed`` is in the walk's
    collective counts; at one rank it calls none.
(d) At one rank the new operations of ``parallel/tp.py`` are the identity.
"""
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_config, reduced
from repro_torch.models import model as M
from repro_torch.utils.tree import flatten_with_names, tree_map
from torch_gloo import launch, last_json

SRC = str(Path(__file__).resolve().parents[1] / "src")
ARCHS = ["zamba2-1.2b", "rwkv6-1.6b"]
SERVE_MESHES = ["(1, 2)", "(1, 4)"]
B, PROMPT, MAX_SEQ, STEPS, SNAP_AT, AFTER = 8, 12, 32, 8, 4, 4
SEED, PROMPT_SEED = 1, 3
LOGIT_TOL = 1e-4          # of the largest |logit|


def model_of(arch):
    cfg = reduced(get_config(arch))
    tree = tree_map(lambda t: t.detach().numpy().copy(),
                    M.params_tree(M.init_params(cfg, SEED, "cpu")))
    return cfg, M.params_from_numpy(cfg, tree, "cpu")


def prompts_of(cfg):
    rng = np.random.default_rng(PROMPT_SEED)
    return {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32))}


# ---------------------------------------------------------------------------
# (a), (b): serving on ranks
# ---------------------------------------------------------------------------

# the ranks make the same inputs with the same functions
_RANK = (f"B, PROMPT, MAX_SEQ, STEPS, SNAP_AT, AFTER = {B}, {PROMPT}, {MAX_SEQ}, {STEPS}, "
         f"{SNAP_AT}, {AFTER}\n"
         f"SEED, PROMPT_SEED = {SEED}, {PROMPT_SEED}\n"
         "from repro_torch.configs.base import get_config, reduced\n"
         "from repro_torch.models import model as M\n"
         "from repro_torch.utils.tree import tree_map\n"
         + "\n\n".join(inspect.getsource(f) for f in (model_of, prompts_of))) + """
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel.mesh_rules import Rules
from repro_torch.serve.engine import Engine
from repro_torch.utils.tree import flatten_with_names

mesh, work, snaps = eval(ARGS[0]), ARGS[1], ARGS[2]
rules = Rules(make_mesh(mesh))
report = {}


def save(name, **arrays):
    if RANK == 0:
        np.savez(f"{work}/{name}.npz", **arrays)


def nest(named):
    out = {}
    for n, x in named.items():
        *path, leaf = n.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = x
    return out


for arch in ["zamba2-1.2b", "rwkv6-1.6b"]:
    cfg, model = model_of(arch)
    eng = Engine(cfg, model, batch=B, max_seq=MAX_SEQ, rules=rules)
    first = eng.prefill(prompts_of(cfg))
    shapes = {n: list(x.shape) for n, x in flatten_with_names(eng.cache)}
    toks, logits = [eng.whole_rows(first).numpy()], [eng.whole_rows(eng.last_logits).numpy()]
    for i in range(STEPS):
        toks.append(eng.generate(1)[:, 0])
        logits.append(eng.whole_rows(eng.last_logits).numpy())
    save(arch, tokens=np.stack(toks, 1), logits=np.stack(logits, 1))
    report[arch] = {"shapes": shapes, "blocks": sorted(eng.blocks)}
    if snaps == "-":
        continue
    # (b) a snapshot at token SNAP_AT, and the one-rank engine's restored here
    eng = Engine(cfg, model, batch=B, max_seq=MAX_SEQ, rules=rules)
    eng.prefill(prompts_of(cfg))
    eng.generate(SNAP_AT)
    snap = eng.snapshot()
    save(f"{arch}-snap", **{n: x.numpy() for n, x in flatten_with_names(snap)})
    cont = eng.generate(AFTER)
    save(f"{arch}-cont", tokens=cont, logits=eng.whole_rows(eng.last_logits).numpy())
    one = np.load(f"{snaps}/{arch}-one-snap.npz")
    other = Engine(cfg, model, batch=B, max_seq=MAX_SEQ, rules=rules)
    other.restore(nest({n: torch.from_numpy(one[n]) for n in one.files}))
    toks = other.generate(AFTER)
    save(f"{arch}-restored", tokens=toks, logits=other.whole_rows(other.last_logits).numpy())
if RANK == 0:
    print(json.dumps(report))
"""


def _one_rank(arch):
    """(tokens (B, 1 + STEPS), logits) of the port at one rank, and its
    snapshot at token SNAP_AT with the AFTER tokens and last logits after it."""
    from repro_torch.serve.engine import Engine

    cfg, model = model_of(arch)
    eng = Engine(cfg, model, batch=B, max_seq=MAX_SEQ)
    toks, logits = [eng.prefill(prompts_of(cfg)).numpy()], [eng.last_logits.numpy()]
    for _ in range(STEPS):
        toks.append(eng.generate(1)[:, 0])
        logits.append(eng.last_logits.numpy())
    eng = Engine(cfg, model, batch=B, max_seq=MAX_SEQ)
    eng.prefill(prompts_of(cfg))
    eng.generate(SNAP_AT)
    snap = {n: x.numpy().copy() for n, x in flatten_with_names(eng.snapshot())}
    cont = eng.generate(AFTER)
    return (np.stack(toks, 1), np.stack(logits, 1)), snap, (cont, eng.last_logits.numpy())


@pytest.fixture(scope="module")
def one_rank():
    return {arch: _one_rank(arch) for arch in ARCHS}


@pytest.fixture(scope="module")
def served(tmp_path_factory, one_rank):
    """Each mesh's launch: the report of rank 0 and the directory its arrays
    went to; the (1, 2) ranks also snapshot, and restore the one-rank
    engine's snapshot."""
    snaps = tmp_path_factory.mktemp("one-rank-snaps")
    for arch, (_, snap, _) in one_rank.items():
        np.savez(snaps / f"{arch}-one-snap.npz", **snap)
    out = {}
    for mesh in SERVE_MESHES:
        work = tmp_path_factory.mktemp(mesh.replace(" ", "").replace(",", "x").strip("()"))
        outs = launch(_RANK, int(np.prod(eval(mesh))), work, mesh, work,
                      snaps if mesh == "(1, 2)" else "-", timeout=300)
        out[mesh] = (last_json(outs[0]), work)
    return out


def _close(got, want):
    scale = float(np.abs(want).max())
    return float(np.abs(got - want).max()) <= LOGIT_TOL * scale


def _blocks_want(arch, n) -> dict:
    """The shapes of the cache leaves a rank holds at (1, n)."""
    cfg = reduced(get_config(arch))
    if arch.startswith("zamba2"):
        G, inner, W = cfg.num_layers // cfg.shared_attn_period, cfg.shared_attn_period, 4
        E, N, H, P = cfg.d_inner, cfg.ssm_state_dim, cfg.ssm_heads, cfg.ssm_head_dim
        kv = [G, B, MAX_SEQ, cfg.num_kv_heads // n, cfg.head_dim] if cfg.num_kv_heads % n == 0 \
            else [G, B, MAX_SEQ // n, cfg.num_kv_heads, cfg.head_dim]
        return {"seg0/mamba/conv": [G, inner, B, W - 1, E + 2 * N],
                "seg0/mamba/ssm": [G, inner, B, H // n, P, N],
                "seg0/shared_k": kv, "seg0/shared_v": kv, "t": []}
    D, Dh = cfg.d_model, cfg.head_dim
    return {"seg0/xt": [cfg.num_layers, B, D], "seg0/xc": [cfg.num_layers, B, D],
            "seg0/wkv": [cfg.num_layers, B, D // Dh // n, Dh, Dh], "t": []}


@pytest.mark.parametrize("mesh", SERVE_MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_archs_on_model_blocks_match_one_rank(arch, mesh, served, one_rank):
    """(a)."""
    rep, work = served[mesh]
    got = np.load(work / f"{arch}.npz")
    want_tok, want_logits = one_rank[arch][0]
    np.testing.assert_array_equal(got["tokens"], want_tok, err_msg=arch)
    assert _close(got["logits"], want_logits), (arch, mesh)
    assert rep[arch]["blocks"] == sorted(M.serving_blocks(reduced(get_config(arch))))
    assert rep[arch]["shapes"] == _blocks_want(arch, eval(mesh)[1])


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
def test_snapshots_restore_between_1x2_and_one_rank(arch, served, one_rank):
    """(b)."""
    from repro_torch.serve.engine import Engine

    work = served["(1, 2)"][1]
    _, one_snap, (one_toks, one_logits) = one_rank[arch]
    # the one-rank snapshot restored at (1, 2)
    restored = np.load(work / f"{arch}-restored.npz")
    np.testing.assert_array_equal(restored["tokens"], one_toks)
    assert _close(restored["logits"], one_logits)
    # the (1, 2) snapshot restored at (1, 1)
    snap = dict(np.load(work / f"{arch}-snap.npz"))
    assert sorted(snap) == sorted(one_snap)
    for n, x in one_snap.items():
        assert (snap[n].shape, snap[n].dtype) == (x.shape, x.dtype), n
    cont = np.load(work / f"{arch}-cont.npz")
    cfg, model = model_of(arch)
    eng = Engine(cfg, model, batch=B, max_seq=MAX_SEQ)
    eng.restore(_nest({n: torch.from_numpy(a) for n, a in snap.items()}))
    np.testing.assert_array_equal(eng.generate(AFTER), cont["tokens"])
    assert _close(eng.last_logits.numpy(), cont["logits"])


# ---------------------------------------------------------------------------
# (c): the dry run's FLOPs a rank
# ---------------------------------------------------------------------------

WALK_MESHES = [(1, 1), (2, 4), (4, 2), (1, 8)]
KINDS = [("train", 64), ("prefill", 32), ("decode", 64)]        # (kind, seq), B8
# the parent's walks (``walk_cell``, B8), before the SSM mixers and zamba2's
# shared block computed on "model" blocks
PARENT = {
    "zamba2-1.2b": {"train": [2_844_016_640, 1_346_510_848, 685_838_336, 2_667_855_872],
                    "prefill": [437_264_384, 218_238_976, 109_185_024, 436_346_880],
                    "decode": [14_295_040, 6_754_304, 3_442_688, 13_377_536]},
    "rwkv6-1.6b": {"train": [2_475_950_080, 1_162_477_568, 593_821_696, 2_299_789_312],
                   "prefill": [383_385_600, 191_299_584, 95_715_328, 382_468_096],
                   "decode": [12_713_984, 5_963_776, 3_047_424, 11_796_480]},
}
RATIO = {(2, 4): 1.25, (4, 2): 1.25}
TRAIN_RATIO_1x8 = 2.0

_PORT_WALK = """
import json
import torch.distributed as dist
from repro_torch.configs.base import ShapeConfig, get_config, reduced
from repro_torch.launch import dryrun as D

calls = {}
for fn, kind in (("all_reduce", "all-reduce"), ("all_gather_into_tensor", "all-gather")):
    def spy(*a, real=getattr(dist, fn), kind=kind, **kw):
        calls[kind] = calls.get(kind, 0) + 1
        return real(*a, **kw)
    setattr(dist, fn, spy)

out = {}
for mesh in MESHES:
    for kind, seq in KINDS:
        calls.clear()
        walk, _ = D.walk_cell(reduced(get_config(ARCH)), ShapeConfig(kind, kind, seq, 8),
                              tuple(mesh))
        costs = walk.costs()
        out[f"{kind}|{tuple(mesh)}"] = costs["flops"]
        out[f"{kind}|{tuple(mesh)}|collectives"] = [dict(calls), costs["collective_counts"]]
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
for shape in MESHES:
    mesh = jax.make_mesh(tuple(shape), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    for kind, seq in KINDS:
        if tuple(shape) == (1, 1) and kind != "decode":      # compared at (1, 1): decode
            continue
        step, args, in_sh = D.build_step(reduced(get_config(ARCH)),
                                         ShapeConfig(kind, kind, seq, 8), mesh, impl="xla")
        args = jax.tree_util.tree_map(
            lambda s, sh: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=sh), args, in_sh)
        with mesh:
            out[f"{kind}|{tuple(shape)}"] = analyze_hlo_text(
                step.lower(*args).compile().as_text())["flops"]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def walks():
    """{arch: (the port's walks, the reference's compiled FLOPs)}, from four
    subprocesses run side by side: the port's walks of each arch, and the
    reference's steps of each arch (at (1, 1) decode only)."""
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    env.pop("XLA_FLAGS", None)
    pre = f"MESHES = {[list(m) for m in WALK_MESHES]!r}\n"
    jobs = []
    for arch in ARCHS:
        for side, code in (("port", _PORT_WALK), ("ref", _REF_WALK)):
            jobs.append((arch, side, f"ARCH = {arch!r}\nKINDS = {KINDS!r}\n" + code))
    procs = [subprocess.Popen([sys.executable, "-c", pre + code], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _, _, code in jobs]
    out = {arch: ({}, {}) for arch in ARCHS}
    for (arch, side, _), p in zip(jobs, procs):
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, stdout[-3000:] + stderr[-6000:]
        out[arch][side == "ref"].update(json.loads(stdout.strip().splitlines()[-1]))
    return out


@pytest.mark.parametrize("kind", [k for k, _ in KINDS])
@pytest.mark.parametrize("arch", ARCHS)
def test_flops_a_rank_against_the_reference_and_the_parent(walks, arch, kind):
    """(c)."""
    port, ref = walks[arch]
    for i, mesh in enumerate(WALK_MESHES):
        got, parent = port[f"{kind}|{mesh}"], PARENT[arch][kind][i]
        if mesh == (1, 1):
            assert got == parent, (arch, kind, got, parent)
        elif mesh in RATIO:
            want = ref[f"{kind}|{mesh}"]
            assert got <= RATIO[mesh] * want, (arch, kind, mesh, got, want, got / want)
        elif kind == "train":
            want = ref[f"{kind}|{mesh}"]
            assert got <= TRAIN_RATIO_1x8 * want, (arch, kind, mesh, got, want, got / want)
        else:
            assert got < parent, (arch, kind, mesh, got, parent)
    if kind == "decode":
        assert port["decode|(1, 1)"] == ref["decode|(1, 1)"]
    # every all-reduce and all-gather the modules called (the sums over
    # "model" both ways, the x channels' gathers among them) is in the walk's
    # count; none at one rank
    for mesh in WALK_MESHES:
        called, counted = port[f"{kind}|{mesh}|collectives"]
        assert (mesh == (1, 1)) == (not called), (arch, kind, mesh, called)
        for k, n in called.items():
            assert counted.get(k, 0) >= n, (arch, kind, mesh, called, counted)


# ---------------------------------------------------------------------------
# (d): at one rank
# ---------------------------------------------------------------------------


def test_new_tp_operations_at_one_rank_are_the_identity():
    """(d)."""
    from repro_torch.parallel import tp

    x = torch.arange(12.0).reshape(3, 4)
    assert tp.sum_over_model(x) is x
    assert torch.equal(tp.own_part(x, 1, [(1, 2), (0, 1)]), torch.cat([x[:, 1:3], x[:, :1]], 1))
    assert torch.equal(tp.own_part(x, 0, [(0, 3)]), x)
