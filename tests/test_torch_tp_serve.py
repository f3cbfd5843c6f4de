"""Serving over "model" blocks (``serve/engine.py`` on a mesh, ``parallel/tp.py``'s
sequence split, ``flash_decode``'s log-sum-exp) on gloo CPU ranks
(tests/torch_gloo.py), against the port at one rank and the reference.

Inputs: each arch's reduced config (4 layers, d_model 128, 4 / 2 heads of 32,
vocab 512, float32), parameters from ``init_params(cfg, 1)`` made in every
process as numpy and loaded through ``params_from_numpy``, prompts B8 of 12
tokens from ``default_rng(3)``, a cache of 32 positions.

(a) ``ref.attention(return_lse=True)`` (the plain version ``flash_decode``
    takes on the CPU) against a float64 evaluation, ``kv_len`` 0 included:
    an output of zeros and an lse of ``-inf``.
(b) ``tp.merge_over_model`` on 2 and 4 "model" ranks (the (1, 2) and (2, 4)
    launches): each rank attends over its block of positions of one cache
    with ``local_kv_len`` and merges; against whole-cache attention, at
    positions whose blocks past ``t`` hold no key.
(c) The dense four archs at (1, 2) (the cache on ``kv_heads_dim``), (2, 4)
    and (1, 8) (on ``cache_seq``: 2 kv heads do not split 4 or 8 ways), and
    reduced deepseek-v3 (MLA's latent on ``cache_seq``), granite-moe and
    musicgen at (2, 4) (MoE at capacity factor 4, where no expert overflows:
    ROADMAP §3 fault 8): prefill and 8 decode steps, the logits of every row
    within 1e-4 of the largest |logit| of the port at one rank and the
    greedy tokens equal.  The one-rank port routes MoE prefill with the
    mesh's batch shards as groups (2 at (2, 4)), as the engine's ranks do.
(d) Each cache leaf a rank holds has the reference's shard shape
    (``NamedSharding.shard_shape`` under its rules, JAX subprocess), and no
    collective of a decode step carries as many elements as one layer's
    whole cache entry.
(e) The (2, 4) engine's first 6 greedy tokens equal the reference's
    one-device ``prefill`` / ``decode_step`` (``impl="pallas_interpret"``;
    ``"xla"`` for MLA, ROADMAP §3 fault 9; MoE prefill with 2 groups).
(f) A (2, 4) snapshot at token 4 (qwen2-0.5b, deepseek-v3, musicgen) has
    the one-rank engine's snapshot's leaf paths, shapes and dtypes.
    Restored at (2, 4) it continues bit-equal; restored at (4, 2), (1, 8)
    and, in this process, (1, 1), with equal tokens and logits within 1e-4.
(g) At one rank every new operation is the identity, or the plain form.
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
DENSE = ["qwen2-0.5b", "qwen3-4b", "llama3.2-1b", "granite-8b"]
OTHERS = ["deepseek-v3-671b", "granite-moe-3b-a800m", "musicgen-large"]
SNAP_ARCHS = ["qwen2-0.5b", "deepseek-v3-671b", "musicgen-large"]
MESHES = {"(1, 2)": DENSE, "(2, 4)": DENSE + OTHERS, "(1, 8)": DENSE}
B, PROMPT, MAX_SEQ, STEPS, SNAP_AT = 8, 12, 32, 8, 4
SEED, PROMPT_SEED = 1, 3
LOGIT_TOL = 1e-4          # of the largest |logit|
REF_STEPS = 6


def config_of(arch):
    """The reduced config; MoE at capacity factor 4, where no expert
    overflows (the reference's overflow erases a token, ROADMAP §3 fault 8)."""
    cfg = reduced(get_config(arch))
    return cfg.replace(capacity_factor=4.0) if cfg.num_experts else cfg


def model_of(arch):
    cfg = config_of(arch)
    tree = tree_map(lambda t: t.detach().numpy().copy(),
                    M.params_tree(M.init_params(cfg, SEED, "cpu")))
    return cfg, M.params_from_numpy(cfg, tree, "cpu")


def prompts_of(cfg):
    shape = (B, PROMPT) + ((cfg.num_codebooks,) if cfg.num_codebooks else ())
    rng = np.random.default_rng(PROMPT_SEED)
    return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, shape).astype(np.int32))}


# the ranks make the same inputs with the same functions
_RANK = (f"B, PROMPT, MAX_SEQ, STEPS, SNAP_AT = {B}, {PROMPT}, {MAX_SEQ}, {STEPS}, {SNAP_AT}\n"
         f"SEED, PROMPT_SEED = {SEED}, {PROMPT_SEED}\n"
         "from repro_torch.configs.base import get_config, reduced\n"
         "from repro_torch.models import model as M\n"
         "from repro_torch.utils.tree import tree_map\n"
         + "\n\n".join(inspect.getsource(f) for f in (config_of, model_of, prompts_of))) + """
from repro_torch.kernels import ref
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel import tp
from repro_torch.parallel.context import use_mesh_context
from repro_torch.parallel.mesh_rules import Rules
from repro_torch.serve.engine import Engine
from repro_torch.utils.tree import flatten_with_names

mesh, work = eval(ARGS[0]), ARGS[1]
archs, snap_archs = json.loads(ARGS[2]), json.loads(ARGS[3])
rules = Rules(make_mesh(mesh))
report = {"merge": {}}


def save(name, **arrays):
    if RANK == 0:
        np.savez(f"{work}/{name}.npz", **arrays)


# (b) the merge over this mesh's "model" ranks against whole-cache attention
with use_mesh_context(rules.mesh, rules):
    rng = np.random.default_rng(11)
    S, H, Hkv, D = 32, 4, 2, 32
    q = torch.from_numpy(rng.standard_normal((2, 1, H, D)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, S, Hkv, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, S, Hkv, D)).astype(np.float32))
    start, n = tp.seq_block(S)
    for t in (0, 5, 15, 16, 31):
        tt = torch.tensor(t, dtype=torch.int32)
        out, lse = ref.attention(q, k[:, start:start + n], v[:, start:start + n],
                                 causal=False, kv_len=tp.local_kv_len(tt, S), return_lse=True)
        got = tp.merge_over_model(out, lse)
        want = ref.attention(q, k, v, causal=False, kv_len=t + 1)
        lens = tp.gather_from_model(tp.local_kv_len(tt, S).reshape(1), 0)   # every rank's
        report["merge"][str(t)] = [float((got - want).abs().max()), lens.tolist()]


collected = []           # the elements of each collective's tensors
for fn in ("all_gather_into_tensor", "all_reduce", "reduce_scatter_tensor", "all_gather"):
    real = getattr(torch.distributed, fn)

    def spy(t, *a, real=real, **kw):
        for x in (t if isinstance(t, (list, tuple)) else [t]):
            collected.append(x.numel())
        return real(t, *a, **kw)

    setattr(torch.distributed, fn, spy)


for arch in archs:
    cfg, model = model_of(arch)
    prompts = prompts_of(cfg)
    eng = Engine(cfg, model, batch=B, max_seq=MAX_SEQ, rules=rules)
    first = eng.prefill(prompts)
    shapes = {n: list(x.shape) for n, x in flatten_with_names(eng.cache)}
    toks, logits = [eng.whole_rows(first).numpy()], [eng.whole_rows(eng.last_logits).numpy()]
    biggest = 0
    for i in range(STEPS):
        collected.clear()
        toks.append(eng.generate(1)[:, 0])
        if i == 0:
            biggest = max(collected)
        logits.append(eng.whole_rows(eng.last_logits).numpy())
    save(arch, tokens=np.stack(toks, 1), logits=np.stack(logits, 1))
    report[arch] = {"shapes": shapes, "biggest_collective": biggest, "blocks": sorted(eng.blocks)}

# (f) a snapshot at token SNAP_AT, restored on this mesh and on others
for arch in snap_archs:
    cfg, model = model_of(arch)
    eng = Engine(cfg, model, batch=B, max_seq=MAX_SEQ, rules=rules)
    eng.prefill(prompts_of(cfg))
    eng.generate(SNAP_AT)
    snap = eng.snapshot()
    flat = dict(flatten_with_names(snap))
    save(f"{arch}-snap", **{n: x.numpy() for n, x in flat.items()})
    conts = {}
    for shape in (mesh, (4, 2), (1, 8)):
        if shape == mesh:
            conts["base"] = eng
        other = Engine(cfg, model, batch=B, max_seq=MAX_SEQ, rules=Rules(make_mesh(shape)))
        other.restore(snap)
        conts[str(shape)] = other
    out = {}
    for key, e in conts.items():
        toks = e.generate(4)
        out[key + " tokens"] = toks
        out[key + " logits"] = e.whole_rows(e.last_logits).numpy()
    save(f"{arch}-cont", **out)
if RANK == 0:
    print(json.dumps(report))
"""


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Each mesh's launch (one a mesh, run one after the other): the
    report of rank 0 and the directory its arrays went to."""
    out = {}
    for mesh, archs in MESHES.items():
        work = tmp_path_factory.mktemp(mesh.replace(" ", "").replace(",", "x").strip("()"))
        world = int(np.prod(eval(mesh)))
        snaps = SNAP_ARCHS if mesh == "(2, 4)" else []
        outs = launch(_RANK, world, work, mesh, work, json.dumps(archs), json.dumps(snaps),
                      timeout=400)
        out[mesh] = (last_json(outs[0]), work)
    return out


def _one_rank(arch, groups, steps=STEPS, prompts=None):
    """(tokens (B, 1 + steps), logits) of the port at one rank; MoE prefill
    routes with ``groups`` groups."""
    cfg, model = model_of(arch)
    prompts = prompts or prompts_of(cfg)
    logits, cache = M.prefill(model, cfg, prompts, MAX_SEQ, moe_groups=groups)
    toks, lg = [], []
    for _ in range(steps + 1):
        lg.append(logits.numpy())
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        if cfg.num_codebooks and tok.ndim == 1:
            tok = tok[:, None].expand(B, cfg.num_codebooks).contiguous()
        toks.append(tok.numpy())
        if len(toks) <= steps:
            logits, cache = M.decode_step(model, cfg, tok, cache)
    return np.stack(toks, 1), np.stack(lg, 1)


@pytest.fixture(scope="module")
def one_rank():
    return {(a, g): _one_rank(a, g) for a in DENSE + OTHERS for g in (1, 2)
            if g == 1 or a in OTHERS}


def _close(got, want):
    scale = float(np.abs(want).max())
    return float(np.abs(got - want).max()) <= LOGIT_TOL * scale


@pytest.mark.parametrize("mesh", list(MESHES))
def test_archs_on_model_blocks_match_one_rank(mesh, served, one_rank):
    """(c)."""
    rep, work = served[mesh]
    groups = eval(mesh)[0]
    for arch in MESHES[mesh]:
        got = np.load(work / f"{arch}.npz")
        want_tok, want_logits = one_rank[(arch, groups if arch in OTHERS else 1)]
        assert got["tokens"].shape == want_tok.shape, arch
        np.testing.assert_array_equal(got["tokens"], want_tok, err_msg=arch)
        assert _close(got["logits"], want_logits), (arch, mesh)
        assert rep[arch]["blocks"] == sorted(M.serving_blocks(reduced(get_config(arch))))


@pytest.mark.parametrize("mesh", ["(1, 2)", "(2, 4)"])
def test_merge_over_model_matches_whole_cache_attention(mesh, served):
    """(b)."""
    merged = served[mesh][0]["merge"]
    n = eval(mesh)[1]
    block = 32 // n
    for t, (err, lens) in merged.items():
        assert err <= 1e-6, (mesh, t, err)
        # rank r holds positions [r block, (r + 1) block); at t 0 every block
        # but the first holds no key
        assert lens == [min(max(int(t) + 1 - r * block, 0), block) for r in range(n)]


_SHARDS = """
import json
from repro.launch import dryrun as D      # forces 512 host devices: this process only
import jax
import numpy as np
from jax.sharding import AxisType
from repro.configs.base import get_config, reduced
from repro.models import model as M
from repro.parallel.mesh_rules import Rules

WANT = json.loads(__import__("sys").argv[1])


def is_axes(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


out = {}
for mesh_shape, archs in WANT.items():
    mesh = jax.make_mesh(eval(mesh_shape), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    rules = Rules(mesh)
    for arch in archs:
        sds, axes = M.cache_specs(reduced(get_config(arch)), B, MAX_SEQ)
        paths = jax.tree_util.tree_flatten_with_path(sds)[0]
        flat_axes = jax.tree_util.tree_leaves(axes, is_leaf=is_axes)
        for (path, s), ax in zip(paths, flat_axes):
            name = "/".join(str(getattr(p, "key", p)) for p in path)
            out[f"{mesh_shape}|{arch}|{name}"] = list(rules.sharding(ax, s.shape)
                                                      .shard_shape(s.shape))
print(json.dumps(out))
"""


def test_cache_blocks_are_the_references_shards_and_decode_moves_no_whole_leaf(served):
    """(d)."""
    pytest.importorskip("jax")
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", f"B, MAX_SEQ = {B}, {MAX_SEQ}\n" + _SHARDS,
                        json.dumps(MESHES)], env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-6000:]
    want = json.loads(r.stdout.strip().splitlines()[-1])
    for mesh, archs in MESHES.items():
        rep = served[mesh][0]
        for arch in archs:
            shapes = rep[arch]["shapes"]
            assert {k.split("|")[2] for k in want if k.startswith(f"{mesh}|{arch}|")} \
                == set(shapes), (mesh, arch)
            for name, shape in shapes.items():
                assert shape == want[f"{mesh}|{arch}|{name}"], (mesh, arch, name, shape)
            cfg = reduced(get_config(arch))
            layer_entry = min(int(np.prod(s[1:])) for n, (s, _) in
                              _spec_leaves(M.cache_specs(cfg, B, MAX_SEQ)) if n != "t")
            assert 0 < rep[arch]["biggest_collective"] < layer_entry, (mesh, arch)


def _spec_leaves(specs, path=()):
    for k in sorted(specs):
        v = specs[k]
        if isinstance(v, dict):
            yield from _spec_leaves(v, path + (k,))
        else:
            yield "/".join(path + (k,)), v


def test_tokens_at_2x4_equal_the_references_one_device_decode(served):
    """(e)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs.base import get_config as jax_get_config
    from repro.configs.base import reduced as jax_reduced
    from repro.models import model as JM

    work = served["(2, 4)"][1]
    for arch in DENSE + OTHERS:
        cfg = config_of(arch)
        cfg_j = jax_reduced(jax_get_config(arch))
        cfg_j = cfg_j.replace(capacity_factor=cfg.capacity_factor)
        _, model = model_of(arch)
        params = tree_map(lambda t: jnp.asarray(t.detach().numpy()), M.params_tree(model))
        impl = "xla" if cfg.mixer == "mla" else "pallas_interpret"
        tokens = jnp.asarray(prompts_of(cfg)["tokens"].numpy())
        logits, cache = JM.prefill(params, cfg_j, {"tokens": tokens}, MAX_SEQ, impl=impl,
                                   moe_groups=2 if cfg.num_experts else 1)
        want = []
        for _ in range(REF_STEPS):
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            if cfg.num_codebooks and tok.ndim == 1:
                tok = jnp.broadcast_to(tok[:, None], (B, cfg.num_codebooks))
            want.append(np.asarray(tok))
            logits, cache = JM.decode_step(params, cfg_j, tok, cache, impl=impl)
        got = np.load(work / f"{arch}.npz")["tokens"][:, :REF_STEPS]
        np.testing.assert_array_equal(got, np.stack(want, 1), err_msg=arch)


@pytest.mark.parametrize("arch", SNAP_ARCHS)
def test_snapshot_at_2x4_restores_on_every_mesh(arch, served):
    """(f)."""
    from repro_torch.serve.engine import Engine

    work = served["(2, 4)"][1]
    snap = dict(np.load(work / f"{arch}-snap.npz"))
    cont = np.load(work / f"{arch}-cont.npz")
    cfg, model = model_of(arch)
    eng = Engine(cfg, model, batch=B, max_seq=MAX_SEQ)
    eng.prefill(prompts_of(cfg))
    eng.generate(SNAP_AT)
    want = dict(flatten_with_names(eng.snapshot()))
    assert sorted(snap) == sorted(want)
    for n, x in want.items():
        assert (snap[n].shape, snap[n].dtype) == (tuple(x.shape), x.numpy().dtype), n
    # restored on the snapshot's own mesh: bit-equal
    for key in ("tokens", "logits"):
        np.testing.assert_array_equal(cont[f"(2, 4) {key}"], cont[f"base {key}"])
    # at one rank, from the snapshot's arrays
    fresh = Engine(cfg, model, batch=B, max_seq=MAX_SEQ)
    tree = _nest({n: torch.from_numpy(a) for n, a in snap.items()})
    fresh.restore(tree)
    conts = {"(1, 1)": (fresh.generate(4), fresh.last_logits.numpy())}
    conts.update({m: (cont[f"{m} tokens"], cont[f"{m} logits"]) for m in ("(4, 2)", "(1, 8)")})
    for mesh, (toks, logits) in conts.items():
        np.testing.assert_array_equal(toks, cont["base tokens"], err_msg=mesh)
        assert _close(logits, cont["base logits"]), mesh


def _nest(named: dict) -> dict:
    out: dict = {}
    for n, x in named.items():
        *path, leaf = n.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = x
    return out


def test_plain_lse_against_float64():
    """(a)."""
    from repro_torch.kernels import ref

    rng = np.random.default_rng(5)
    B_, S, H, Hkv, D = 2, 40, 6, 2, 16
    q = rng.standard_normal((B_, 1, H, D))
    k = rng.standard_normal((B_, S, Hkv, D))
    v = rng.standard_normal((B_, S, Hkv, D))
    scale = 0.3
    for kv_len in (0, 1, 17, 40):
        out, lse = ref.attention(*(torch.from_numpy(a.astype(np.float32)) for a in (q, k, v)),
                                 causal=False, kv_len=kv_len, scale=scale, return_lse=True)
        assert out.shape == (B_, 1, H, D) and lse.shape == (B_, 1, H)
        assert lse.dtype == torch.float32
        if kv_len == 0:
            assert torch.equal(out, torch.zeros_like(out))
            assert bool(torch.isneginf(lse).all())
            continue
        kk = np.repeat(k[:, :kv_len], H // Hkv, axis=2)      # (B, n, H, D)
        vv = np.repeat(v[:, :kv_len], H // Hkv, axis=2)
        s = np.einsum("bhd,bshd->bhs", q[:, 0], kk) * scale
        m = s.max(-1, keepdims=True)
        want_lse = (m[..., 0] + np.log(np.exp(s - m).sum(-1)))
        p = np.exp(s - want_lse[..., None])
        want = np.einsum("bhs,bshd->bhd", p, vv)
        assert np.abs(lse.numpy()[:, 0] - want_lse).max() <= 2e-5 * np.abs(want_lse).max()
        assert np.abs(out.numpy()[:, 0] - want).max() <= 2e-5


def test_new_operations_at_one_rank_are_the_identity():
    """(g)."""
    from repro_torch.core.virtualization import cut_tree, whole_tree
    from repro_torch.kernels import ref
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import tp
    from repro_torch.parallel.mesh_rules import Rules
    from repro_torch.serve import engine as E

    rng = np.random.default_rng(2)
    assert tp.seq_block(24) == (0, 24)
    for t in (0, 5, 23):
        tt = torch.tensor(t, dtype=torch.int32)
        assert int(tp.local_kv_len(tt, 24)) == t + 1
    out = torch.from_numpy(rng.standard_normal((2, 1, 4, 8)).astype(np.float32))
    lse = torch.from_numpy(rng.standard_normal((2, 1, 4)).astype(np.float32))
    assert tp.merge_over_model(out, lse) is out
    assert tp.gather_logits(out) is out
    assert tp.block_dims(("batch", "cache_seq", "kv_heads_dim", None), (2, 8, 2, 4)) == []
    cache = torch.zeros(2, 8, 2, 4)
    entry = torch.ones(2, 1, 2, 4)
    tp.write_owned(cache, entry, torch.tensor(3, dtype=torch.int32), 8)
    assert torch.equal(cache[:, 3], entry[:, 0]) and float(cache.sum()) == entry.numel()
    # merging one block is that block's attention; two blocks, whole attention
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 8)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 10, 2, 8)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 10, 2, 8)).astype(np.float32))
    parts = [ref.attention(q, k[:, a:b], v[:, a:b], causal=False, return_lse=True)
             for a, b in ((0, 4), (4, 10))]
    merged = tp.merge_partials([p[0] for p in parts], [p[1] for p in parts])
    assert float((merged - ref.attention(q, k, v, causal=False)).abs().max()) <= 1e-6
    rules = Rules(make_host_mesh("cpu"))
    cfg, model = model_of("qwen2-0.5b")
    assert not E.computes_on_blocks(cfg, rules)
    assert E.serving_params(cfg, model, rules) is model
    tree = M.init_cache(cfg, B, MAX_SEQ, "cpu")
    axes = M.cache_logical_axes(cfg, B, MAX_SEQ)
    shapes = {n: tuple(x.shape) for n, x in flatten_with_names(tree)}
    for got in (cut_tree(tree, axes, rules), whole_tree(tree, axes, rules, shapes)):
        assert all(a is b for (_, a), (_, b) in zip(flatten_with_names(got),
                                                    flatten_with_names(tree)))
    eng = E.Engine(cfg, model, batch=B, max_seq=MAX_SEQ)
    eng.prefill(prompts_of(cfg))
    snap = eng.snapshot()
    assert snap["cache"]["seg0"]["k"] is eng.cache["seg0"]["k"]
    assert snap["last_tokens"] is eng.last_tokens


# ---------------------------------------------------------------------------
# On the card: flash_decode's log-sum-exp against the plain version's
# ---------------------------------------------------------------------------

LSE_TOL = {"float32": 2e-5, "bfloat16": 2e-3}       # of max(|lse|, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,Hkv,Dq,Dv,kvl,mla", [
    (4, 1024, 14, 2, 64, 64, 544, False), (4, 1024, 14, 2, 64, 64, 0, False),
    (4, 1024, 32, 8, 128, 128, 65, False), (2, 512, 8, 2, 64, 64, 77, False),
    (4, 1024, 128, 1, 576, 512, 544, True), (2, 96, 4, 1, 48, 32, 40, True),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_lse_kernel_vs_plain(B, S, H, Hkv, Dq, Dv, kvl, mla, dtype):
    """Every instantiation the serving path asks the lse of (GQA D64 and D128,
    MLA's absorbed shape with V a view of K's rows, where bfloat16 fits);
    the output with its lse is the output without it, bit for bit."""
    from repro_torch.kernels import decode_attention, ref

    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the CUDA kernels are built for sm_90a: needs an H100 and nvcc")
    if dtype == "float32" and Dq == 576:
        pytest.skip("float32 at Dq 576 fits no block (the kernel refuses it)")
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    g = torch.Generator(device="cuda").manual_seed(2)
    q = torch.randn((B, 1, H, Dq), generator=g, device="cuda").to(tdt)
    k = torch.randn((B, S, Hkv, Dq), generator=g, device="cuda").to(tdt)
    v = k[..., :Dv] if mla else torch.randn((B, S, Hkv, Dv), generator=g, device="cuda").to(tdt)
    kv_len = torch.tensor(kvl, dtype=torch.int32, device="cuda")
    n = decode_attention.launches
    out, lse = decode_attention.flash_decode(q, k, v, kv_len=kv_len, return_lse=True)
    assert decode_attention.launches == n + 1
    assert torch.equal(out, decode_attention.flash_decode(q, k, v, kv_len=kv_len))
    _, want = ref.attention(q.float(), k.float(), v.float(), causal=False, kv_len=kvl,
                            return_lse=True)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (B, 1, H)
    if kvl == 0:
        assert bool(torch.isneginf(lse).all())
        return
    err = ((lse - want).abs() / want.abs().clamp(min=1.0)).max().item()
    assert err <= LSE_TOL[dtype], err
