"""The SSM families' compute over "model" in training: Mamba2 (zamba2's
backbone) and RWKV6 on this rank's heads, zamba2's shared block on its
blocks (``models/ssm.py``, ``models/rwkv.py``, ``models/model.py``'s
``tp_leaves``, ``parallel/tp.py``'s ``sum_over_model`` and ``own_part``), on
gloo CPU ranks (tests/torch_gloo.py) against whole weights, the port at one
rank and the reference's loss.

Inputs: reduced zamba2-1.2b (d_model 128, inner width E 256, state N 16,
head dim P 32 so 8 SSM heads, conv 4; 4 layers = 2 groups of 2 Mamba2
layers and the shared block, GQA 4 heads / 2 kv heads, vocab 512) and
reduced rwkv6-1.6b (d_model 128, head dim 32 so 4 heads, d_ff 256, LoRA 8 /
16, 4 layers, vocab 512).

(a) ``mamba2_full``, ``mamba2_decode``, ``time_mix_full``,
    ``time_mix_decode`` and ``channel_mix`` under ``tp.computing_on_blocks``
    on 2, 4 and 8 ranks of a (1, n) mesh, with the leaves of ``tp_leaves``
    as this rank's blocks of the rules and every other leaf whole, against
    the whole weights (float32): outputs within 1e-5; the input's and every
    leaf's gradient within 1e-5 of its largest |gradient| (``in_proj``,
    ``conv_w``, ``conv_b``, ``norm/scale``, ``A_log``, ``D``, ``dt_bias``,
    ``u``, ``w0``, ``decay_w2``, ``ln_scale``, ``ln_bias`` among them: read
    whole and sliced, their gradients must be summed over "model", and the
    norm's statistic's backward too).  The decode steps hold the SSM state
    as this rank's heads and the conv window whole.  Mamba2 computes on its
    heads at every n (8 heads); with P 64 (4 heads) at 8 ranks every head is
    computed and ``out_proj`` alone is a block.  RWKV6's 4 heads split at 2
    and 4; at 8 the products are blocks of half a head, every head is
    computed whole.  The leaves that start at ones or zeros are moved off
    them, so that a wrong slice shows.  At one rank (no rules) every module
    is the plain path, bit for bit, and counts no product on a block.
(b) Both models at (2, 4), (4, 2) and (1, 8) (one group of eight ranks
    takes the three meshes in turn), four steps of B8 S64 in
    float64 (the parameters the float32 draws, held in float64): step 0's
    gradients (gathered whole) within 1e-5 of each leaf's largest
    |gradient| of the port's at (1, 1), step 0's clip norm within rtol
    1e-5, four losses within 5e-4; the first loss at (2, 4) within 1e-5 of
    the reference's one-device ``loss_fn`` (``impl="xla"``, float32: its
    "auto" scans overflow at S > 64 at these models' init, ROADMAP §3
    faults 5-6).  Float64, because at one rank these models' float32
    gradients stand further than 1e-5 of a leaf's largest |gradient| from
    the float64 ones (a test pins that), so another order of reduction
    alone would move them past the limit.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_config, reduced
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.optim import adamw
from repro_torch.train import step as TS
from repro_torch.utils.tree import flatten_with_names
from torch_gloo import launch, last_json

ARCHS = ["zamba2-1.2b", "rwkv6-1.6b"]
MESHES = ["(2, 4)", "(4, 2)", "(1, 8)"]
B, S, STEPS = 8, 64, 4
OPT = dict(warmup_steps=1, decay_steps=10)
OUT_TOL = 1e-5
GRAD_TOL = 1e-5          # of a leaf's largest |gradient|
LOSS_TOL = 5e-4          # the reference's elastic limit
REF_LOSS_TOL = 1e-5
NORM_RTOL = 1e-5


def config_of(arch, dtype="float32"):
    return reduced(get_config(arch)).replace(param_dtype=dtype, compute_dtype=dtype)


# ---------------------------------------------------------------------------
# (a): the mixers on blocks against whole weights
# ---------------------------------------------------------------------------

_OPS = """
from repro_torch.configs.base import get_config, reduced
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers as L
from repro_torch.models import rwkv as R
from repro_torch.models import ssm as SM
from repro_torch.parallel import tp
from repro_torch.parallel.context import use_mesh_context
from repro_torch.parallel.mesh_rules import Rules
from repro_torch.utils.tree import flatten_with_names, unflatten_like

n = WORLD
rules = Rules(make_mesh((1, n)))
rng = np.random.default_rng(7)        # the same draws on every rank


def T(*shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def leaf(x):
    return x.detach().clone().requires_grad_(True)


errs, products, split = {}, {}, {}


def err(name, got, want, scale=None):
    s = 1.0 if scale is None else max(float(scale), 1e-30)
    errs[name] = max(errs.get(name, 0.0), float((got - want).abs().max()) / s)


def trees(specs, names, seed):
    whole = L.materialize(specs, seed, torch.float32)
    for k, t in flatten_with_names(whole):            # off their ones and zeros
        if specs_init[k] in ("ones", "zeros"):
            t.add_(0.3 * T(*t.shape))
    sl = {k: rules.local_slices(s.axes, s.shape) if k in names else
          tuple(slice(None) for _ in s.shape) for k, s in flatten_with_names(specs)}
    blk = unflatten_like(whole, {k: t[sl[k]].clone() for k, t in flatten_with_names(whole)})
    return whole, blk, sl


def full(tag, fn, specs, names, seed, x):
    global specs_init
    specs_init = {k: s.init for k, s in flatten_with_names(specs)}
    whole, blk, sl = trees(specs, names, seed)
    split[tag] = sorted(k for k, t in flatten_with_names(blk)
                        if tuple(t.shape) != tuple(dict(flatten_with_names(whole))[k].shape))
    g = T(*x.shape)

    def run(tree):
        leaves = {k: leaf(t) for k, t in flatten_with_names(tree)}
        xr = leaf(x)
        out = fn(unflatten_like(tree, leaves), xr)
        out.backward(g)
        return out, xr.grad, {k: t.grad for k, t in leaves.items()}

    with use_mesh_context(rules.mesh, rules), tp.computing_on_blocks():
        out_w, gx_w, grads_w = run(whole)
        tp.COUNTS["block_products"] = 0
        out_b, gx_b, grads_b = run(blk)
        products[tag] = tp.COUNTS["block_products"]
    err(f"{tag} forward", out_b, out_w)
    err(f"{tag} input backward", gx_b, gx_w, gx_w.abs().max())
    for k, gb in grads_b.items():
        err(f"{tag} backward {k}", gb, grads_w[k][sl[k]], grads_w[k].abs().max())
    return whole, blk


def decode(tag, fn, whole, blk, states, heads_dim):
    # states: whole decode states; the one at heads_dim is held as this
    # rank's heads where the mixer computes on them
    x1 = T(2, 1, 128)
    with torch.no_grad(), use_mesh_context(rules.mesh, rules), tp.computing_on_blocks():
        out_w, new_w = fn(whole, x1, *[s.clone() for s in states])
        tp.COUNTS["block_products"] = 0
        h = states[heads_dim].shape[1]
        own = tp.block_shape(("batch", "ssm_heads_dim", None, None),
                             tuple(states[heads_dim].shape))[1]
        r = tp.model_rank_size()[0] if own != h else 0
        mine = [s.clone() if i != heads_dim else s[:, r * own:(r + 1) * own].clone()
                for i, s in enumerate(states)]
        out_b, new_b = fn(blk, x1, *mine)
        products[tag] = tp.COUNTS["block_products"]
    err(f"{tag} forward", out_b, out_w)
    for i, (nb, nw) in enumerate(zip(new_b, new_w)):
        if i == heads_dim:
            nw = nw[:, r * own:(r + 1) * own]
        err(f"{tag} state {i}", nb, nw, nw.abs().max())
    split[tag] = own != h


for tag, cfg in (("mamba2", reduced(get_config("zamba2-1.2b"))),
                 ("mamba2 P64", reduced(get_config("zamba2-1.2b")).replace(ssm_head_dim=64))):
    E, N, H, P, W = SM._dims(cfg)
    specs = SM.mamba2_spec(cfg)
    whole, blk = full(tag, lambda p, x: SM.mamba2_full(p, cfg, x)[0], specs, {"out_proj/w"},
                      11, T(2, 40, cfg.d_model))
    decode(f"{tag} decode", lambda p, x, c, s: SM.mamba2_decode(p, cfg, x, c, s), whole, blk,
           [T(2, W - 1, E + 2 * N), 0.5 * T(2, H, P, N)], 1)

cfg = reduced(get_config("rwkv6-1.6b"))
D, H, Dh = cfg.d_model, cfg.d_model // cfg.head_dim, cfg.head_dim
whole, blk = full("time_mix", lambda p, x: R.time_mix_full(p, cfg, x)[0], R.time_mix_spec(cfg),
                  {f"{k}/w" for k in ("wr", "wk", "wv", "wg", "wo")}, 12, T(2, 24, D))
decode("time_mix decode", lambda p, x, xp, s: R.time_mix_decode(p, cfg, x, xp, s), whole, blk,
       [T(2, D), 0.5 * T(2, H, Dh, Dh)], 1)
full("channel_mix", lambda p, x: R.channel_mix(p, cfg, x), R.channel_mix_spec(cfg),
     {"wk/w", "wv/w"}, 13, T(2, 24, D))
if RANK == 0:
    print(json.dumps({"errs": errs, "products": products, "split": split}))
"""

# products on a block a call: Mamba2 on its heads in_proj's and out_proj's,
# out_proj's alone where it computes every head; the time-mix's wr, wk, wv,
# wg, wo and, on its heads, the decay LoRA's second product; the
# channel-mix's wk and wv
_PRODUCTS = {2: {"mamba2": 2, "mamba2 P64": 2, "time_mix": 6, "channel_mix": 2},
             4: {"mamba2": 2, "mamba2 P64": 2, "time_mix": 6, "channel_mix": 2},
             8: {"mamba2": 2, "mamba2 P64": 1, "time_mix": 5, "channel_mix": 2}}


@pytest.mark.parametrize("world", [2, 4, 8])
def test_ssm_mixers_on_blocks_match_whole_weights(world, tmp_path):
    """(a) on ranks."""
    rep = last_json(launch(_OPS, world, tmp_path)[0])
    errs, products, split = rep["errs"], rep["products"], rep["split"]
    assert split["mamba2"] == split["mamba2 P64"] == ["out_proj/w"]
    assert split["time_mix"] == ["wg/w", "wk/w", "wo/w", "wr/w", "wv/w"]
    assert split["channel_mix"] == ["wk/w", "wv/w"]
    # the SSM state is this rank's heads where the heads split
    assert split["mamba2 decode"] is True
    assert split["mamba2 P64 decode"] is (world != 8)
    assert split["time_mix decode"] is (world != 8)
    for tag, want in _PRODUCTS[world].items():
        assert products[tag] == want, (tag, products)
        if tag + " decode" in products:
            assert products[tag + " decode"] == want, (tag, products)
    leaves = {"in_proj/w", "conv_w", "conv_b", "norm/scale", "A_log", "D", "dt_bias",
              "out_proj/w", "u", "w0", "decay_w2", "ln_scale", "ln_bias", "wk/w", "wv/w"}
    assert leaves <= {k.split(" backward ")[1] for k in errs if " backward " in k}
    for name, e in errs.items():          # sums in another order
        assert e <= OUT_TOL, (name, e)


def test_ssm_mixers_at_one_rank_are_the_plain_path():
    """(a) at one rank: no rules, every leaf whole."""
    from repro_torch.models import layers as L
    from repro_torch.models import rwkv as R
    from repro_torch.models import ssm as SM
    from repro_torch.parallel import tp

    rng = np.random.default_rng(2)

    def T(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    zc, rc = config_of("zamba2-1.2b"), config_of("rwkv6-1.6b")
    E, N, H, P, W = SM._dims(zc)
    pm = L.materialize(SM.mamba2_spec(zc), 11, torch.float32)
    pt = L.materialize(R.time_mix_spec(rc), 12, torch.float32)
    pc = L.materialize(R.channel_mix_spec(rc), 13, torch.float32)
    x = T(2, 8, 128)
    conv, ssm, xp, wkv = T(2, W - 1, E + 2 * N), T(2, H, P, N), T(2, 128), T(2, 4, 32, 32)

    def calls():
        return [SM.mamba2_full(pm, zc, x, want_state=True),
                SM.mamba2_decode(pm, zc, x[:, :1], conv, ssm),
                R.time_mix_full(pt, rc, x, want_state=True),
                R.time_mix_decode(pt, rc, x[:, :1], xp, wkv),
                R.channel_mix(pc, rc, x)]

    want = calls()
    tp.COUNTS["block_products"] = 0
    with tp.computing_on_blocks():
        got = calls()
    assert tp.COUNTS["block_products"] == 0
    flat = lambda t: [t] if isinstance(t, torch.Tensor) else [z for e in t for z in flat(e)]
    for w, g in zip(flat(want), flat(got)):
        assert torch.equal(w, g)


# ---------------------------------------------------------------------------
# (b): training on gloo ranks against the port at one rank and the reference
# ---------------------------------------------------------------------------

_RANK = f"S = {S}\n" + """
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

work = ARGS[0]
meshes, archs, steps = json.loads(ARGS[1])
oc = adamw.OptConfig(**json.loads(ARGS[2]))
captured = []
apply_updates = adamw.apply_updates


def capture(params, grads, *a, **kw):
    if not captured:
        captured.append(grads)
    return apply_updates(params, grads, *a, **kw)


adamw.apply_updates = capture
report = {}
for mesh, arch in [(m, a) for m in meshes for a in archs]:
    rules = Rules(make_mesh(eval(mesh)))
    cfg = reduced(get_config(arch)).replace(param_dtype="float64", compute_dtype="float64")
    pipe = SyntheticTokens(cfg, 8, S, seed=5)
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
        np.savez(f"{work}/{arch}-{eval(mesh)[0]}x{eval(mesh)[1]}.npz", **whole)
    report[f"{mesh}|{arch}"] = {"losses": losses, "grad_norm": norms[0],
                                "block_products": tp.COUNTS["block_products"]}
if RANK == 0:
    print(json.dumps(report))
"""


def _one_rank(arch, dtype="float64"):
    """(losses, step 0's gradients, step 0's clip norm) of the port at (1, 1)."""
    cfg = config_of(arch, dtype)
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
    return losses, {n: g.double().numpy() for n, g in flatten_with_names(captured[0])}, norms[0]


@pytest.fixture(scope="module")
def one_rank():
    return {arch: _one_rank(arch) for arch in ARCHS}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(the rank-0 report, the folder of its gradients) of one group of eight
    ranks that trains both models at each mesh in turn."""
    work = tmp_path_factory.mktemp("ssm-ranks")
    outs = launch(_RANK, 8, work, work, json.dumps([MESHES, ARCHS, STEPS]), json.dumps(OPT),
                  timeout=400)
    return last_json(outs[0]), work


def _grad_errors(have, want_grads) -> dict:
    """{leaf: (error, largest |gradient|)} of the leaves off by more than
    GRAD_TOL of their largest |gradient|."""
    bad = {}
    for n, w in want_grads.items():
        e, scale = float(np.abs(have[n] - w).max(initial=0.0)), \
            float(np.abs(w).max(initial=0.0))
        if e > GRAD_TOL * max(scale, 1e-30):
            bad[n] = (e, scale)
    return bad


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_training_on_model_blocks_matches_one_rank(mesh, arch, ranks, one_rank):
    """(b)."""
    rep, work = ranks
    got = rep[f"{mesh}|{arch}"]
    want_losses, want_grads, want_norm = one_rank[arch]
    assert got["block_products"] > 0
    assert abs(got["grad_norm"] - want_norm) <= NORM_RTOL * want_norm, \
        (got["grad_norm"], want_norm)
    m = eval(mesh)
    have = np.load(work / f"{arch}-{m[0]}x{m[1]}.npz")
    assert sorted(have.files) == sorted(want_grads)
    bad = _grad_errors(have, want_grads)
    assert not bad, bad
    assert np.abs(np.array(got["losses"]) - np.array(want_losses)).max() <= LOSS_TOL, \
        (got["losses"], want_losses)


@pytest.mark.parametrize("arch", ARCHS)
def test_first_loss_at_2x4_matches_the_reference_loss_fn(arch, ranks):
    """(b), the reference."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs.base import get_config as ref_get_config
    from repro.configs.base import reduced as ref_reduced
    from repro.models import model as RM

    rep, _ = ranks
    cfg = config_of(arch)
    rcfg = ref_reduced(ref_get_config(arch))
    params = TS.init_train_state(cfg, adamw.OptConfig(**OPT), 3, "cpu")["params"]
    tree = _nest({n: jnp.asarray(x.numpy()) for n, x in flatten_with_names(params)})
    assert all(x.dtype == jnp.float32 for x in jax.tree_util.tree_leaves(tree))
    batch = {k: jnp.asarray(v) for k, v in SyntheticTokens(cfg, B, S, seed=5).batch_at(0).items()}
    want, _ = jax.jit(lambda p, b: RM.loss_fn(p, rcfg, b, moe_groups=1, z_loss=1e-4,
                                              impl="xla"))(tree, batch)
    got = rep[f"(2, 4)|{arch}"]["losses"][0]
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


@pytest.mark.parametrize("arch", ARCHS)
def test_float32_gradients_at_one_rank_are_not_good_to_the_limit(arch, one_rank):
    """(b)'s float64: at one rank, the float32 gradients of step 0 stand
    further from the float64 ones (``one_rank``'s) than GRAD_TOL of a leaf's
    largest |gradient|, so two float32 evaluations in different orders
    cannot be held to it."""
    cfg = config_of(arch)
    params = TS.init_train_state(cfg, adamw.OptConfig(**OPT), 3, "cpu")["params"]
    batch = SyntheticTokens(cfg, B, S, seed=5).batch_at(0)
    _, _, g = TS.loss_and_grads(params, cfg, {k: torch.from_numpy(v) for k, v in
                                              batch.items()}, z_loss=1e-4, moe_groups=1)
    g32 = {n: x.double().numpy() for n, x in flatten_with_names(g)}
    g64 = one_rank[arch][1]
    worst = max(float(np.abs(g32[n] - w).max(initial=0.0)) / max(float(np.abs(w).max(
        initial=0.0)), 1e-30) for n, w in g64.items())
    assert worst > GRAD_TOL, worst
