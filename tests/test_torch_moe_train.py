"""Training the MoE family (granite-moe-3b-a800m) in the port against the
reference, on the CPU.

1. One AdamW step of reduced granite-moe (2 layers, B2 S16) from the
   reference's ``init_train_state``, at ``moe_groups`` 1 and 2: loss, the
   summed aux loss, every gradient (the router's through the top-k weights,
   the experts' through dispatch, the batched products and combine), the
   grad norm, the new params and moments (tests/torch_train_parity.py has
   the reference side and the tolerances).  The parity configs take a
   capacity factor of 4: at the config's 1.25 an expert of reduced
   granite-moe overflows at every batch tried, and there the reference
   erases a routed token (ROADMAP §3 fault 8), so the two packages differ
   by design.  The test asserts that no routed entry overflowed.
2. Under overflow the port's gradients equal those of a plain per-token
   oracle of capacity routing (fault 8 stays out of the port).
3. The train step routes with one group, as the reference's does on one
   device (fault 11), and sums microbatch gradients in bfloat16 for
   bfloat16 params (fault 10).
4. ``launch.train --arch granite-moe-3b-a800m --reduced``: preempt -> exit
   85 -> requeue -> bit-identical finish; a reference-written MoE train
   state continued by the port's trainer.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.data.pipeline import SyntheticTokens as RefTokens
from repro.optim import adamw as RA
from repro.train import step as RTS
from repro.utils.tree import flatten_with_names as ref_flatten
from repro_torch.configs.base import get_config, reduced
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch import train as T
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.optim import adamw
from repro_torch.train import step as TS
from repro_torch.utils.tree import flatten_with_names, tree_map
from torch_train_parity import (LOSS_RTOL, check_one_step, check_preempt_requeue, close,
                                port_batch, ref_loss_and_grads, ref_step, routed_entries,
                                to_port, train_cli)

ARCH = "granite-moe-3b-a800m"
# no expert overflows at this capacity (asserted); see the module docstring
PARITY = dict(num_layers=2, capacity_factor=4.0)
ATOL_REL = 1e-4         # of a leaf's largest |gradient| (tests/test_torch_ssm_train.py)
LAUNCH_KEYS = ("flash", "ssd", "wkv6", "chunk_fingerprints")


def _cfgs(arch=ARCH, **kw):
    return (reduced(get_config(arch)).replace(**kw),
            ref_reduced(ref_get_config(arch)).replace(**kw))


@pytest.fixture(scope="module")
def ref_init():
    cfg, rcfg = _cfgs(**PARITY)
    oc, roc = (adamw.OptConfig(warmup_steps=1, decay_steps=10),
               RA.OptConfig(warmup_steps=1, decay_steps=10))
    state = RTS.init_train_state(rcfg, roc, jax.random.PRNGKey(0))
    return cfg, rcfg, oc, roc, state, RefTokens(rcfg, 2, 16, seed=1).batch_at(0)


# ---------------------------------------------------------------------------
# 1. one AdamW step against the reference's loss and update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("moe_groups", [1, 2])
def test_one_adamw_step_matches_reference(ref_init, moe_groups):
    cfg, rcfg, oc, roc, state, batch = ref_init
    grads, mets, fits = check_one_step(cfg, rcfg, oc, roc, state, batch,
                                       moe_groups=moe_groups, atol_rel=ATOL_REL)
    assert fits, "an expert overflowed; the packages differ there by design (fault 8)"
    assert mets["aux"] > 0
    for i in range(cfg.num_layers):
        for leaf in ("router", "wi_gate", "wi_up", "wo"):
            assert float(grads[f"seg0/ffn/{leaf}"][i].abs().max()) > 0, (i, leaf)


# ---------------------------------------------------------------------------
# 2. under overflow: the gradients of a per-token oracle
# ---------------------------------------------------------------------------

def _oracle(p, cfg, x):
    """Each token's top-k experts in token-major routing order, an entry
    dropped once its expert holds ``capacity`` entries: the plain
    per-token definition of capacity routing, one group."""
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    T_ = xt.shape[0]
    C = MOE.capacity(T_, cfg)
    probs = torch.softmax(xt @ p["router"], dim=-1)
    top_p, top_e = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    used = [0] * cfg.num_experts
    rows = []
    for t in range(T_):
        row = torch.zeros_like(xt[t])
        for k in range(cfg.num_experts_per_tok):
            e = int(top_e[t, k])
            if used[e] >= C:
                continue
            used[e] += 1
            h = torch.nn.functional.silu(xt[t] @ p["wi_gate"][e]) * (xt[t] @ p["wi_up"][e])
            row = row + top_p[t, k] * (h @ p["wo"][e])
        rows.append(row)
    return torch.stack(rows).reshape(B, S, D), C, used


def test_gradients_under_overflow_equal_a_per_token_oracle():
    cfg = reduced(get_config(ARCH))
    p = L.materialize(MOE.moe_spec(cfg), 0)
    rng = np.random.default_rng(4)
    # a direction shared by every token sends most of them to the same experts
    x = (rng.standard_normal((1, 32, cfg.d_model))
         + 3.0 * rng.standard_normal(cfg.d_model)).astype(np.float32)
    gout = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))

    def grads(fn):
        leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
        xt = torch.from_numpy(x).requires_grad_()
        out = fn(leaves, xt)
        return out, torch.autograd.grad(out, [xt, *leaves.values()], gout)

    with routed_entries() as fits:
        got, g_got = grads(lambda q, xt: MOE.moe_ffn(q, cfg, xt, 1)[0])
    want, g_want = grads(lambda q, xt: _oracle(q, cfg, xt)[0])
    _, C, used = _oracle(p, cfg, torch.from_numpy(x))
    assert fits == [False] and max(used) == C, "the input must overflow an expert"
    # float32, the products summed in other orders: within 1e-5 relative, or
    # 1e-6 of the largest |value| where a value nears 0
    for name, a, b in zip(["out", "x", *p], [got.detach(), *g_got], [want.detach(), *g_want]):
        top = float(b.abs().max())
        assert top > 0, name
        close(a.numpy(), b.numpy(), 1e-5, 1e-6 * top, what=name)


# ---------------------------------------------------------------------------
# 3. the repairs: one routing group in training (fault 11), the microbatch
#    accumulation dtype (fault 10)
# ---------------------------------------------------------------------------

def test_train_step_routes_with_one_group(monkeypatch):
    """The reference's train step passes ``moe_groups = batch_shards``, 1 on
    one device, where ``loss_fn``'s own default is 16.  At the config's
    capacity an expert overflows, so the group count changes the loss: the
    step's loss is ``loss_fn``'s at one group, not at 16."""
    cfg = reduced(get_config(ARCH)).replace(num_layers=2)
    oc = adamw.OptConfig()
    state = TS.init_train_state(cfg, oc, 0, "cpu")
    batch = port_batch(SyntheticTokens(cfg, 2, 16).batch_at(0))
    with torch.no_grad(), routed_entries() as fits:
        at = {g: float(M.loss_fn(state["params"], cfg, batch, moe_groups=g)[0])
              for g in (1, 16)}
    assert not all(fits) and at[1] != at[16]
    seen = []
    loss_fn = M.loss_fn

    def spy(*a, **kw):
        seen.append(kw["moe_groups"])
        return loss_fn(*a, **kw)

    monkeypatch.setattr(M, "loss_fn", spy)
    _, om = TS.make_train_step(cfg, oc)(state, batch)
    assert seen == [1] and float(om["loss"]) == at[1]


def test_microbatch_gradients_accumulate_as_the_reference(monkeypatch):
    """bfloat16 params (deepseek-v3's own dtype), two microbatches: the
    summed gradient is the reference's rule, (g0 + g1) summed in bfloat16,
    divided by 2 in bfloat16, then cast to float32, bit for bit on the
    port's own microbatch gradients and within bfloat16 rounding of the
    reference's; summing in float32 would give other gradients."""
    cfg, rcfg = _cfgs("deepseek-v3-671b", param_dtype="bfloat16", **PARITY)
    oc, roc = adamw.OptConfig(), RA.OptConfig()
    ref_state = RTS.init_train_state(rcfg, roc, jax.random.PRNGKey(0))
    batch = RefTokens(rcfg, 4, 16, seed=2).batch_at(0)
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in batch.items()} for i in range(2)]

    lg = ref_loss_and_grads(rcfg, 1)
    ref_g = [lg(ref_state["params"], h)[1] for h in halves]
    zero = jax.tree_util.tree_map(lambda p: jnp.zeros(p.shape, jnp.bfloat16), ref_g[0])
    acc = jax.tree_util.tree_map(lambda z, a, b: z + a.astype(jnp.bfloat16)
                                 + b.astype(jnp.bfloat16), zero, *ref_g)
    want_ref = dict(ref_flatten(jax.tree_util.tree_map(
        lambda g: np.asarray((g / 2).astype(jnp.float32)), acc)))

    state = to_port(ref_state)
    assert state["params"]["embed"]["table"].dtype == torch.bfloat16
    port_g = [dict(flatten_with_names(TS.loss_and_grads(state["params"], cfg,
                                                        port_batch(h))[2])) for h in halves]
    captured = {}
    apply = adamw.apply_updates

    def capture(params, grads, *a, **kw):
        captured.setdefault("g", dict(flatten_with_names(grads)))
        return apply(params, grads, *a, **kw)

    monkeypatch.setattr(adamw, "apply_updates", capture)
    _, om = TS.make_train_step(cfg, oc, microbatches=2)(to_port(ref_state), port_batch(batch))
    assert np.isfinite(float(om["loss"])) and "mtp_ce" in om and "aux" in om
    differs = 0
    for name, g in captured["g"].items():
        g0, g1 = port_g[0][name], port_g[1][name]
        assert g0.dtype == torch.bfloat16 and g.dtype == torch.float32, name
        assert torch.equal(g, ((g0 + g1) / 2).float()), name
        differs += not torch.equal(g, ((g0.float() + g1.float()) / 2).float())
        # two bfloat16 roundings of gradients that differ by theirs
        close(g.numpy(), want_ref[name], 2 ** -6,
              2 ** -6 * float(np.abs(want_ref[name]).max(initial=0.0)), what=name)
    assert differs, "summing in float32 gave the same gradients"


# ---------------------------------------------------------------------------
# 4. the trainer: preempt -> exit 85 -> requeue; a reference checkpoint
# ---------------------------------------------------------------------------

def test_preempt_requeue_finishes_bit_identical(tmp_path):
    check_preempt_requeue(ARCH, tmp_path, reduced(get_config(ARCH)), adamw.OptConfig(),
                          LAUNCH_KEYS)


def test_reference_moe_checkpoint_continues_in_port(tmp_path, capsys, monkeypatch):
    """The reference's state after one step, saved by its manager, restored
    by ``launch.train`` (the CLI's reduced config at capacity factor 4 in
    both packages, so that no expert overflows): the first step after the
    restore gives the reference's next loss."""
    from repro.checkpoint.manager import CheckpointManager as RefManager
    from repro.checkpoint.manager import CheckpointPolicy as RefPolicy
    from repro.checkpoint.store import TieredStore as RefStore
    from repro.core.manifest import capture_manifest

    monkeypatch.setattr(T, "reduce_cfg", lambda c: reduced(c).replace(capacity_factor=4.0))
    rcfg = ref_reduced(ref_get_config(ARCH)).replace(capacity_factor=4.0)
    roc = RA.OptConfig(lr=3e-4, warmup_steps=10, decay_steps=4)    # as the CLI's
    ref_state = RTS.init_train_state(rcfg, roc, jax.random.PRNGKey(0))
    pipe = RefTokens(rcfg, 2, 16, seed=0)
    lg = ref_loss_and_grads(rcfg, 1)
    ref_state, *_ = ref_step(roc, ref_state, next(pipe), lg)
    host = jax.tree_util.tree_map(np.asarray, ref_state)
    rmgr = RefManager(RefStore(tmp_path / "ckpt"), RefPolicy(delta=True, fingerprint=True))
    rmgr.save(0, host, extra_meta={"next_step": 1, "data_state": pipe.state().to_dict(),
                                   "run_manifest": capture_manifest(rcfg)})
    rmgr.commit(0)
    rmgr.close()
    _, want_loss, want_mets, _, _ = ref_step(roc, ref_state, pipe.batch_at(1), lg)

    with routed_entries() as fits:
        code, out = train_cli(ARCH, tmp_path / "ckpt", tmp_path / "m.json",
                              ["--ckpt-fingerprint"])
    assert fits and all(fits)
    assert code == 0 and out["start_step"] == 1
    assert [st["step"] for st in out["steps"]] == [1, 2, 3]
    close(out["steps"][0]["loss"], want_loss, LOSS_RTOL, what="first loss after restore")
    assert want_mets["aux"] > 0
    printed = capsys.readouterr().out
    assert "[manifest] written by another framework" in printed
    assert "restored checkpoint step=0" in printed
