"""The port's MoE FFN (``models/moe.py``) against the reference's, on the CPU.

Same parameters (the reference's initialiser, carried over as numpy) and
the same inputs from a numpy seed.  Where no expert overflows, the two
compute the same function and agree within 1e-5 in float32; where one does,
the reference erases a routed token (ROADMAP §3 fault 8) and the port
follows a plain per-token oracle instead.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs.base import get_config as jax_get_config, reduced as jax_reduced
from repro.models import layers as JL
from repro.models import moe as JMOE
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import moe as MOE
from repro_torch.utils.tree import tree_map

TOL = 1e-5


def _setup(arch="granite-moe-3b-a800m", seed=0, **kw):
    cfg_j = jax_reduced(jax_get_config(arch)).replace(**kw)
    cfg = reduced(get_config(arch)).replace(**kw)
    spec = JMOE.moe_spec(cfg_j)
    tree = jax.tree_util.tree_map(np.asarray, JL.materialize(spec, jax.random.PRNGKey(seed),
                                                             jnp.float32))
    return cfg_j, cfg, tree, tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _no_overflow(cfg, x, p, moe_groups):
    """Whether every routed entry fits its expert's capacity (the port's own
    slot assignment, which equals the reference's when nothing drops)."""
    B, S, D = x.shape
    T = B * S
    G = MOE.groups(T, moe_groups)
    C = MOE.capacity(T // G, cfg)
    _, top_e, _ = MOE.route(p["router"], cfg, x.reshape(G, T // G, D))
    _, valid, _, _ = MOE.assign_slots(top_e.reshape(G, -1), cfg.num_experts, C,
                                      cfg.num_experts_per_tok)
    return bool(valid.all())


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-v3-671b"])
@pytest.mark.parametrize("moe_groups", [1, 16])
def test_moe_ffn_matches_reference(arch, moe_groups):
    cfg_j, cfg, tree, p = _setup(arch)
    x = np.random.default_rng(1).standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    assert _no_overflow(cfg, torch.from_numpy(x), p, moe_groups)
    want, aux_j = JMOE.moe_ffn(jax.tree_util.tree_map(jnp.asarray, tree), cfg_j,
                               jnp.asarray(x), moe_groups)
    got, aux = MOE.moe_ffn(p, cfg, torch.from_numpy(x), moe_groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=TOL, atol=1e-9)
    assert ("shared" in tree) == bool(cfg.num_shared_experts)


def test_int8_dispatch_matches_reference():
    """``moe_dispatch_bits=8``: the int8 round trip of the dispatched tokens,
    the quantiser alone and inside the FFN, and its straight-through
    gradient."""
    cfg_j, cfg, tree, p = _setup(moe_dispatch_bits=8)
    rng = np.random.default_rng(2)
    xe = rng.standard_normal((1, 8, 16, cfg.d_model)).astype(np.float32)
    want = JMOE._quant_transport(jnp.asarray(xe), (None, "expert", None, "embed"), "float32")
    got = MOE.quant_transport(torch.from_numpy(xe))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-7)
    assert not np.array_equal(got.numpy(), xe)              # it does round

    xt = torch.from_numpy(xe).requires_grad_()
    g = torch.from_numpy(rng.standard_normal(xe.shape).astype(np.float32))
    (dx,) = torch.autograd.grad(MOE.quant_transport(xt), xt, g)
    assert torch.equal(dx, g)

    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    assert _no_overflow(cfg, torch.from_numpy(x), p, 1)
    want, _ = JMOE.moe_ffn(jax.tree_util.tree_map(jnp.asarray, tree), cfg_j, jnp.asarray(x), 1)
    got, _ = MOE.moe_ffn(p, cfg, torch.from_numpy(x), 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def _oracle(p, cfg, x):
    """Each token's top-k experts in token-major routing order, an entry
    dropped once its expert holds ``capacity`` entries: the plain
    per-token definition of capacity routing, one group."""
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    T = xt.shape[0]
    C = MOE.capacity(T, cfg)
    probs = torch.softmax(xt @ p["router"], dim=-1)
    top_p, top_e = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    used = [0] * cfg.num_experts
    out = torch.zeros_like(xt)
    for t in range(T):
        for k in range(cfg.num_experts_per_tok):
            e = int(top_e[t, k])
            if used[e] >= C:
                continue
            used[e] += 1
            h = torch.nn.functional.silu(xt[t] @ p["wi_gate"][e]) * (xt[t] @ p["wi_up"][e])
            out[t] += top_p[t, k] * (h @ p["wo"][e])
    return out.reshape(B, S, D), C


def test_reference_moe_overflow_erases_slot_zero_port_does_not():
    """Fault 8: 12 tokens, all routed to expert 0 of 2 (top-1), capacity 8.
    The reference writes the 4 overflowing entries to slot 0 as empty, so
    token 0 loses its expert; the port keeps token 0 and drops only tokens
    8-11, as the oracle does."""
    cfg_j, cfg, tree, _ = _setup(num_experts=2, num_experts_per_tok=1)
    router = np.zeros_like(tree["router"])
    router[0] = [4.0, -4.0]                  # a positive first coordinate picks expert 0
    tree = {**tree, "router": router}
    p = tree_map(lambda a: torch.from_numpy(np.array(a)), tree)
    x = np.random.default_rng(3).standard_normal((1, 12, cfg.d_model)).astype(np.float32)
    x[..., 0] = np.abs(x[..., 0]) + 1.0
    xt = torch.from_numpy(x)

    oracle, C = _oracle(p, cfg, xt)
    assert C == 8
    o = oracle.numpy()[0]
    assert np.all(np.abs(o[:8]).max(-1) > 1e-3) and np.all(o[8:] == 0)   # 8 kept, 4 dropped

    want, _ = JMOE.moe_ffn(jax.tree_util.tree_map(jnp.asarray, tree), cfg_j, jnp.asarray(x), 1)
    want = np.asarray(want)[0]
    assert np.all(want[0] == 0), "the reference keeps slot 0's token after all"
    np.testing.assert_allclose(want[1:], o[1:], rtol=0, atol=TOL)

    got, _ = MOE.moe_ffn(p, cfg, xt, 1)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=0, atol=TOL)
    _, valid, slot_tok, filled = MOE.assign_slots(torch.zeros((1, 12), dtype=torch.int64), 2,
                                                  8, 1)
    assert valid[0].tolist() == [True] * 8 + [False] * 4
    assert slot_tok[0, :8].tolist() == list(range(8)) and filled[0, :8].all()
    assert not filled[0, 8:].any()
