"""The port's MLA (``models/attention.py``) against the reference's, on the
CPU, in float32 within 2e-5: the expanded prefill (``mla_full``) and the
absorbed decode (``mla_decode``) against ``impl="xla"``, and against the
reference's own ``flash_decode`` (Pallas, interpret mode) called with the
scale as a float, which its MLA decode cannot do (ROADMAP §3 fault 9)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs.base import get_config as jax_get_config, reduced as jax_reduced
from repro.kernels import decode_attention as JDA
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs.base import get_config, reduced
from repro_torch.kernels import ref
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.utils.tree import tree_map

TOL = 2e-5
ARCH = "deepseek-v3-671b"


def _setup(seed=0, **kw):
    cfg_j = jax_reduced(jax_get_config(ARCH)).replace(**kw)
    cfg = reduced(get_config(ARCH)).replace(**kw)
    tree = jax.tree_util.tree_map(np.asarray, JL.materialize(
        JA.mla_spec(cfg_j), jax.random.PRNGKey(seed), jnp.float32))
    return cfg_j, cfg, tree, tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("q_lora", [True, False], ids=["q_lora", "direct_q"])
def test_mla_full_matches_reference(q_lora):
    kw = {} if q_lora else {"q_lora_rank": 0}
    cfg_j, cfg, tree, p = _setup(**kw)
    assert ("wq_b" in tree) == q_lora and ("wq" in tree) != q_lora
    B, S = 2, 24
    x = np.random.default_rng(1).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    out_j, ckv_j = JA.mla_full(jax.tree_util.tree_map(jnp.asarray, tree), cfg_j,
                               jnp.asarray(x), jnp.asarray(pos), impl="xla")
    out, ckv = A.mla_full(p, cfg, torch.from_numpy(x), torch.from_numpy(pos.copy()))
    assert tuple(ckv.shape) == (B, S, cfg.mla_cache_dim)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(ckv.numpy(), np.asarray(ckv_j), rtol=0, atol=TOL)


def _decode_inputs(cfg, B=2, Smax=32, t=19, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    cache = rng.standard_normal((B, Smax, cfg.mla_cache_dim)).astype(np.float32)
    cache[:, t:] = 0.0
    return x, cache, t


def test_mla_decode_matches_reference():
    cfg_j, cfg, tree, p = _setup()
    x, cache, t = _decode_inputs(cfg)
    out_j, cache_j = JA.mla_decode(jax.tree_util.tree_map(jnp.asarray, tree), cfg_j,
                                   jnp.asarray(x), jnp.asarray(cache), jnp.int32(t), impl="xla")
    ct = torch.from_numpy(cache.copy())
    out, ct2 = A.mla_decode(p, cfg, torch.from_numpy(x), ct, torch.tensor(t, dtype=torch.int32))
    assert ct2 is ct                                        # updated in place
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cache_j), rtol=0, atol=TOL)


def test_mla_scale_is_the_float32_value():
    cfg = get_config(ARCH)
    assert cfg.qk_head_dim == 192
    s = A.mla_scale(cfg)
    assert isinstance(s, float)
    assert s == float(np.float32(1) / np.sqrt(np.float32(192)))
    assert s != 1.0 / np.sqrt(192.0)                        # the float64 value's last bits


def test_reference_mla_decode_pallas_scale_is_unhashable():
    """Fault 9: the reference's MLA decode passes its scale as a jax array to
    ``flash_decode``, whose ``scale`` is static, so its Pallas path cannot
    run.  The port's absorbed decode equals that kernel called directly
    with the scale as a float, and ``impl="xla"``."""
    cfg_j, cfg, tree, p = _setup()
    mcfg_j = jax_reduced(jax_get_config(ARCH))
    params_j = JM.init_params(mcfg_j, jax.random.PRNGKey(0))
    cache0 = JM.init_cache(mcfg_j, 2, 32)
    with pytest.raises(ValueError, match="Non-hashable static arguments"):
        JM.decode_step(params_j, mcfg_j, jnp.zeros((2,), jnp.int32), cache0,
                       impl="pallas_interpret")

    x, cache, t = _decode_inputs(cfg)
    R = cfg.kv_lora_rank
    captured = {}
    attention = A.ops.attention

    def capture(q, k, v, **kw):
        captured.update(q=q.clone(), k=k.clone(), v=v.clone(), kw=kw)
        return attention(q, k, v, **kw)

    A.ops.attention = capture
    try:
        A.mla_decode(p, cfg, torch.from_numpy(x), torch.from_numpy(cache.copy()),
                     torch.tensor(t, dtype=torch.int32))
    finally:
        A.ops.attention = attention
    q, k, v, kw = captured["q"], captured["k"], captured["v"], captured["kw"]
    assert tuple(q.shape) == (2, 1, cfg.num_heads, R + cfg.qk_rope_head_dim)
    assert tuple(k.shape) == (2, 32, 1, R + cfg.qk_rope_head_dim)
    assert torch.equal(v, k[..., :R]) and kw["decode"] and isinstance(kw["scale"], float)
    want = JDA.flash_decode(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                            jnp.asarray(v.contiguous().numpy()), kv_len=t + 1,
                            scale=kw["scale"], interpret=True)
    got = ref.attention(q, k, v, causal=False, kv_len=t + 1, scale=kw["scale"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)

    out_j, _ = JA.mla_decode(jax.tree_util.tree_map(jnp.asarray, tree), cfg_j, jnp.asarray(x),
                             jnp.asarray(cache), jnp.int32(t), impl="xla")
    out, _ = A.mla_decode(p, cfg, torch.from_numpy(x), torch.from_numpy(cache.copy()),
                          torch.tensor(t, dtype=torch.int32))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=0, atol=TOL)


def test_mla_cache_layout_matches_reference():
    cfg_j = jax_reduced(jax_get_config(ARCH))
    cfg = reduced(get_config(ARCH))
    got = M.cache_specs(cfg, 3, 40)
    want, _ = JM.cache_specs(cfg_j, 3, 40)
    assert [s.kind for s in M.layer_plan(cfg)] == ["mla_dense", "mla_moe"]
    for i, layers in enumerate((cfg.first_dense_layers, cfg.num_layers - 1)):
        shape, dt = got[f"seg{i}"]["ckv"]
        assert shape == tuple(want[f"seg{i}"]["ckv"].shape) == (layers, 3, 40, 48)
        assert dt == str(want[f"seg{i}"]["ckv"].dtype)
