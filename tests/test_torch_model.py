"""The port's dense model against the reference package's, on the CPU.

Both packages get the same parameters (the reference's ``M.init_params``,
carried over as numpy through ``params_from_numpy``) and the same prompts.
The reference runs its Pallas kernels in interpret mode.  Tokens must be
equal and float32 logits within atol 1e-4: the two frameworks sum the
matrix products and the softmax in different orders, which moves float32
logits of these reduced models by about 1e-6; 1e-4 leaves room for that and
still catches any real difference in the math.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs.base import get_config as jax_get_config, reduced as jax_reduced
from repro.models import model as JM
from repro.utils.tree import flatten_with_names as jax_flatten
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import model as M
from repro_torch.utils.tree import flatten_with_names

ATOL = 1e-4
ARCHS = ["qwen2-0.5b", "llama3.2-1b", "qwen3-4b", "granite-8b"]


def _params(arch, seed=0):
    cfg_j = jax_reduced(jax_get_config(arch))
    tree = jax.tree_util.tree_map(np.asarray, JM.init_params(cfg_j, jax.random.PRNGKey(seed)))
    cfg = reduced(get_config(arch))
    return cfg_j, cfg, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode_match_reference(arch):
    cfg_j, cfg, tree = _params(arch)
    model = M.params_from_numpy(cfg, tree, "cpu")
    params_j = jax.tree_util.tree_map(jnp.asarray, tree)
    B, S, max_seq, steps = 2, 16, 32, 8
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)

    lj, cache_j = JM.prefill(params_j, cfg_j, {"tokens": jnp.asarray(tokens)}, max_seq,
                             impl="pallas_interpret")
    lt, cache_t = M.prefill(model, cfg, {"tokens": torch.from_numpy(tokens)}, max_seq)
    assert [n for n, _ in jax_flatten(cache_j)] == [n for n, _ in flatten_with_names(cache_t)]
    for (_, a), (_, b) in zip(jax_flatten(cache_j), flatten_with_names(cache_t)):
        assert tuple(a.shape) == tuple(b.shape)
    assert cache_t["t"].dtype == torch.int32 and cache_t["t"].shape == ()
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=ATOL)

    tok_j = jnp.argmax(lj, axis=-1).astype(jnp.int32)
    tok_t = lt.argmax(-1).to(torch.int32)
    for _ in range(steps):
        np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
        lj, cache_j = JM.decode_step(params_j, cfg_j, tok_j, cache_j, impl="pallas_interpret")
        lt, cache_t = M.decode_step(model, cfg, tok_t, cache_t)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=ATOL)
        tok_j = jnp.argmax(lj, axis=-1).astype(jnp.int32)
        tok_t = lt.argmax(-1).to(torch.int32)
    assert int(cache_t["t"]) == S + steps == int(cache_j["t"])
    for (_, a), (_, b) in zip(jax_flatten(cache_j), flatten_with_names(cache_t)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    cfg_j, cfg, tree = _params(arch)
    model = M.params_from_numpy(cfg, tree, "cpu")
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    h_j, _, _ = JM.forward_full(jax.tree_util.tree_map(jnp.asarray, tree), cfg_j,
                                {"tokens": jnp.asarray(tokens)}, impl="pallas_interpret")
    want = JM.logits_fn(jax.tree_util.tree_map(jnp.asarray, tree), cfg_j, h_j)
    with torch.no_grad():
        got = model(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_full_width_qwen2_params_match_reference_on_meta():
    """Names, order, shapes and dtype of the full-width tree, without storage."""
    cfg = get_config("qwen2-0.5b")
    got = flatten_with_names(M.abstract_params(cfg))
    want = jax_flatten(JM.abstract_params(jax_get_config("qwen2-0.5b")))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, t), (_, s) in zip(got, want):
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(s.shape), n
        assert str(t.dtype).removeprefix("torch.") == str(s.dtype), n
    assert cfg.param_count() == jax_get_config("qwen2-0.5b").param_count() == 494_032_768


def test_module_parameter_names_are_the_tree_paths():
    cfg = reduced(get_config("qwen2-0.5b"))
    model = M.init_params(cfg, 0, "cpu")
    names = sorted(n.replace(".", "/") for n, _ in model.named_parameters())
    assert names == sorted(n for n, _ in flatten_with_names(M.params_tree(model)))
    assert "seg0/attn/wq/b" in names and "embed/table" in names
    assert model.seg0.attn.wq.w.shape == (cfg.num_layers, cfg.d_model,
                                          cfg.num_heads * cfg.head_dim)


def test_init_depends_only_on_seed_and_path():
    cfg = reduced(get_config("llama3.2-1b"))
    a = flatten_with_names(M.params_tree(M.init_params(cfg, 3, "cpu")))
    b = flatten_with_names(M.params_tree(M.init_params(cfg, 3, "cpu")))
    c = flatten_with_names(M.params_tree(M.init_params(cfg, 4, "cpu")))
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b))
    tree = dict(a)
    assert not torch.equal(tree["embed/table"], dict(c)["embed/table"])
    # per-leaf generators: leaves of one shape still differ by path
    assert not torch.equal(tree["seg0/ffn/gate/w"], tree["seg0/ffn/up/w"])


def test_params_from_numpy_refuses_a_foreign_tree():
    cfg = reduced(get_config("qwen2-0.5b"))
    with pytest.raises(ValueError, match="does not match"):
        M.params_from_numpy(cfg, {"embed": {"table": np.zeros((3, 3), np.float32)}}, "cpu")


def test_unported_families_raise():
    with pytest.raises(NotImplementedError):
        M.param_specs(reduced(get_config("qwen2-0.5b")).replace(mixer="mla"))


@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-8b"])
def test_full_width_dense_params_match_reference_on_meta(arch):
    """The head-dim-128 archs: names, shapes and dtype of the full-width tree,
    the untied head the reference builds, and qwen3's per-head q/k norms."""
    cfg, cfg_j = get_config(arch), jax_get_config(arch)
    got = flatten_with_names(M.abstract_params(cfg))
    want = jax_flatten(JM.abstract_params(cfg_j))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, t), (_, s) in zip(got, want):
        assert tuple(t.shape) == tuple(s.shape), n
        assert str(t.dtype).removeprefix("torch.") == str(s.dtype), n
    names = dict(got)
    assert ("head" in names) == (not cfg_j.tie_embeddings)
    assert ("seg0/attn/q_norm/scale" in names) == cfg_j.qk_norm
    if cfg_j.qk_norm:
        assert tuple(names["seg0/attn/q_norm/scale"].shape) == (cfg.num_layers, 128)


def test_qk_norm_at_head_dim_128_matches_reference():
    """qwen3's q/k norms at the full head dim of 128 and its grouping of 4
    (32 query / 8 KV heads at full width), which ``reduced()`` narrows to 32."""
    shape = dict(head_dim=128, num_heads=8, num_kv_heads=2, num_layers=2)
    cfg_j = jax_reduced(jax_get_config("qwen3-4b")).replace(**shape)
    cfg = reduced(get_config("qwen3-4b")).replace(**shape)
    tree = jax.tree_util.tree_map(np.asarray, JM.init_params(cfg_j, jax.random.PRNGKey(5)))
    model = M.params_from_numpy(cfg, tree, "cpu")
    params_j = jax.tree_util.tree_map(jnp.asarray, tree)
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    lj, cache_j = JM.prefill(params_j, cfg_j, {"tokens": jnp.asarray(tokens)}, 16,
                             impl="pallas_interpret")
    lt, cache_t = M.prefill(model, cfg, {"tokens": torch.from_numpy(tokens)}, 16)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=ATOL)
    tok = np.array(jnp.argmax(lj, axis=-1).astype(jnp.int32))
    lj, _ = JM.decode_step(params_j, cfg_j, jnp.asarray(tok), cache_j, impl="pallas_interpret")
    lt, _ = M.decode_step(model, cfg, torch.from_numpy(tok), cache_t)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=ATOL)
