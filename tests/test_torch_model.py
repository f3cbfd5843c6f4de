"""The port's models against the reference package's, on the CPU.

Both packages get the same parameters (the reference's ``M.init_params``,
carried over as numpy through ``params_from_numpy``) and the same prompts.
The reference runs its Pallas kernels in interpret mode, except for the MoE,
MLA, codebook and image-token plans, which it runs at ``impl="xla"`` (its
MLA decode cannot reach its Pallas kernel: ROADMAP §3 fault 9).  Tokens must be
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
# the MoE, MLA (with MTP params), codebook and image-token plans
PLAN_ARCHS = ["granite-moe-3b-a800m", "deepseek-v3-671b", "musicgen-large",
              "llava-next-mistral-7b"]


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


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-1.6b", "llama3.2-1b"])
def test_init_draws_each_leaf_from_its_own_generator(arch):
    """The leaves are drawn on a pool of threads: each equals the serial draw
    from its own generator, whatever order the pool ran them in."""
    from repro_torch.models import layers as L
    from repro_torch.utils.tree import tree_map_with_path

    cfg = reduced(get_config(arch))
    specs = M.param_specs(cfg)
    got = dict(flatten_with_names(L.materialize(specs, 5, torch.float32, "cpu")))
    want = {}
    tree_map_with_path(lambda path, spec: want.setdefault(path, L._init_leaf(
        torch.Generator().manual_seed(L.leaf_seed(5, path)), spec, torch.float32)), specs)
    assert list(got) == list(want)
    assert all(torch.equal(got[n], want[n]) for n in want)


def test_a_large_leaf_is_drawn_in_slices(monkeypatch):
    """A leaf over ``SLICE_ABOVE`` elements (deepseek-v3's stacked experts at
    full width) is drawn in slices along its leading dimensions, slice i
    from its own generator; smaller leaves keep their one-generator draw."""
    from repro_torch.models import layers as L
    from repro_torch.utils.tree import tree_map_with_path

    cfg = reduced(get_config("deepseek-v3-671b"))
    specs = M.param_specs(cfg)
    monkeypatch.setattr(L, "SLICE_ABOVE", 20_000)
    monkeypatch.setattr(L, "SLICE_ELEMS", 4_096)
    got = dict(flatten_with_names(L.materialize(specs, 5, torch.float32, "cpu")))
    n_sliced = 0

    def serial(path, spec):
        nonlocal n_sliced
        if int(np.prod(spec.shape)) <= 20_000 or len(spec.shape) <= 2:
            want = L._init_leaf(torch.Generator().manual_seed(L.leaf_seed(5, path)), spec,
                                torch.float32)
            assert torch.equal(got[path], want), path
            return
        n_sliced += 1
        idxs, k = L.leaf_slices(spec.shape)
        sub = L.ParamSpec(spec.shape[k:], spec.axes[k:], spec.init, spec.scale)
        assert 0 < k <= len(spec.shape) - 2 and len(idxs) == int(np.prod(spec.shape[:k]))
        for i, idx in enumerate(idxs):
            want = L._init_leaf(torch.Generator().manual_seed(L.leaf_seed(5, f"{path}#{i}")),
                                sub, torch.float32)
            assert torch.equal(got[path][idx], want), (path, i)

    tree_map_with_path(serial, specs)
    assert n_sliced >= 3                     # the stacked experts' wi_gate, wi_up, wo
    # the slices' std is the whole leaf's: fan_in is the same second-last dim
    w = got["seg1/ffn/wi_gate"]
    assert abs(float(w.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.05


def test_params_from_numpy_refuses_a_foreign_tree():
    cfg = reduced(get_config("qwen2-0.5b"))
    with pytest.raises(ValueError, match="does not match"):
        M.params_from_numpy(cfg, {"embed": {"table": np.zeros((3, 3), np.float32)}}, "cpu")


def _plan_inputs(cfg, B, S, seed):
    """Prompts for ``cfg``'s plan: (B,S) tokens, (B,S,K) with codebooks, and
    image embeddings over the first positions for an image-token model."""
    rng = np.random.default_rng(seed)
    shape = (B, S, cfg.num_codebooks) if cfg.num_codebooks else (B, S)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(np.int32)}
    if cfg.num_image_tokens:
        batch["image_embeds"] = rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", PLAN_ARCHS)
def test_plan_prefill_and_greedy_decode_match_reference(arch):
    """Prefill (image embeddings in llava's batch) and 8 greedy decode steps:
    equal tokens, logits and caches within ATOL, against ``impl="xla"``."""
    cfg_j, cfg, tree = _params(arch)
    model = M.params_from_numpy(cfg, tree, "cpu")
    params_j = jax.tree_util.tree_map(jnp.asarray, tree)
    B, S, max_seq, steps = 2, 20, 32, 8
    batch = _plan_inputs(cfg, B, S, 1)

    lj, cache_j = JM.prefill(params_j, cfg_j, {k: jnp.asarray(v) for k, v in batch.items()},
                             max_seq, impl="xla")
    lt, cache_t = M.prefill(model, cfg, {k: torch.from_numpy(v) for k, v in batch.items()},
                            max_seq)
    assert [n for n, _ in jax_flatten(cache_j)] == [n for n, _ in flatten_with_names(cache_t)]
    for (n, a), (_, b) in zip(jax_flatten(cache_j), flatten_with_names(cache_t)):
        assert tuple(a.shape) == tuple(b.shape), n
    want_shape = (B, cfg.num_codebooks, cfg.vocab_size) if cfg.num_codebooks else (
        B, cfg.vocab_size)
    assert tuple(lt.shape) == want_shape
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=ATOL)

    tok_j = jnp.argmax(lj, axis=-1).astype(jnp.int32)
    tok_t = lt.argmax(-1).to(torch.int32)
    for _ in range(steps):
        np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
        lj, cache_j = JM.decode_step(params_j, cfg_j, tok_j, cache_j, impl="xla")
        lt, cache_t = M.decode_step(model, cfg, tok_t, cache_t)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=ATOL)
        tok_j = jnp.argmax(lj, axis=-1).astype(jnp.int32)
        tok_t = lt.argmax(-1).to(torch.int32)
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    for (_, a), (_, b) in zip(jax_flatten(cache_j), flatten_with_names(cache_t)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=ATOL)


@pytest.mark.parametrize("arch", PLAN_ARCHS)
def test_plan_forward_and_aux_loss_match_reference(arch):
    """The full-sequence forward at the reference's default 16 routing
    groups: final hidden states, logits and the summed MoE aux loss."""
    cfg_j, cfg, tree = _params(arch)
    model = M.params_from_numpy(cfg, tree, "cpu")
    batch = _plan_inputs(cfg, 2, 24, 2)
    params_j = jax.tree_util.tree_map(jnp.asarray, tree)
    h_j, _, aux_j = JM.forward_full(params_j, cfg_j, {k: jnp.asarray(v) for k, v in batch.items()},
                                    impl="xla")
    with torch.no_grad():
        h_t, _, aux_t = M.forward_full(model, cfg, {k: torch.from_numpy(v)
                                                    for k, v in batch.items()})
        logits = M.logits_fn(model, cfg, h_t)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(JM.logits_fn(params_j, cfg_j, h_j)),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5, atol=1e-9)
    assert (float(aux_t) > 0) == bool(cfg.num_experts)


def test_bfloat16_tree_carries_across_bit_for_bit():
    """Reduced deepseek-v3 in its own bfloat16: the reference's tree through
    ``params_from_numpy`` and back, every leaf's bits unchanged."""
    cfg_j = jax_reduced(jax_get_config("deepseek-v3-671b")).replace(param_dtype="bfloat16")
    cfg = reduced(get_config("deepseek-v3-671b")).replace(param_dtype="bfloat16")
    tree = jax.tree_util.tree_map(np.asarray, JM.init_params(cfg_j, jax.random.PRNGKey(4)))
    model = M.params_from_numpy(cfg, tree, "cpu")
    got = dict(flatten_with_names(M.params_tree(model)))
    want = dict(jax_flatten(tree))
    assert list(got) == list(want) and "mtp/block/attn/wkv_a/w" in got
    for n, a in want.items():
        assert got[n].dtype == torch.bfloat16, n
        np.testing.assert_array_equal(got[n].view(torch.int16).numpy(),
                                      np.asarray(a).view(np.int16), err_msg=n)


@pytest.mark.parametrize("arch", PLAN_ARCHS)
def test_training_runs_the_reference_loss(arch, tmp_path, monkeypatch):
    """MoE, MTP, codebook and image configs train: ``loss_fn``, the train
    step and ``launch.train --steps 1`` give the reference ``loss_fn``'s loss
    on the trainer's own first state and batch (B2 S32, one routing group as
    the train step uses).  The MoE configs take a capacity factor of 4 in both
    packages, so that no expert overflows: where one does, the reference
    erases a routed token (ROADMAP §3 fault 8)."""
    import json

    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch import train as T
    from repro_torch.optim import adamw
    from repro_torch.train import step as TS

    kw = {"capacity_factor": 4.0} if get_config(arch).num_experts else {}
    cfg = reduced(get_config(arch)).replace(**kw)
    cfg_j = jax_reduced(jax_get_config(arch)).replace(**kw)
    monkeypatch.setattr(T, "reduce_cfg", lambda c: reduced(c).replace(**kw))
    oc = adamw.OptConfig(lr=3e-4, warmup_steps=10, decay_steps=2)      # as the CLI's
    state = TS.init_train_state(cfg, oc, 0, "cpu")
    batch = SyntheticTokens(cfg, 2, 32, seed=0).batch_at(0)
    want, _ = JM.loss_fn(jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                                state["params"]), cfg_j,
                         {k: jnp.asarray(v) for k, v in batch.items()}, moe_groups=1,
                         impl="xla")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        loss, mets = M.loss_fn(state["params"], cfg, tbatch, moe_groups=1)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    assert ("mtp_ce" in mets) == bool(cfg.mtp_depth)
    _, om = TS.make_train_step(cfg, oc)(state, tbatch)
    np.testing.assert_allclose(float(om["loss"]), float(want), rtol=1e-5)
    out = tmp_path / "m.json"
    assert T.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "1",
                   "--batch", "2", "--seq", "32", "--ckpt-dir", str(tmp_path / "ckpt"),
                   "--metrics-out", str(out)]) == 0
    np.testing.assert_allclose(json.loads(out.read_text())["steps"][0]["loss"], float(want),
                               rtol=1e-5)


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
