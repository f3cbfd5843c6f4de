"""Training MLA with its MTP head (deepseek-v3-671b) in the port against the
reference, on the CPU.

1. One AdamW step of reduced deepseek-v3 (2 layers: one ``mla_dense`` and
   one ``mla_moe``, B2 S16, float32) from the reference's
   ``init_train_state``: loss, the aux loss, the MTP head's cross entropy
   and every gradient, the ``mtp/*`` leaves included
   (tests/torch_train_parity.py; capacity factor 4 so that no expert
   overflows, as in tests/test_torch_moe_train.py).
2. ``flash`` under autograd as the card runs it (``_Flash``: the kernel's
   forward, the plain version's gradient recomputed), with the launch
   replaced by the plain forward: at MLA's head dims (192, 128) and at
   granite-moe's G = 3 its gradients are autograd's through ``ref.attention``
   bit for bit, and the reduced model's loss and gradients through it are
   the plain path's.
3. The one-dense-layer cut (``num_layers=1, first_dense_layers=1``): an
   empty ``mla_moe`` segment whose leaves have 0 elements.  Its plan, its
   specs (3,123,099,648 parameters at full width) and one train step equal
   the reference's; its state saves with device fingerprints to the
   reference's manifest and chunk files, no fingerprint launch reads an
   empty leaf, and both packages restore it bit for bit.
4. AdamW on bfloat16 params with float32 moments (deepseek-v3's own
   dtypes) against the reference's ``apply_updates``.
5. The limits ``chip_smoke.py`` phase 4 holds the card's float32 train
   step to are at least twice the CPU's float32 error from a float64
   evaluation, for each of the four families this file set trains.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.data.pipeline import SyntheticTokens as RefTokens
from repro.models import model as RM
from repro.optim import adamw as RA
from repro.train import step as RTS
from repro.utils.tree import flatten_with_names as ref_flatten
from repro_torch.checkpoint.manager import CheckpointManager, CheckpointPolicy
from repro_torch.checkpoint.store import TieredStore
from repro_torch.configs.base import get_config, reduced
from repro_torch.kernels import checksum as CK
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.train import step as TS
from repro_torch.utils.tree import flatten_with_names, tree_map
from torch_train_parity import check_one_step, close, port_batch, to_port

ARCH = "deepseek-v3-671b"
PARITY = dict(num_layers=2, capacity_factor=4.0)
ATOL_REL = 1e-4
CUT = dict(num_layers=1, first_dense_layers=1)


def _cfgs(**kw):
    return (reduced(get_config(ARCH)).replace(**kw),
            ref_reduced(ref_get_config(ARCH)).replace(**kw))


def _opt():
    return (adamw.OptConfig(warmup_steps=1, decay_steps=10),
            RA.OptConfig(warmup_steps=1, decay_steps=10))


@pytest.fixture(scope="module")
def ref_init():
    cfg, rcfg = _cfgs(**PARITY)
    oc, roc = _opt()
    state = RTS.init_train_state(rcfg, roc, jax.random.PRNGKey(0))
    return cfg, rcfg, oc, roc, state, RefTokens(rcfg, 2, 16, seed=1).batch_at(0)


# ---------------------------------------------------------------------------
# 1. one AdamW step: loss, aux, mtp_ce, every gradient
# ---------------------------------------------------------------------------

def test_one_adamw_step_matches_reference(ref_init):
    cfg, rcfg, oc, roc, state, batch = ref_init
    assert [(s.kind, s.count) for s in M.layer_plan(cfg)] == [("mla_dense", 1), ("mla_moe", 1)]
    grads, mets, fits = check_one_step(cfg, rcfg, oc, roc, state, batch, moe_groups=1,
                                       atol_rel=ATOL_REL, metrics=("ce", "aux", "mtp_ce"))
    assert fits, "an expert overflowed; the packages differ there by design (fault 8)"
    assert mets["aux"] > 0 and mets["mtp_ce"] > 0
    mtp = [n for n in grads if n.startswith("mtp/")]
    assert {"mtp/proj/w", "mtp/norm/scale", "mtp/block/attn/wkv_a/w",
            "mtp/block/attn/wk_b", "mtp/block/ffn/down/w"} <= set(mtp)
    assert all(float(grads[n].abs().max()) > 0 for n in mtp)


# ---------------------------------------------------------------------------
# 2. _Flash: the kernel's forward under autograd, the plain gradient
# ---------------------------------------------------------------------------

def _plain_launch(launched):
    """Stands in for the kernel's launch on CPU tensors: the plain forward,
    outside autograd, counted."""
    def launch(q, k, v, causal, scale):
        launched.append((tuple(q.shape), tuple(v.shape)))
        with torch.no_grad():
            return ref.attention(q, k, v, causal=causal, scale=scale)
    return launch


@pytest.mark.parametrize("shape", [(2, 16, 6, 2, 64, 64), (1, 16, 4, 4, 192, 128)],
                         ids=["G3", "mla_192_128"])
def test_flash_function_backward_is_the_plain_gradient(monkeypatch, shape):
    B, S, H, Hkv, Dq, Dv = shape
    launched = []
    monkeypatch.setattr(FA, "_launch", _plain_launch(launched))
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(s, generator=g) for s in ((B, S, H, Dq), (B, S, Hkv, Dq),
                                                      (B, S, Hkv, Dv)))
    go = torch.randn((B, S, H, Dv), generator=g)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    scale = 1.0 / float(np.sqrt(Dq))
    out = FA._Flash.apply(*leaves, True, scale)
    got = torch.autograd.grad(out, leaves, go)
    assert len(launched) == 1
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want_out = ref.attention(*plain, causal=True, scale=scale)
    want = torch.autograd.grad(want_out, plain, go)
    assert torch.equal(out.detach(), want_out.detach())
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_reduced_model_through_flash_function(ref_init, monkeypatch):
    """Every attention of the reduced model (2 layers and the MTP block)
    through ``_Flash`` as on the card: one launch each, and the loss and
    gradients of the CPU path bit for bit."""
    cfg, _, _, _, state, batch = ref_init
    params = to_port(state)["params"]
    pbatch = port_batch(batch)
    want_loss, _, want = TS.loss_and_grads(params, cfg, pbatch)
    launched = []
    monkeypatch.setattr(FA, "_launch", _plain_launch(launched))
    monkeypatch.setattr(FA, "flash", lambda q, k, v, causal=True, scale=None: FA._Flash.apply(
        q, k, v, causal, 1.0 / float(np.sqrt(q.shape[-1])) if scale is None else scale))
    loss, _, got = TS.loss_and_grads(params, cfg, pbatch)
    assert launched == [((2, 16, 4, 48), (2, 16, 4, 32))] * 2 + [((2, 15, 4, 48), (2, 15, 4, 32))]
    assert torch.equal(loss, want_loss)
    for (n, a), (_, b) in zip(flatten_with_names(got), flatten_with_names(want)):
        assert torch.equal(a, b), n


# ---------------------------------------------------------------------------
# 3. the one-dense-layer cut: zero-element leaves
# ---------------------------------------------------------------------------

def test_one_dense_layer_cut_plan_and_specs_match_reference():
    for full in (True, False):
        cfg = get_config(ARCH) if full else reduced(get_config(ARCH))
        rcfg = ref_get_config(ARCH) if full else ref_reduced(ref_get_config(ARCH))
        cfg, rcfg = cfg.replace(**CUT), rcfg.replace(**CUT)
        plan = [(s.kind, s.count) for s in M.layer_plan(cfg)]
        assert plan == [(s.kind, s.count) for s in RM.layer_plan(rcfg)]
        assert plan == [("mla_dense", 1), ("mla_moe", 0)]
        got = flatten_with_names(M.abstract_params(cfg))
        want = ref_flatten(RM.abstract_params(rcfg))
        assert [(n, tuple(t.shape), str(t.dtype).removeprefix("torch."))
                for n, t in got] == [(n, tuple(s.shape), str(s.dtype)) for n, s in want]
        empty = [n for n, t in got if t.numel() == 0]
        assert empty and all(n.startswith("seg1/") for n in empty)
        assert M.count_params_analytic(cfg) == RM.count_params_analytic(rcfg)
        if full:
            assert M.count_params_analytic(cfg) == 3_123_099_648
            assert cfg.param_dtype == "bfloat16"


def test_one_dense_layer_cut_trains_saves_and_restores_as_the_reference(tmp_path,
                                                                        monkeypatch):
    from repro.checkpoint.manager import CheckpointManager as RefManager
    from repro.checkpoint.manager import CheckpointPolicy as RefPolicy
    from repro.checkpoint.store import TieredStore as RefStore

    cfg, rcfg = _cfgs(**CUT)
    oc, roc = _opt()
    ref_state = RTS.init_train_state(rcfg, roc, jax.random.PRNGKey(0))
    batch = RefTokens(rcfg, 2, 16, seed=1).batch_at(0)
    grads, _, _ = check_one_step(cfg, rcfg, oc, roc, ref_state, batch, moe_groups=1,
                                 atol_rel=ATOL_REL, metrics=("ce", "aux", "mtp_ce"))
    empty = sorted(n for n, g in grads.items() if g.numel() == 0)
    assert empty and all(n.startswith("seg1/") for n in empty)

    # the state after a port step, saved by each package
    state = to_port(ref_state)
    state, _ = TS.make_train_step(cfg, oc)(state, port_batch(batch))
    named = dict(flatten_with_names(state))
    host = tree_map(lambda t: t.numpy(), state)
    policy = dict(replicas=1, delta=True, fingerprint=True)
    rmgr = RefManager(RefStore(tmp_path / "ref", seed=0), RefPolicy(**policy))
    rmgr.save(1, host)
    rmgr.commit(1)
    ref_leaves = rmgr.read_manifest(1)["leaves"]
    rmgr.close()

    words_seen = []
    fingerprints = CK.chunk_fingerprints

    def spy(words, chunk_words):
        words_seen.append(words.numel())
        return fingerprints(words, chunk_words)

    monkeypatch.setattr(CK, "chunk_fingerprints", spy)
    mgr = CheckpointManager(TieredStore(tmp_path / "port", seed=0),
                            CheckpointPolicy(**policy, device_fp=True))
    mgr.save(1, state)
    mgr.commit(1)
    assert mgr.read_manifest(1)["leaves"] == ref_leaves
    restored, _ = mgr.restore(TS.abstract_train_state(cfg, oc))
    mgr.close()
    assert words_seen and min(words_seen) > 0        # no launch over an empty leaf
    by_path = {e["path"]: e for e in ref_leaves}
    for part in ("params/", "opt/m/", "opt/v/"):
        for n in empty:
            e = by_path[part + n]
            assert e["shape"][0] == 0 and not e.get("chunks"), e
    files = {}
    for root in ("ref", "port"):
        files[root] = sorted((p.name, p.read_bytes()) for p in (tmp_path / root).rglob("*")
                             if p.is_file() and "chunks" in p.parts)
    assert files["port"] == files["ref"] and files["port"]
    for n, a in flatten_with_names(restored):
        assert tuple(np.shape(a)) == tuple(named[n].shape), n
        assert np.ascontiguousarray(a).tobytes() == named[n].numpy().tobytes(), n
    rmgr = RefManager(RefStore(tmp_path / "port"), RefPolicy(**policy))
    back, _ = rmgr.restore(host)
    rmgr.close()
    for (n, a), (_, b) in zip(ref_flatten(back), ref_flatten(host)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), n


# ---------------------------------------------------------------------------
# 4. AdamW in deepseek-v3's dtypes
# ---------------------------------------------------------------------------

def test_adamw_bfloat16_params_float32_moments_match_reference():
    """Three updates of bfloat16 params with float32 moments from the same
    gradients: the moments within float32 rounding, the params within one
    bfloat16 rounding (the packages' grad norms differ in their last bits,
    which moves an update by an ulp of float32 and the rounding to bfloat16
    by one step at most), most of them bit for bit."""
    rng = np.random.default_rng(5)
    shapes = {"a": (64, 48), "b": {"c": (300,), "e": (0, 8)}}

    def draw(scale):
        def make(s):
            return (rng.standard_normal(s) * scale).astype(np.float32)
        return {"a": make(shapes["a"]), "b": {"c": make(shapes["b"]["c"]),
                                              "e": make(shapes["b"]["e"])}}

    p32 = draw(1.0)
    rp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), p32)
    pp = to_port(jax.tree_util.tree_map(np.asarray, rp))
    assert pp["a"].dtype == torch.bfloat16
    oc, roc = adamw.OptConfig(warmup_steps=2), RA.OptConfig(warmup_steps=2)
    ropt, popt = RA.init_opt_state(rp, roc), adamw.init_opt_state(pp, oc)
    assert popt["m"]["a"].dtype == torch.float32
    same = total = 0
    for step in range(3):
        g = draw(0.1 * (step + 1))
        rp, ropt, rom = RA.apply_updates(rp, jax.tree_util.tree_map(jnp.asarray, g), ropt,
                                         jnp.asarray(step, jnp.int32), roc)
        _, _, om = adamw.apply_updates(pp, to_port(g), popt,
                                       torch.tensor(step, dtype=torch.int32), oc)
        close(float(om["grad_norm"]), float(rom["grad_norm"]), 1e-6, what="grad_norm")
        close(float(om["lr"]), float(rom["lr"]), 1e-6, what="lr")
        for part in ("m", "v"):
            for (n, a), (_, b) in zip(flatten_with_names(popt[part]), ref_flatten(ropt[part])):
                assert a.dtype == torch.float32
                close(a.numpy(), np.asarray(b), 1e-5, 1e-9, what=f"{part} {n}")
        for (n, a), (_, b) in zip(flatten_with_names(pp), ref_flatten(rp)):
            assert a.dtype == torch.bfloat16
            got, want = a.float().numpy(), np.asarray(b).astype(np.float32)
            close(got, want, 2 ** -8, 0.0, what=f"param {n}")
            same += int((got == want).sum())
            total += got.size
    assert same >= 0.99 * total


# ---------------------------------------------------------------------------
# 5. the card's gradient limits against float32's own error
# ---------------------------------------------------------------------------

def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_limits", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-v3-671b",
                                  "musicgen-large", "llava-next-mistral-7b"])
def test_phase4_gradient_limit_covers_float32_error(arch, monkeypatch):
    """Phase 4 of chip_smoke.py holds the card's float32 gradients to the
    CPU's within a share of each leaf's largest |gradient|.  Card and CPU
    each stand off the exact gradient by float32 rounding, so the limit
    must be at least twice the CPU's error, read here against a float64
    evaluation of phase 4's own inputs (``Tensor.float`` made to give
    float64, so the model's float32 casts keep float64 too): deepseek-v3
    1.53e-4 at embed/table, the other three under 2.2e-6."""
    cs = _chip_smoke()
    cfg, params, batch = cs.reduced_train_inputs(arch)
    _, grad_tol = cs.train_tols(arch, cfg)
    g32 = dict(flatten_with_names(TS.loss_and_grads(params, cfg, batch)[2]))
    cfg64 = cfg.replace(param_dtype="float64", compute_dtype="float64")
    b64 = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    monkeypatch.setattr(torch.Tensor, "float", lambda self, *a, **k: self.double())
    g64 = dict(flatten_with_names(TS.loss_and_grads(tree_map(torch.Tensor.double, params),
                                                    cfg64, b64)[2]))
    monkeypatch.undo()
    assert {g.dtype for g in g64.values()} == {torch.float64}
    rel = {n: float((g32[n].double() - g).abs().max() / g.abs().max())
           for n, g in g64.items() if g.numel() and g.abs().max() > 0}
    worst = max(rel, key=rel.get)
    assert 2 * rel[worst] <= grad_tol, (worst, rel[worst], grad_tol)
