"""Training the SSM families (zamba2, rwkv6) in the port against the reference.

1. One AdamW step of reduced zamba2-1.2b and rwkv6-1.6b in float32 from the
   reference's ``init_train_state``: loss, every gradient, grad norm, the
   new params and moments, against ``jax.value_and_grad(repro.models.model.
   loss_fn)(..., impl="xla")`` + ``repro.optim.adamw.apply_updates``.  The
   reference's own train step builds a mesh and is not used, and its
   ``"auto"`` scans route S > 64 to chunked forms that overflow at these
   models' init (ROADMAP §3, faults 5-6), so the oracle is ``impl="xla"``:
   the sequential recurrences, the port's plain versions.
2. zamba2's shared attention block gets one gradient, summed over its
   invocations.
3. The scans' backward (``ref.recompute_grads``, the backward of ``_SSD``
   and ``_WKV6``) against autograd through the plain versions, and the two
   autograd Functions themselves, with the kernel's launch replaced by the
   plain forward (the kernels run only on an H100: the ``gpu`` tests of
   tests/test_torch_kernels.py hold them there).
4. ``launch.train --arch zamba2-1.2b|rwkv6-1.6b``: preempt -> exit 85 ->
   requeue -> bit-identical finish; the SSM train state's manifest entries
   and chunk files as the reference writes them; a reference-written
   checkpoint continued by the port's trainer.

Tolerances, float32 on the CPU, those of tests/test_torch_train.py (loss
rtol 1e-5; gradients rtol 1e-4 / atol 1e-6; moments rtol 1e-4 with an atol
scaled from the gradients'), with one addition: each gradient's atol also
takes a fraction of the leaf's largest |gradient|, because these models'
float32 gradients are worse conditioned than qwen2's.  The reference's own
two float32 evaluations (jitted and op by op) differ by 1.5e-5 of a leaf's
largest |gradient| for reduced zamba2 (2 ulp of an embedding-table entry
exceeds 1e-6) and by 7.3e-5 for reduced rwkv6, where a float64 evaluation
stands 0.9-1.8e-4 from either package's.  The fraction is 1e-4 for zamba2
(the packages differ by 1.2e-5) and 1e-3 for rwkv6 (they differ by 2.6e-4,
uniformly over the leaves: the error enters above the layers); the grad
norm and the moments take the same fraction.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

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
from repro_torch.kernels import ref
from repro_torch.kernels import ssd as SSD
from repro_torch.kernels import wkv6 as WKV
from repro_torch.launch import train as T
from repro_torch.models import blocks as BL
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.train import step as TS
from repro_torch.utils.tree import flatten_with_names, tree_map, unflatten_like

ARCHS = ("zamba2-1.2b", "rwkv6-1.6b")
# gradients: (rtol, atol, atol as a fraction of the leaf's largest |gradient|)
GRAD_TOL = {"zamba2-1.2b": (1e-4, 1e-6, 1e-4), "rwkv6-1.6b": (1e-4, 1e-6, 1e-3)}


def _state_from_reference(ref_state) -> dict:
    return tree_map(lambda a: torch.from_numpy(np.array(a)), ref_state)


def _close(got, want, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


def _ref_loss_and_grads(rcfg):
    return jax.jit(jax.value_and_grad(
        lambda p, b: RM.loss_fn(p, rcfg, b, z_loss=1e-4, impl="xla"), has_aux=True))


def _ref_step(rcfg, roc, state, batch, loss_and_grads):
    (lv, _), grads = loss_and_grads(state["params"], batch)
    new_p, new_opt, om = RA.apply_updates(state["params"], grads, state["opt"],
                                          state["step"], roc)
    return ({"params": new_p, "opt": new_opt, "step": state["step"] + 1},
            float(lv), grads, om)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    cfg = reduced(get_config(arch))
    rcfg = ref_reduced(ref_get_config(arch))
    oc, roc = (adamw.OptConfig(warmup_steps=1, decay_steps=10),
               RA.OptConfig(warmup_steps=1, decay_steps=10))
    ref_state = RTS.init_train_state(rcfg, roc, jax.random.PRNGKey(0))
    batch = RefTokens(rcfg, 4, 16, seed=1).batch_at(0)
    new_ref, ref_loss, ref_grads, ref_om = _ref_step(rcfg, roc, ref_state, batch,
                                                     _ref_loss_and_grads(rcfg))
    return dict(arch=arch, cfg=cfg, rcfg=rcfg, oc=oc, roc=roc, ref_state=ref_state,
                batch=batch, new_ref=new_ref, ref_loss=ref_loss,
                ref_grads=dict(ref_flatten(ref_grads)), ref_om=ref_om)


# ---------------------------------------------------------------------------
# 1. one AdamW step against the reference's loss and update
# ---------------------------------------------------------------------------

def test_one_adamw_step_matches_reference(setup):
    s = setup
    cfg, oc, roc = s["cfg"], s["oc"], s["roc"]
    rtol, atol, atol_rel = GRAD_TOL[s["arch"]]
    state = _state_from_reference(s["ref_state"])
    batch = {"tokens": torch.from_numpy(s["batch"]["tokens"])}

    loss, _, grads = TS.loss_and_grads(state["params"], cfg, batch)
    _close(float(loss), s["ref_loss"], 1e-5, what="loss")
    rg = s["ref_grads"]
    named = flatten_with_names(grads)
    assert [n for n, _ in named] == list(rg)
    ssm_leaves = {"A_log", "D", "dt_bias", "conv_w", "conv_b", "u", "w0", "lora_w1",
                  "lora_w2", "decay_w1", "decay_w2", "mu", "mu_x"}
    seen = set()
    for name, g in named:
        want = np.asarray(rg[name])
        assert g.dtype == torch.float32 and float(np.abs(want).max()) > 0, name
        _close(g.numpy(), want, rtol, atol + atol_rel * float(np.abs(want).max()),
               what=f"grad {name}")
        seen.update(part for part in name.split("/") if part in ssm_leaves)
    want_ssm = ({"A_log", "D", "dt_bias", "conv_w", "conv_b"} if s["arch"].startswith("zamba2")
                else {"u", "w0", "lora_w1", "lora_w2", "decay_w1", "decay_w2", "mu", "mu_x"})
    assert want_ssm <= seen
    # zamba2's reused block: the reference's jax.grad sums its invocations
    assert (any(n.startswith("shared_attn/") for n, _ in named)
            == s["arch"].startswith("zamba2"))

    new_state, om = TS.make_train_step(cfg, oc)(state, batch)
    ref_om = s["ref_om"]
    _close(float(om["loss"]), s["ref_loss"], 1e-5, what="loss")
    _close(float(om["grad_norm"]), float(ref_om["grad_norm"]), max(1e-5, atol_rel),
           what="grad_norm")
    _close(float(om["lr"]), float(ref_om["lr"]), 1e-6, what="lr")
    assert int(new_state["step"]) == 1
    gmax = max(float(np.abs(np.asarray(g)).max()) for g in rg.values())
    for part, mom_atol in (("m", (1e-6 + atol_rel * gmax) * (1 - roc.b1)),
                           ("v", (2e-6 + 2 * atol_rel * gmax) * gmax * (1 - roc.b2))):
        want = dict(ref_flatten(s["new_ref"]["opt"][part]))
        for name, x in flatten_with_names(new_state["opt"][part]):
            _close(x.numpy(), want[name], 1e-4, mom_atol, what=f"{part} {name}")
    # the update moves each parameter by lr * (m_hat / sqrt(v_hat) + wd p):
    # at the first step m_hat / sqrt(v_hat) is sign(g) but where |g| nears
    # eps, so the params agree to lr times the moments' relative error
    want = dict(ref_flatten(s["new_ref"]["params"]))
    lr = float(ref_om["lr"])
    for name, p in flatten_with_names(new_state["params"]):
        _close(p.numpy(), want[name], 1e-6, 1e-3 * lr, what=f"param {name}")


# ---------------------------------------------------------------------------
# 2. zamba2's shared block: one gradient, summed over its invocations
# ---------------------------------------------------------------------------

def test_shared_block_gradient_is_summed_over_invocations(monkeypatch):
    cfg = reduced(get_config("zamba2-1.2b"))
    groups = cfg.num_layers // cfg.shared_attn_period
    assert groups >= 2
    params = M.init_params(cfg, 0, "cpu").tree
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32))}
    _, _, grads = TS.loss_and_grads(params, cfg, batch)
    summed = dict(flatten_with_names(grads["shared_attn"]))

    # the same loss with one copy of the shared block per invocation
    copies = [tree_map(lambda x: x.detach().clone().requires_grad_(), params["shared_attn"])
              for _ in range(groups)]
    calls = []
    block_full = BL.block_full

    def per_invocation(kind, p, *a, **kw):
        if kind == "attn_dense":            # zamba2 runs attention only in the shared block
            p = copies[len(calls)]
            calls.append(kind)
        return block_full(kind, p, *a, **kw)

    monkeypatch.setattr(BL, "block_full", per_invocation)
    with torch.enable_grad():
        loss, _ = M.loss_fn(params, cfg, batch)
        leaves = [x for c in copies for _, x in flatten_with_names(c)]
        each = torch.autograd.grad(loss, leaves)
    assert len(calls) == groups
    n = len(leaves) // groups
    for i, (name, g) in enumerate(flatten_with_names(grads["shared_attn"])):
        parts = [each[j * n + i] for j in range(groups)]
        assert not torch.equal(parts[0], parts[1]), name      # distinct contributions
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        torch.testing.assert_close(summed[name], total, rtol=1e-6, atol=1e-9)


# ---------------------------------------------------------------------------
# 3. the scans' backward: the plain version's gradient, recomputed
# ---------------------------------------------------------------------------

def _ssd_inputs(dtype, S=37, B=2, H=3, P=16, N=8, seed=0):
    g = torch.Generator().manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=g)

    return [(rn(B, S, H, P) * 0.5).to(dtype), (rn(B, S, H).abs() * 0.5).to(dtype),
            rn(H) * 0.3, (rn(B, S, N) * 0.5).to(dtype), (rn(B, S, N) * 0.5).to(dtype),
            torch.ones(H) + rn(H) * 0.1], rn(B, H, P, N) * 0.5


def _wkv_inputs(dtype, S=37, B=2, H=3, D=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    r, k, v = (torch.randn((B, S, H, D), generator=g) * 0.5 for _ in range(3))
    w = torch.rand((B, S, H, D), generator=g) * 0.299 + 0.7
    u = torch.randn((H, D), generator=g) * 0.3
    return ([r.to(dtype), k.to(dtype), v.to(dtype), w.to(dtype), u],
            torch.randn((B, H, D, D), generator=g) * 0.5)


SCANS = {"ssd": (ref.ssd, _ssd_inputs), "wkv6": (ref.wkv6, _wkv_inputs)}


@pytest.mark.parametrize("scan", sorted(SCANS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("with_state", [False, True], ids=["no_state", "state_in_out"])
def test_recompute_grads_is_autograd_through_the_plain_version(scan, dtype, with_state):
    """At a ragged S (37): bit for bit, in each input's own dtype, for every
    input and for a subset of them; with a state in and out, the state's
    gradient enters too."""
    plain, make = SCANS[scan]
    inputs, st0 = make(dtype)
    kw = dict(init_state=st0 if with_state else None, return_state=with_state)
    g = torch.Generator().manual_seed(9)
    leaves = [t.clone().requires_grad_() for t in inputs]
    out = plain(*leaves, **kw)
    outs = out if with_state else (out,)
    gouts = tuple(torch.randn(o.shape, generator=g).to(o.dtype) for o in outs)
    for need in ([True] * len(inputs), [i % 2 == 0 for i in range(len(inputs))]):
        wrt = [t for t, n in zip(leaves, need) if n]
        want = iter(torch.autograd.grad(outs, wrt, gouts, retain_graph=True))
        got = ref.recompute_grads(plain, inputs, need, gouts, **kw)
        for t, n, gr in zip(inputs, need, got):
            if not n:
                assert gr is None
                continue
            w = next(want)
            assert gr.dtype == t.dtype and gr.shape == t.shape
            assert torch.equal(gr, w)
    # an output that got no gradient is left out, as autograd leaves it out
    if with_state:
        want = torch.autograd.grad(outs[0], leaves, gouts[0], retain_graph=True)
        got = ref.recompute_grads(plain, inputs, [True] * len(inputs), (gouts[0], None), **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("scan", sorted(SCANS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_scan_function_forward_is_the_launch_backward_the_plain_gradient(
        monkeypatch, scan, dtype):
    """``_SSD`` / ``_WKV6`` on CPU tensors, with the kernel's launch replaced
    by the plain forward: one launch for the forward, none in the backward,
    the caller's own inputs saved, and the plain version's gradient."""
    plain, make = SCANS[scan]
    mod, fn = (SSD, SSD._SSD) if scan == "ssd" else (WKV, WKV._WKV6)
    launched = []

    def launch(*args):
        *tensors, init_state, return_state = args
        launched.append([t.data_ptr() for t in tensors])
        with torch.no_grad():
            return plain(*tensors, init_state=init_state, return_state=return_state)

    monkeypatch.setattr(mod, "_launch", launch)
    inputs, _ = make(dtype)
    leaves = [t.clone().requires_grad_() for t in inputs]
    y = fn.apply(*leaves, None, False)
    assert len(launched) == 1 and launched[0] == [t.data_ptr() for t in leaves]
    assert y.dtype == dtype and y.grad_fn is not None
    go = torch.randn(y.shape, generator=torch.Generator().manual_seed(2)).to(dtype)
    got = torch.autograd.grad(y, leaves, go)
    assert len(launched) == 1
    plain_leaves = [t.clone().requires_grad_() for t in inputs]
    want_y = plain(*plain_leaves)
    want = torch.autograd.grad(want_y, plain_leaves, go)
    assert torch.equal(y.detach(), want_y.detach())
    for a, b, t in zip(got, want, inputs):
        assert a.dtype == t.dtype and torch.equal(a, b)
    # the final state as a second output, differentiated with y
    leaves = [t.clone().requires_grad_() for t in inputs]
    y, st = fn.apply(*leaves, None, True)
    gst = torch.randn(st.shape, generator=torch.Generator().manual_seed(3))
    got = torch.autograd.grad((y, st), leaves, (go, gst))
    plain_leaves = [t.clone().requires_grad_() for t in inputs]
    want = torch.autograd.grad(plain(*plain_leaves, return_state=True), plain_leaves,
                               (go, gst))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# 4. the trainer: preempt -> exit 85 -> requeue; manifests; a reference checkpoint
# ---------------------------------------------------------------------------

def _train(arch, ckpt_dir, out, extra, steps=4):
    code = T.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", str(steps),
                   "--batch", "2", "--seq", "16", "--ckpt-dir", str(ckpt_dir),
                   "--metrics-out", str(out), "--ckpt-delta", *extra])
    return code, json.loads(out.read_text())


def _final(ckpt_dir, cfg, oc):
    mgr = CheckpointManager(TieredStore(ckpt_dir), CheckpointPolicy(delta=True))
    state, manifest = mgr.restore(TS.abstract_train_state(cfg, oc))
    mgr.close()
    return ({n: np.ascontiguousarray(a).tobytes() for n, a in flatten_with_names(state)},
            {e["path"]: [c["hash"] for c in e["chunks"]] for e in manifest["leaves"]})


@pytest.mark.parametrize("arch", ARCHS)
def test_preempt_requeue_finishes_bit_identical(tmp_path, arch):
    extra = ["--ckpt-device-fp"]
    code, whole = _train(arch, tmp_path / "a", tmp_path / "a.json", extra)
    assert code == 0 and [s["step"] for s in whole["steps"]] == [0, 1, 2, 3]
    code, cut = _train(arch, tmp_path / "b", tmp_path / "b1.json",
                       extra + ["--walltime", "0.5", "--margin", "100"])
    assert code == T.REQUEUE_EXIT and [s["step"] for s in cut["steps"]] == [0]
    code, rest = _train(arch, tmp_path / "b", tmp_path / "b2.json", extra)
    assert code == 0 and rest["start_step"] == 1
    assert [s["step"] for s in rest["steps"]] == [1, 2, 3]
    assert ([s["loss"] for s in cut["steps"] + rest["steps"]]
            == [s["loss"] for s in whole["steps"]])
    cfg, oc = reduced(get_config(arch)), adamw.OptConfig()
    assert _final(tmp_path / "b", cfg, oc) == _final(tmp_path / "a", cfg, oc)
    # the CPU path counts no kernel launch; the keys name every kernel of a train run
    for m in (whole, cut, rest):
        assert m["launches"] == {"flash": 0, "ssd": 0, "wkv6": 0, "chunk_fingerprints": 0}


def test_ssm_train_state_manifest_is_the_references(setup, tmp_path):
    """The state after one step, saved by each package with the CLI's delta
    policy and fingerprints: the same manifest entries (paths, dtypes,
    shapes, chunk hashes, CRCs, fingerprints) and the same chunk files; and
    each restores the other's byte for byte."""
    from repro.checkpoint.manager import CheckpointManager as RefManager
    from repro.checkpoint.manager import CheckpointPolicy as RefPolicy
    from repro.checkpoint.store import TieredStore as RefStore

    s = setup
    ref_host = jax.tree_util.tree_map(np.asarray, s["new_ref"])
    port = tree_map(lambda a: torch.from_numpy(np.array(a)), ref_host)
    policy = dict(replicas=1, delta=True, fingerprint=True)
    rmgr = RefManager(RefStore(tmp_path / "ref", seed=0), RefPolicy(**policy))
    rmgr.save(1, ref_host)
    rmgr.commit(1)
    ref_leaves = rmgr.read_manifest(1)["leaves"]
    rmgr.close()
    mgr = CheckpointManager(TieredStore(tmp_path / "port", seed=0),
                            CheckpointPolicy(**policy, device_fp=True))
    mgr.save(1, port)
    mgr.commit(1)
    assert mgr.read_manifest(1)["leaves"] == ref_leaves
    restored, _ = mgr.restore(port)
    mgr.close()
    files = {}
    for root in ("ref", "port"):
        files[root] = sorted((p.name, p.read_bytes()) for p in (tmp_path / root).rglob("*")
                             if p.is_file() and "chunks" in p.parts)
    assert files["port"] == files["ref"] and files["port"]
    paths = {e["path"] for e in ref_leaves}
    assert any(p.endswith(("/A_log", "/u")) for p in paths)
    for (n, a), (_, b) in zip(flatten_with_names(restored), ref_flatten(ref_host)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), n
    rmgr = RefManager(RefStore(tmp_path / "port"), RefPolicy(**policy))
    back, _ = rmgr.restore(ref_host)
    rmgr.close()
    for (n, a), (_, b) in zip(ref_flatten(back), ref_flatten(ref_host)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), n


def test_reference_ssm_checkpoint_continues_in_port(setup, tmp_path, capsys):
    from repro.checkpoint.manager import CheckpointManager as RefManager
    from repro.checkpoint.manager import CheckpointPolicy as RefPolicy
    from repro.checkpoint.store import TieredStore as RefStore
    from repro.core.manifest import capture_manifest

    s = setup
    rcfg = s["rcfg"]
    roc = RA.OptConfig(lr=3e-4, warmup_steps=10, decay_steps=4)    # as the CLI's
    ref_state = RTS.init_train_state(rcfg, roc, jax.random.PRNGKey(0))
    pipe = RefTokens(rcfg, 2, 16, seed=0)
    loss_and_grads = _ref_loss_and_grads(rcfg)
    ref_state, *_ = _ref_step(rcfg, roc, ref_state, next(pipe), loss_and_grads)
    host = jax.tree_util.tree_map(np.asarray, ref_state)
    rmgr = RefManager(RefStore(tmp_path / "ckpt"), RefPolicy(delta=True, fingerprint=True))
    rmgr.save(0, host, extra_meta={"next_step": 1, "data_state": pipe.state().to_dict(),
                                   "run_manifest": capture_manifest(rcfg)})
    rmgr.commit(0)
    rmgr.close()
    _, want_loss, _, _ = _ref_step(rcfg, roc, ref_state, pipe.batch_at(1), loss_and_grads)

    code, out = _train(s["arch"], tmp_path / "ckpt", tmp_path / "m.json",
                       ["--ckpt-fingerprint"])
    assert code == 0 and out["start_step"] == 1
    assert [st["step"] for st in out["steps"]] == [1, 2, 3]
    _close(out["steps"][0]["loss"], want_loss, 1e-5, what="first loss after restore")
    printed = capsys.readouterr().out
    assert "[manifest] written by another framework" in printed
    assert "restored checkpoint step=0" in printed


def test_port_unflattens_the_reference_ssm_tree(setup):
    """``params_from_numpy`` takes the reference's SSM parameter tree as it
    is, and ``unflatten_like`` rebuilds the train state's names in order."""
    s = setup
    host = jax.tree_util.tree_map(np.asarray, s["ref_state"])
    lm = M.params_from_numpy(s["cfg"], host["params"], "cpu")
    got = dict(flatten_with_names(M.params_tree(lm)))
    for name, a in ref_flatten(host["params"]):
        assert np.array_equal(got[name].numpy(), a), name
    state = _state_from_reference(s["ref_state"])
    named = dict(flatten_with_names(state))
    again = flatten_with_names(unflatten_like(state, named))
    assert [n for n, _ in again] == list(named)
    assert all(x is named[n] for n, x in again)
