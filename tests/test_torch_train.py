"""The port's training path against the reference package's.

1. One AdamW step (and three) on reduced qwen2-0.5b in float32 from the
   reference's ``init_train_state``, moved over as numpy: loss, grad norm,
   gradients and moments against ``jax.value_and_grad(repro.models.model.
   loss_fn)`` + ``repro.optim.adamw.apply_updates``.  The reference's own
   ``make_train_step`` builds a mesh and is not used: the loss and update
   functions it wraps are called directly.
2. The step's helpers, the data pipeline and microbatching.
3. ``launch.train.main(... --device cpu)``: cold start -> walltime exit 85
   -> requeue -> the same final losses and parameter bytes as an
   uninterrupted run, with and without ``--ckpt-device-fp``.
4. A training checkpoint written by the reference's manager restores in
   the port's trainer and continues; the run-manifest mismatch is logged.

Tolerances, float32 on the CPU: loss and grad norm rtol 1e-5 (one reduction
order apart); gradients rtol 1e-4 / atol 1e-6 (summed over 64 tokens in
another order); moments rtol 1e-4 with an atol scaled from the gradients'
(m = 0.1 g, v = 0.05 g^2); params after 3 steps within 2 * sum(lr_t), the
most one AdamW sign flip of a near-zero gradient can move a parameter.
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
from repro_torch.data.pipeline import PipelineState, SyntheticTokens
from repro_torch.launch import train as T
from repro_torch.optim import adamw
from repro_torch.train import step as TS
from repro_torch.utils.tree import flatten_with_names, tree_map

ARCH = "qwen2-0.5b"


def _state_from_reference(ref_state) -> dict:
    return tree_map(lambda a: torch.from_numpy(np.array(a)), ref_state)


def _close(got, want, rtol, atol=0.0, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


@pytest.fixture(scope="module")
def setup():
    cfg = reduced(get_config(ARCH))
    rcfg = ref_reduced(ref_get_config(ARCH))
    oc, roc = (adamw.OptConfig(warmup_steps=1, decay_steps=10),
               RA.OptConfig(warmup_steps=1, decay_steps=10))
    ref_state = RTS.init_train_state(rcfg, roc, jax.random.PRNGKey(0))
    batches = [RefTokens(rcfg, 4, 16, seed=1).batch_at(s) for s in range(3)]
    return cfg, rcfg, oc, roc, ref_state, batches


def _ref_step(rcfg, roc, state, batch):
    def loss(p):
        return RM.loss_fn(p, rcfg, batch, z_loss=1e-4)

    (lv, _), grads = jax.value_and_grad(loss, has_aux=True)(state["params"])
    new_p, new_opt, om = RA.apply_updates(state["params"], grads, state["opt"],
                                          state["step"], roc)
    return ({"params": new_p, "opt": new_opt, "step": state["step"] + 1},
            float(lv), grads, om)


# ---------------------------------------------------------------------------
# 1. one step, and three, against the reference's loss and update
# ---------------------------------------------------------------------------

def test_one_step_matches_reference(setup):
    cfg, rcfg, oc, roc, ref_state, batches = setup
    state = _state_from_reference(ref_state)
    batch = {"tokens": torch.from_numpy(batches[0]["tokens"])}

    loss, metrics, grads = TS.loss_and_grads(state["params"], cfg, batch)
    new_ref, ref_loss, ref_grads, ref_om = _ref_step(rcfg, roc, ref_state, batches[0])
    _close(float(loss), ref_loss, 1e-5, what="loss")
    rg = dict(ref_flatten(ref_grads))
    for name, g in flatten_with_names(grads):
        _close(g.numpy(), rg[name], 1e-4, 1e-6, what=f"grad {name}")

    new_state, om = TS.make_train_step(cfg, oc)(state, batch)
    _close(float(om["loss"]), ref_loss, 1e-5, what="loss")
    _close(float(om["grad_norm"]), float(ref_om["grad_norm"]), 1e-5, what="grad_norm")
    _close(float(om["lr"]), float(ref_om["lr"]), 1e-6, what="lr")
    assert int(new_state["step"]) == 1
    gmax = max(float(np.abs(np.asarray(g)).max()) for g in rg.values())
    for part, atol in (("m", 1e-6 * (1 - roc.b1)), ("v", 2e-6 * gmax * (1 - roc.b2))):
        want = dict(ref_flatten(new_ref["opt"][part]))
        for name, x in flatten_with_names(new_state["opt"][part]):
            _close(x.numpy(), want[name], 1e-4, atol, what=f"{part} {name}")


def test_three_steps_stay_within_the_update_bound(setup):
    cfg, rcfg, oc, roc, ref_state, batches = setup
    state = _state_from_reference(ref_state)
    step = TS.make_train_step(cfg, oc)
    lr_sum = 0.0
    for b in batches:
        lr_sum += float(adamw.schedule(oc, state["step"]))
        state, _ = step(state, {"tokens": torch.from_numpy(b["tokens"])})
        ref_state, *_ = _ref_step(rcfg, roc, ref_state, b)
    assert lr_sum > 0
    want = dict(ref_flatten(ref_state["params"]))
    for name, p in flatten_with_names(state["params"]):
        err = float(np.abs(p.numpy() - np.asarray(want[name])).max())
        assert err <= 2 * lr_sum, (name, err, 2 * lr_sum)


# ---------------------------------------------------------------------------
# 2. helpers, data, microbatches
# ---------------------------------------------------------------------------

def test_predump_boundary_and_microbatches_match_reference():
    for step in range(-2, 40):
        for interval in (0, 1, 2, 5, 8):
            for lead in (1, 2, 3, 9):
                assert (TS.predump_boundary(step, interval, lead)
                        == RTS.predump_boundary(step, interval, lead))
    for b in (1, 2, 6, 8, 12):
        for req in (1, 2, 3, 4, 8, 16):
            for shards in (1, 2, 4, 16):
                assert (TS.effective_microbatches(b, req, shards)
                        == RTS.effective_microbatches(b, req, shards))


def test_synthetic_tokens_match_reference():
    cfg, rcfg = reduced(get_config(ARCH)), ref_reduced(ref_get_config(ARCH))
    port, ref = SyntheticTokens(cfg, 3, 10, seed=7), RefTokens(rcfg, 3, 10, seed=7)
    for _ in range(3):
        a, b = next(port), next(ref)
        assert a.keys() == b.keys()
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    port.restore(PipelineState.from_dict(ref.state().to_dict()))
    np.testing.assert_array_equal(next(port)["tokens"], next(ref)["tokens"])


def test_microbatches_match_one_batch(setup):
    cfg, _, oc, _, ref_state, batches = setup
    batch = {"tokens": torch.from_numpy(batches[0]["tokens"])}
    s1, m1 = TS.make_train_step(cfg, oc, microbatches=1)(_state_from_reference(ref_state),
                                                          batch)
    s2, m2 = TS.make_train_step(cfg, oc, microbatches=2)(_state_from_reference(ref_state),
                                                          batch)
    # the mean of two half-batch losses is the loss of the batch when both
    # halves hold the same number of tokens
    _close(float(m2["loss"]), float(m1["loss"]), 1e-5, what="loss")
    worst = max(float((a - b).abs().max()) for (_, a), (_, b) in
                zip(flatten_with_names(s1["params"]), flatten_with_names(s2["params"])))
    assert worst < 5e-5, worst


# ---------------------------------------------------------------------------
# 3. preempt -> exit 85 -> requeue -> bit-identical finish, through the CLI
# ---------------------------------------------------------------------------

def _train(ckpt_dir, out, extra, steps=4):
    code = T.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", str(steps),
                   "--batch", "2", "--seq", "16", "--ckpt-dir", str(ckpt_dir),
                   "--metrics-out", str(out), "--ckpt-delta", *extra])
    return code, json.loads(out.read_text())


def _final(ckpt_dir, cfg, oc):
    mgr = CheckpointManager(TieredStore(ckpt_dir), CheckpointPolicy(delta=True))
    state, manifest = mgr.restore(TS.abstract_train_state(cfg, oc))
    mgr.close()
    return ({n: np.ascontiguousarray(a).tobytes() for n, a in flatten_with_names(state)},
            {e["path"]: [c["hash"] for c in e["chunks"]] for e in manifest["leaves"]})


@pytest.mark.parametrize("device_fp", [False, True], ids=["host_fp", "device_fp"])
def test_preempt_requeue_finishes_bit_identical(tmp_path, device_fp):
    extra = ["--ckpt-device-fp"] if device_fp else []
    code, whole = _train(tmp_path / "a", tmp_path / "a.json", extra)
    assert code == 0 and [s["step"] for s in whole["steps"]] == [0, 1, 2, 3]

    # walltime margin > walltime: the first step boundary checkpoints and exits
    code, cut = _train(tmp_path / "b", tmp_path / "b1.json",
                       extra + ["--walltime", "0.5", "--margin", "100"])
    assert code == T.REQUEUE_EXIT and [s["step"] for s in cut["steps"]] == [0]
    req = json.loads((tmp_path / "b" / "requeue.json").read_text())
    assert req["requeues"] == 1 and req["last_step"] == 0
    code, rest = _train(tmp_path / "b", tmp_path / "b2.json", extra)
    assert code == 0 and rest["start_step"] == 1
    assert [s["step"] for s in rest["steps"]] == [1, 2, 3]

    assert ([s["loss"] for s in cut["steps"] + rest["steps"]]
            == [s["loss"] for s in whole["steps"]])
    cfg, oc = reduced(get_config(ARCH)), adamw.OptConfig()
    assert _final(tmp_path / "b", cfg, oc) == _final(tmp_path / "a", cfg, oc)
    if device_fp:
        assert all(s["fp_device_s"] > 0 for s in whole["saves"] + cut["saves"] + rest["saves"])


def test_train_needs_a_card_unless_told_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        T.main(["--reduced", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(SystemExit):
        T.main(["--reduced", "--ckpt-dir", str(tmp_path), "--device", "cpu",
                "--ckpt-device-fp"])                  # device fp needs --ckpt-delta


def test_trainer_is_deterministic_without_importing_the_compiler(tmp_path):
    """The trainer's steps run with torch's deterministic flag on, and the
    caller's setting is back after ``main``; the flag is set without
    importing ``torch._inductor`` (seconds of every job's start-up).  In a
    fresh interpreter, since another test may have imported it already."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    script = f"""
import sys, torch
from repro_torch.launch import train as T
from repro_torch.train import step as TS
seen, make = [], TS.make_train_step
def counted(*a, **k):
    step = make(*a, **k)
    def run(*x):
        seen.append(torch.are_deterministic_algorithms_enabled())
        return step(*x)
    return run
TS.make_train_step = counted
code = T.main(["--arch", "{ARCH}", "--reduced", "--device", "cpu", "--steps", "2",
               "--batch", "2", "--seq", "8", "--ckpt-dir", {str(tmp_path)!r}])
print(code, seen, torch.are_deterministic_algorithms_enabled(), "torch._inductor" in sys.modules)
"""
    src = str(Path(__file__).resolve().parents[1] / "src")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": src})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "0 [True, True] False False"


# ---------------------------------------------------------------------------
# 4. a checkpoint written by the reference's trainer state continues here
# ---------------------------------------------------------------------------

def test_reference_training_checkpoint_continues_in_port(setup, tmp_path, capsys):
    from repro.checkpoint.manager import CheckpointManager as RefManager
    from repro.checkpoint.manager import CheckpointPolicy as RefPolicy
    from repro.checkpoint.store import TieredStore as RefStore
    from repro.core.manifest import capture_manifest

    _, rcfg, _, _, _, _ = setup
    roc = RA.OptConfig(lr=3e-4, warmup_steps=10, decay_steps=4)    # as the CLI's
    ref_state = RTS.init_train_state(rcfg, roc, jax.random.PRNGKey(0))
    pipe = RefTokens(rcfg, 2, 16, seed=0)
    ref_state, *_ = _ref_step(rcfg, roc, ref_state, next(pipe))
    host = jax.tree_util.tree_map(np.asarray, ref_state)
    rmgr = RefManager(RefStore(tmp_path / "ckpt"),
                      RefPolicy(delta=True, fingerprint=True))
    rmgr.save(0, host, extra_meta={"next_step": 1, "data_state": pipe.state().to_dict(),
                                   "run_manifest": capture_manifest(rcfg)})
    rmgr.commit(0)
    rmgr.close()
    _, want_loss, _, _ = _ref_step(rcfg, roc, ref_state, pipe.batch_at(1))

    code, out = _train(tmp_path / "ckpt", tmp_path / "m.json", ["--ckpt-fingerprint"])
    assert code == 0 and out["start_step"] == 1
    assert [s["step"] for s in out["steps"]] == [1, 2, 3]
    _close(out["steps"][0]["loss"], want_loss, 1e-5, what="first loss after restore")
    printed = capsys.readouterr().out
    assert "[manifest] written by another framework" in printed
    assert "restored checkpoint step=0" in printed


def test_manifest_compares_only_shared_keys():
    from repro_torch.core.manifest import capture_manifest, verify_manifest

    cfg = reduced(get_config(ARCH))
    here = capture_manifest(cfg, device="cpu")
    assert here["torch"] == torch.__version__ and here["device"] == "cpu"
    assert verify_manifest(here, cfg=cfg, log=lambda m: None, device="cpu") == []
    jax_written = {"python": here["python"], "jax": "0.0", "numpy": here["numpy"],
                   "backend": "tpu", "config_hash": here["config_hash"]}
    logged = []
    problems = verify_manifest(jax_written, cfg=cfg, log=logged.append, device="cpu")
    assert problems == ["written by another framework: saved has backend=tpu, jax=0.0"]
    assert logged == ["[manifest] " + problems[0]]
