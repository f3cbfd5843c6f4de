"""Shared by the tests that hold one AdamW step of the port's training
against the reference's (tests/test_torch_{moe,mla,media}_train.py).

The reference side is ``jax.value_and_grad(repro.models.model.loss_fn)``
at ``impl="xla"`` with an explicit ``moe_groups``, then
``repro.optim.adamw.apply_updates``; not the reference's ``make_train_step``,
which needs its mesh and sharding rules.  The port side is
``train.step.make_train_step`` on a train state carried over from the
reference's ``init_train_state`` as numpy; at a routing group count other
than the train step's one, autograd through ``models.model.loss_fn`` and
``optim.adamw.apply_updates``.

Tolerances, float32 on the CPU, those of tests/test_torch_ssm_train.py:
the loss within rtol 1e-5; each gradient within rtol 1e-4 and atol 1e-6
plus ``atol_rel`` of the leaf's largest |gradient|; the moments and the
new params within the bounds those imply.
"""
import contextlib
import json

import numpy as np
import torch

import jax

from repro.models import model as RM
from repro.optim import adamw as RA
from repro.utils.tree import flatten_with_names as ref_flatten
from repro_torch.checkpoint.serialization import to_torch
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.optim import adamw
from repro_torch.train import step as TS
from repro_torch.utils.tree import flatten_with_names, tree_map, unflatten_like

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def close(got, want, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


def to_port(tree) -> dict:
    """A reference tree (jax or numpy arrays) as CPU tensors of the same
    dtypes and bits, bfloat16 included."""
    return tree_map(lambda a: to_torch(np.array(a), "cpu"), tree)


def port_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def ref_loss_and_grads(rcfg, moe_groups: int):
    return jax.jit(jax.value_and_grad(
        lambda p, b: RM.loss_fn(p, rcfg, b, moe_groups=moe_groups, z_loss=1e-4, impl="xla"),
        has_aux=True))


def ref_step(roc, state, batch, loss_and_grads):
    """(new state, loss, {metric: float}, grads, optimiser metrics)."""
    (lv, mets), grads = loss_and_grads(state["params"], batch)
    new_p, new_opt, om = RA.apply_updates(state["params"], grads, state["opt"],
                                          state["step"], roc)
    return ({"params": new_p, "opt": new_opt, "step": state["step"] + 1}, float(lv),
            {k: float(v) for k, v in mets.items()}, grads, om)


def port_loss_and_grads(params, cfg, batch, moe_groups: int):
    """The train step's ``loss_and_grads`` at one routing group, else
    autograd through ``loss_fn`` at ``moe_groups``: (loss, metrics, grads)."""
    if moe_groups == 1:
        return TS.loss_and_grads(params, cfg, batch)
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    named = flatten_with_names(leaves)
    loss, mets = M.loss_fn(leaves, cfg, batch, moe_groups=moe_groups)
    grads = torch.autograd.grad(loss, [x for _, x in named])
    return (loss.detach(), {k: v.detach() for k, v in mets.items()},
            unflatten_like(params, {n: g for (n, _), g in zip(named, grads)}))


@contextlib.contextmanager
def routed_entries():
    """Collects, for every MoE layer run inside the context, whether each
    routed (token, k) entry fit its expert's capacity."""
    seen: list = []
    orig = MOE.assign_slots

    def spy(flat_e, E, C, K):
        out = orig(flat_e, E, C, K)
        seen.append(bool(out[1].all()))
        return out

    MOE.assign_slots = spy
    try:
        yield seen
    finally:
        MOE.assign_slots = orig


def check_one_step(cfg, rcfg, oc, roc, ref_state, batch, *, moe_groups: int,
                   atol_rel: float, metrics=("ce", "aux")):
    """One step of each package from the reference's state: the loss, the
    named loss metrics, every gradient, the grad norm, the lr, the moments
    and the new params.  Returns (port grads by name, port metrics,
    whether no routed entry overflowed)."""
    ref_new, ref_loss, ref_mets, ref_grads, ref_om = ref_step(
        roc, ref_state, batch, ref_loss_and_grads(rcfg, moe_groups))
    state = to_port(ref_state)
    pbatch = port_batch(batch)
    with routed_entries() as fits:
        loss, mets, grads = port_loss_and_grads(state["params"], cfg, pbatch, moe_groups)
    close(float(loss), ref_loss, LOSS_RTOL, what="loss")
    for k in metrics:
        close(float(mets[k]), ref_mets[k], LOSS_RTOL, 1e-9, what=k)
    rg = dict(ref_flatten(ref_grads))
    named = flatten_with_names(grads)
    assert [n for n, _ in named] == list(rg)
    for name, g in named:
        want = np.asarray(rg[name])
        assert g.dtype == torch.float32, name
        close(g.numpy(), want, GRAD_RTOL,
              GRAD_ATOL + atol_rel * float(np.abs(want).max(initial=0.0)), what=f"grad {name}")

    if moe_groups == 1:
        new_state, om = TS.make_train_step(cfg, oc)(state, pbatch)
    else:
        # the train step routes with one group: another count is held
        # through loss_fn's gradient and the update alone
        _, _, om = adamw.apply_updates(state["params"], grads, state["opt"], state["step"], oc)
        new_state = {**state, "step": state["step"] + 1}
        om = {"loss": loss, **mets, **om}
    close(float(om["loss"]), ref_loss, LOSS_RTOL, what="step loss")
    for k in metrics:
        if k != "ce":
            close(float(om[k]), ref_mets[k], LOSS_RTOL, 1e-9, what=f"step {k}")
    close(float(om["grad_norm"]), float(ref_om["grad_norm"]), max(1e-5, atol_rel),
          what="grad_norm")
    close(float(om["lr"]), float(ref_om["lr"]), 1e-6, what="lr")
    assert int(new_state["step"]) == 1
    gmax = max(float(np.abs(np.asarray(g)).max(initial=0.0)) for g in rg.values())
    for part, mom_atol in (("m", (1e-6 + atol_rel * gmax) * (1 - roc.b1)),
                           ("v", (2e-6 + 2 * atol_rel * gmax) * gmax * (1 - roc.b2))):
        want = dict(ref_flatten(ref_new["opt"][part]))
        for name, x in flatten_with_names(new_state["opt"][part]):
            close(x.numpy(), want[name], 1e-4, mom_atol, what=f"{part} {name}")
    # at the first step m_hat / sqrt(v_hat) is sign(g) but where |g| nears
    # eps, so the params agree to lr times the moments' relative error
    want = dict(ref_flatten(ref_new["params"]))
    lr = float(ref_om["lr"])
    for name, p in flatten_with_names(new_state["params"]):
        close(p.numpy(), want[name], 1e-6, 1e-3 * lr, what=f"param {name}")
    return dict(named), {k: float(v) for k, v in mets.items()}, all(fits)



def train_cli(arch, ckpt_dir, out, extra, steps=4, batch=2, seq=16):
    """``launch.train --reduced --device cpu --ckpt-delta`` in this process:
    (exit code, the --metrics-out JSON)."""
    from repro_torch.launch import train as T

    code = T.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", str(steps),
                   "--batch", str(batch), "--seq", str(seq), "--ckpt-dir", str(ckpt_dir),
                   "--metrics-out", str(out), "--ckpt-delta", *extra])
    return code, json.loads(out.read_text())


def final_state(ckpt_dir, cfg, oc):
    """({leaf: bytes}, {leaf: chunk hashes}) of the latest committed state."""
    from repro_torch.checkpoint.manager import CheckpointManager, CheckpointPolicy
    from repro_torch.checkpoint.store import TieredStore

    mgr = CheckpointManager(TieredStore(ckpt_dir), CheckpointPolicy(delta=True))
    state, manifest = mgr.restore(TS.abstract_train_state(cfg, oc))
    mgr.close()
    return ({n: np.ascontiguousarray(a).tobytes() for n, a in flatten_with_names(state)},
            {e["path"]: [c["hash"] for c in e["chunks"]] for e in manifest["leaves"]})


def check_preempt_requeue(arch, tmp_path, cfg, oc, launch_keys):
    """Run A uninterrupted; B cut by its walltime after step 0 (exit 85); C
    requeued on B's directory: C ends on A's losses and final chunk hashes.
    Returns A's metrics."""
    from repro_torch.launch import train as T

    extra = ["--ckpt-device-fp"]
    code, whole = train_cli(arch, tmp_path / "a", tmp_path / "a.json", extra)
    assert code == 0 and [s["step"] for s in whole["steps"]] == [0, 1, 2, 3]
    code, cut = train_cli(arch, tmp_path / "b", tmp_path / "b1.json",
                          extra + ["--walltime", "0.5", "--margin", "100"])
    assert code == T.REQUEUE_EXIT and [s["step"] for s in cut["steps"]] == [0]
    code, rest = train_cli(arch, tmp_path / "b", tmp_path / "b2.json", extra)
    assert code == 0 and rest["start_step"] == 1
    assert [s["step"] for s in rest["steps"]] == [1, 2, 3]
    assert ([s["loss"] for s in cut["steps"] + rest["steps"]]
            == [s["loss"] for s in whole["steps"]])
    assert all(np.isfinite(s["loss"]) for s in whole["steps"])
    assert final_state(tmp_path / "b", cfg, oc) == final_state(tmp_path / "a", cfg, oc)
    # the CPU path counts no kernel launch
    for m in (whole, cut, rest):
        assert m["launches"] == dict.fromkeys(launch_keys, 0)
    return whole
