"""Elastic (MxN) restart on the port: a checkpoint taken under one mesh
restores onto another factorization with the same values — the
framework analogue of DMTCP's process virtualization.

The reference's scenario (tests/test_elastic.py) on 8 gloo CPU ranks:
reduced llama3.2-1b, ``SyntheticTokens(cfg, 8, 32, seed=5)``, three steps at
(4, 2) from the reference's ``init_train_state(PRNGKey(3))`` carried over as
numpy, then a save.  In fresh processes the checkpoint restores at (4, 2),
(2, 4), (8, 1), (1, 8) and (2, 2, 2); each takes step 4 on ``batch_at(3)``
and its loss must be within 5e-4 of the (4, 2) restore's (the reference's
limit).  Each restore, gathered and saved again before any step, must keep
the saved checkpoint's chunk hashes bit for bit.

The (4, 2) run is also held to the reference's single-device run from the
same initial state: ``loss_fn`` + ``apply_updates``, three steps, then the
step-4 loss.  Tolerances, float32: each of the three steps' losses within
rtol 1e-5 of the reference's (one reduction order apart, as
tests/test_torch_train.py holds one step); the step-4 loss within 5e-4, the
reference's own limit for the same step under another reduction order
(tests/test_elastic.py: "resharded execution may reassociate reductions"),
which is what splitting the batch over ranks and summing their gradients
is.  A bound from the parameters alone (after three AdamW steps the two
runs' parameters differ by at most 2 * sum(lr_t) = 9e-4 per element, a
near-zero gradient's sign flip moving a parameter by 2 lr_t) times the
step-4 loss's l1 gradient norm (~556) is 0.5, too loose to hold anything.
Measured on the CPU: 9.5e-7.

A granite-moe reduced step at (2, 1) routes with 2 groups (one a rank) and
is held to the reference's ``loss_fn(moe_groups=2)`` and ``apply_updates``
from step 1 (the first with lr > 0): loss, aux, ce and grad norm within rtol
1e-5, the first moment (0.1 x the clipped gradient, the aux loss's share of
it summed over the ranks) within rtol 1e-4 and atol 1e-6 of its largest
value (tests/torch_train_parity.py's gradient tolerances), the parameters
within 2 lr.  At (1, 1) a
train step is bit for bit the one-device step.
"""
import json

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
from repro_torch.configs.base import get_config, reduced
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import adamw
from repro_torch.parallel.mesh_rules import Rules
from repro_torch.train import step as TS
from repro_torch.utils.tree import flatten_with_names, tree_map
from torch_gloo import launch, last_json

RESTORE_MESHES = ["(4, 2)", "(2, 4)", "(8, 1)", "(1, 8)", "(2, 2, 2)"]
OPT = dict(warmup_steps=2, decay_steps=10)
MOE_OPT = dict(warmup_steps=1, decay_steps=10)

_RANK = """
from pathlib import Path
from repro_torch.checkpoint.manager import CheckpointManager, CheckpointPolicy
from repro_torch.checkpoint.store import TieredStore
from repro_torch.configs.base import get_config, reduced
from repro_torch.core.virtualization import fetch_tree, place_tree
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.parallel.mesh_rules import Rules
from repro_torch.train import step as TS
from repro_torch.utils.tree import flatten_with_names, unflatten_like

mode, work = ARGS[0], Path(ARGS[1])
torch.use_deterministic_algorithms(True)


def host_state(cfg, oc, npz):
    arrs = np.load(npz)
    return unflatten_like(TS.abstract_train_state(cfg, oc), {k: arrs[k] for k in arrs.files})


def torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def hashes(root, step):
    mgr = CheckpointManager(TieredStore(root), CheckpointPolicy(delta=True))
    man = mgr.read_manifest(step)
    mgr.close()
    return {e["path"]: [c["hash"] for c in e["chunks"]] for e in man["leaves"]}


def save(root, state, step):
    host = fetch_tree(state)                 # a collective: every rank gathers
    if RANK == 0:
        mgr = CheckpointManager(TieredStore(root), CheckpointPolicy(delta=True))
        mgr.save(step, host)
        mgr.commit(step)
        mgr.close()
    dist.barrier()


cfg = reduced(get_config("llama3.2-1b"))
oc = adamw.OptConfig(**json.loads(ARGS[2]))
axes = TS.state_logical_axes(cfg)
report = {}
if mode == "save":
    mesh = make_mesh((4, 2))
    rules = Rules(mesh)
    state = place_tree(host_state(cfg, oc, work / "init.npz"), axes, rules, "cpu")
    step = TS.make_train_step(cfg, oc, rules=rules)
    pipe = SyntheticTokens(cfg, 8, 32, seed=5)
    losses = []
    for _ in range(3):
        state, m = step(state, torch_batch(next(pipe)))
        losses.append(float(m["loss"]))
    save(work / "ckpt", state, 2)
    report = {"losses": losses, "sharded": sum(hasattr(x, "to_local")
                                               for _, x in flatten_with_names(state))}
else:
    want = hashes(work / "ckpt", 2)
    pipe = SyntheticTokens(cfg, 8, 32, seed=5)
    for shape in ARGS[4:]:
        mesh = make_mesh(eval(shape))
        rules = Rules(mesh)
        mgr = CheckpointManager(TieredStore(work / "ckpt"), CheckpointPolicy(delta=True))
        host, _ = mgr.restore(TS.abstract_train_state(cfg, oc), promote=False)
        mgr.close()
        state = place_tree(host, axes, rules, "cpu")
        tag = shape.replace(" ", "").strip("()").replace(",", "x")
        save(work / f"resave-{tag}", state, 2)
        same = hashes(work / f"resave-{tag}", 2) == want if RANK == 0 else None
        step = TS.make_train_step(cfg, oc, rules=rules)
        state, m = step(state, torch_batch(pipe.batch_at(3)))
        report[shape] = {"loss": float(m["loss"]), "hashes_equal": same,
                         "sharded": sum(hasattr(x, "to_local")
                                        for _, x in flatten_with_names(state))}
    # granite-moe at (2, 1): ranks 0 and 1, two routing groups, one a rank
    from torch.distributed.device_mesh import DeviceMesh

    moe = reduced(get_config("granite-moe-3b-a800m")).replace(capacity_factor=4.0)
    dm = DeviceMesh("cpu", torch.arange(2).reshape(2, 1), mesh_dim_names=("data", "model"))
    if dm.get_coordinate() is not None:
        moc = adamw.OptConfig(**json.loads(ARGS[3]))
        mesh = Mesh((2, 1), ("data", "model"), dm, "cpu")
        rules = Rules(mesh)
        state = place_tree(host_state(moe, moc, work / "moe.npz"), TS.state_logical_axes(moe),
                           rules, "cpu")
        seen = []
        loss_fn = M.loss_fn

        def spy(*a, **kw):
            seen.append(kw["moe_groups"])
            return loss_fn(*a, **kw)

        M.loss_fn = spy
        step = TS.make_train_step(moe, moc, rules=rules)
        batch = dict(np.load(work / "moe_batch.npz"))
        state, m = step(state, torch_batch(batch))
        M.loss_fn = loss_fn
        def errs(tree, npz):
            want = np.load(work / npz)
            return {n: [float(np.abs(x.astype(np.float64) - want[n]).max()),
                        float(np.abs(want[n]).max())]
                    for n, x in flatten_with_names(fetch_tree(tree))}

        err, m_err = errs(state["params"], "moe_ref_params.npz"), errs(state["opt"]["m"],
                                                                       "moe_ref_m.npz")
        report["moe"] = {"groups_seen": seen, "loss": float(m["loss"]),
                         "aux": float(m["aux"]), "ce": float(m["ce"]),
                         "grad_norm": float(m["grad_norm"]), "param_err": err,
                         "m_err": m_err}
    dist.barrier()
print(json.dumps(report))
"""


def _npz(path, tree):
    np.savez(path, **{n: np.asarray(x) for n, x in ref_flatten(tree)})


def _ref_loss_and_grads(rcfg, moe_groups=1):
    return jax.jit(jax.value_and_grad(
        lambda p, b: RM.loss_fn(p, rcfg, b, moe_groups=moe_groups, z_loss=1e-4, impl="xla"),
        has_aux=True))


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    """The reference's single-device run, and the port's (4, 2) save and
    five restores on 8 gloo ranks (two launches of fresh processes)."""
    work = tmp_path_factory.mktemp("elastic")
    rcfg = ref_reduced(ref_get_config("llama3.2-1b"))
    roc = RA.OptConfig(**OPT)
    state = RTS.init_train_state(rcfg, roc, jax.random.PRNGKey(3))
    _npz(work / "init.npz", state)
    pipe = RefTokens(rcfg, 8, 32, seed=5)
    lg = _ref_loss_and_grads(rcfg)
    ref_losses = []
    for _ in range(3):
        (lv, _), g = lg(state["params"], next(pipe))
        new_p, new_opt, _ = RA.apply_updates(state["params"], g, state["opt"], state["step"], roc)
        state = {"params": new_p, "opt": new_opt, "step": state["step"] + 1}
        ref_losses.append(float(lv))
    (lv4, _), _ = lg(state["params"], pipe.batch_at(3))

    # granite-moe at (2, 1): the reference at two routing groups
    mcfg = ref_reduced(ref_get_config("granite-moe-3b-a800m")).replace(capacity_factor=4.0)
    moc = RA.OptConfig(**MOE_OPT)
    mstate = RTS.init_train_state(mcfg, moc, jax.random.PRNGKey(4))
    mstate["step"] = jnp.ones((), jnp.int32)
    _npz(work / "moe.npz", mstate)
    mbatch = RefTokens(mcfg, 4, 16, seed=9).batch_at(0)
    np.savez(work / "moe_batch.npz", **mbatch)
    (mlv, mmets), mg = _ref_loss_and_grads(mcfg, moe_groups=2)(mstate["params"], mbatch)
    mnew, mopt, mom = RA.apply_updates(mstate["params"], mg, mstate["opt"], mstate["step"],
                                       moc)
    moe_ref = {"loss": float(mlv), "aux": float(mmets["aux"]), "ce": float(mmets["ce"]),
               "grad_norm": float(mom["grad_norm"]),
               "lr": float(RA.schedule(moc, mstate["step"]))}
    _npz(work / "moe_ref_params.npz", mnew)
    _npz(work / "moe_ref_m.npz", mopt["m"])

    opt = json.dumps(OPT)
    saved = [last_json(o) for o in launch(_RANK, 8, work, "save", work, opt)]
    restored = [last_json(o) for o in launch(_RANK, 8, work, "restore", work, opt,
                                             json.dumps(MOE_OPT), *RESTORE_MESHES)]
    return {"ref_losses": ref_losses, "ref_loss4": float(lv4), "saved": saved,
            "restored": restored, "moe_ref": moe_ref}


def test_save_at_4x2_trains_as_the_reference(elastic):
    for rank, rep in enumerate(elastic["saved"]):
        assert rep["sharded"] > 0, rank                 # the state really was split
        assert rep["losses"] == elastic["saved"][0]["losses"], rank
        np.testing.assert_allclose(rep["losses"], elastic["ref_losses"], rtol=1e-5)


@pytest.mark.parametrize("mesh", RESTORE_MESHES)
def test_restore_on_another_mesh_takes_the_same_step(elastic, mesh):
    base = elastic["restored"][0]["(4, 2)"]["loss"]
    for rank, rep in enumerate(elastic["restored"]):
        assert abs(rep[mesh]["loss"] - base) < 5e-4, (rank, mesh, rep[mesh]["loss"], base)
        if mesh in ("(4, 2)", "(2, 4)", "(2, 2, 2)"):
            assert rep[mesh]["sharded"] > 0, (rank, mesh)


@pytest.mark.parametrize("mesh", RESTORE_MESHES)
def test_restore_resaved_keeps_its_chunk_hashes(elastic, mesh):
    assert elastic["restored"][0][mesh]["hashes_equal"] is True


def test_step4_at_4x2_is_the_reference_single_device_step4(elastic):
    for rep in elastic["restored"]:
        got = rep["(4, 2)"]["loss"]
        assert abs(got - elastic["ref_loss4"]) < 5e-4, (got, elastic["ref_loss4"])


def test_moe_at_2x1_routes_two_groups_as_the_reference(elastic):
    want = elastic["moe_ref"]
    for rank in (0, 1):
        got = elastic["restored"][rank]["moe"]
        assert got["groups_seen"] == [1]          # 2 groups over 2 ranks: one a rank
        for k in ("loss", "aux", "ce", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
        assert len(got["param_err"]) > 10 and want["lr"] > 0
        for n, (err, _) in got["param_err"].items():
            assert err <= 2 * want["lr"], (rank, n, err)
        top = max(mx for _, mx in got["m_err"].values())
        for n, (err, mx) in got["m_err"].items():
            assert err <= 1e-4 * mx + 1e-6 * top, (rank, n, err, mx, top)
    assert "moe" not in elastic["restored"][2]


def test_one_rank_step_is_the_one_device_step():
    """At (1, 1), through the mesh and rules, a step equals the one-device
    arithmetic (``loss_and_grads`` + ``apply_updates``) bit for bit."""
    cfg = reduced(get_config("llama3.2-1b"))
    oc = adamw.OptConfig(**OPT)
    a = TS.init_train_state(cfg, oc, 3, "cpu")
    b = tree_map(lambda x: x.clone(), a)
    batch = {k: torch.from_numpy(v)
             for k, v in SyntheticTokens(cfg, 8, 32, seed=5).batch_at(0).items()}
    mesh = make_host_mesh()
    a, ma = TS.make_train_step(cfg, oc, rules=Rules(mesh))(a, batch)
    loss, _, grads = TS.loss_and_grads(b["params"], cfg, batch)
    _, _, om = adamw.apply_updates(b["params"], grads, b["opt"], b["step"], oc)
    assert float(ma["loss"]) == float(loss) and float(ma["grad_norm"]) == float(om["grad_norm"])
    fb = dict(flatten_with_names({"params": b["params"], "opt": b["opt"]}))
    for n, x in flatten_with_names({"params": a["params"], "opt": a["opt"]}):
        assert torch.equal(x, fb[n]), n
