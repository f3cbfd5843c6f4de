"""The port's serving-fleet weight distribution (the scenarios of
tests/test_weight_sync.py, on ``repro_torch``): ParamHandle double-buffering,
WeightSyncClient delta fetches over the chunk fabric, the registry push
plane, the --max-lag-steps staleness gate and draining; then the engine
boundary, and ``launch/serve.py --follow`` serving pushed steps on the CPU.

The sync protocol is framework-free, so the tree-level cases drive numpy
trees, and each runs twice on the same seeded trees: once on the port's
modules and once on the reference's (``repro``), each on a fabric of its own.
Every case asserts the scenario's own facts on both, and what the two
observe (fetched trees, bytes by tier, lag, history, registry entries,
probe states) must be equal.  The engine case runs the port's reduced model.
"""
import json
import threading
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import serialization as RSER
from repro.checkpoint.manager import CheckpointManager as RManager
from repro.checkpoint.manager import CheckpointPolicy as RPolicy
from repro.checkpoint.store import TieredStore as RStore
from repro.checkpoint.store import is_peer_tier as r_is_peer_tier
from repro.checkpoint.store import node_local_tier_roots as r_node_local_tier_roots
from repro.sched.cache_registry import CacheRegistry as RRegistry
from repro.serve.weight_sync import ParamHandle as RParamHandle
from repro.serve.weight_sync import StaleReplicaError as RStaleReplicaError
from repro.serve.weight_sync import WeightSyncClient as RWeightSyncClient
from repro_torch.checkpoint import serialization as SER
from repro_torch.checkpoint.manager import CheckpointManager, CheckpointPolicy
from repro_torch.checkpoint.store import (TieredStore, is_peer_tier,
                                          node_local_tier_roots)
from repro_torch.sched.cache_registry import CacheRegistry
from repro_torch.serve.weight_sync import (ParamHandle, StaleReplicaError,
                                           WeightSyncClient)

CHUNK = 1 << 16

PORT = types.SimpleNamespace(
    name="port", SER=SER, CheckpointManager=CheckpointManager,
    CheckpointPolicy=CheckpointPolicy, TieredStore=TieredStore, is_peer_tier=is_peer_tier,
    node_local_tier_roots=node_local_tier_roots, CacheRegistry=CacheRegistry,
    ParamHandle=ParamHandle, StaleReplicaError=StaleReplicaError,
    WeightSyncClient=WeightSyncClient)
REF = types.SimpleNamespace(
    name="ref", SER=RSER, CheckpointManager=RManager, CheckpointPolicy=RPolicy,
    TieredStore=RStore, is_peer_tier=r_is_peer_tier,
    node_local_tier_roots=r_node_local_tier_roots, CacheRegistry=RRegistry,
    ParamHandle=RParamHandle, StaleReplicaError=RStaleReplicaError,
    WeightSyncClient=RWeightSyncClient)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _tree(rng, n_leaves=4, elems=70_000):
    return {f"l{i}": rng.standard_normal(elems).astype(np.float32)
            for i in range(n_leaves)}


def _mutate(tree, names, delta=1.0, elems=100):
    out = dict(tree)
    for k in names:
        a = out[k].copy()
        a[:elems] += delta
        out[k] = a
    return out


def _assert_trees_equal(ns, got, want):
    flat_g = dict(ns.SER.flatten_with_names(got))
    flat_w = dict(ns.SER.flatten_with_names(want))
    assert set(flat_g) == set(flat_w)
    for k in flat_w:
        np.testing.assert_array_equal(flat_g[k], flat_w[k])


def _comparable(x, root):
    """``x`` as plain data the two packages' runs can be compared on: arrays
    by dtype, shape and bytes, the run's own directory as ``<root>``, and no
    clock readings (keys ending in ``_s`` or ``_at``)."""
    if isinstance(x, dict):
        return {k: _comparable(v, root) for k, v in x.items()
                if not (isinstance(k, str) and k.endswith(("_s", "_at")))}
    if isinstance(x, (list, tuple)):
        return [_comparable(v, root) for v in x]
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.shape, x.tobytes())
    if isinstance(x, str):
        return x.replace(str(root), "<root>")
    return x


def _held_against_reference(scenario, tmp_path):
    """Run ``scenario(ns, root, rng) -> observations`` on the port's modules
    and on the reference's, from the same seed, each under a root of its own;
    the two lists of observations must be equal."""
    seen = {}
    for ns in (PORT, REF):
        root = tmp_path / ns.name
        root.mkdir()
        seen[ns.name] = _comparable(scenario(ns, root, np.random.default_rng(0)), root)
    assert len(seen["port"]) == len(seen["ref"])
    for got, want in zip(seen["port"], seen["ref"]):
        assert got == want, (got[0] if isinstance(got, list) and got else got)
    return seen


def _pol(ns, **kw):
    base = dict(replicas=1, delta=True, chunk_bytes=CHUNK)
    base.update(kw)
    return ns.CheckpointPolicy(**base)


class Fabric:
    """One shared checkpoint root + registry; publisher eager-promotes so
    the fleet can fetch deltas peer-to-peer (the bench topology)."""

    def __init__(self, ns, root):
        self.ns = ns
        self.root = root
        self.registry = ns.CacheRegistry(root / "registry")

    def store_for(self, node):
        return self.ns.TieredStore(
            self.root / "ck", seed=0,
            tier_roots=self.ns.node_local_tier_roots(self.root / "nodes" / node))

    def publisher(self):
        return self.ns.CheckpointManager(self.store_for("pub"),
                                         _pol(self.ns, promote="eager"),
                                         node="pub", registry=self.registry)

    def replica_manager(self, name):
        return self.ns.CheckpointManager(self.store_for(name),
                                         _pol(self.ns, promote="on_restore"),
                                         node=name, registry=self.registry)

    def push(self, pub, step, tree):
        pub.save(step, tree)
        man = pub.commit(step)
        pub.wait_promotions()
        self.registry.announce_push(
            step=step, node="pub",
            manifest_version=man.get("manifest_version"))
        return man

    def follower(self, tree1, name="r0", **kw):
        """A replica restored on step 1 (promoting it) with its client."""
        mgr = self.replica_manager(name)
        host, man = mgr.restore(tree1)
        mgr.wait_promotions()
        handle = self.ns.ParamHandle(host, step=1)
        client = self.ns.WeightSyncClient(mgr, handle, tree1, registry=self.registry,
                                          replica=name, **kw)
        return mgr, handle, client, man


# ---------------------------------------------------------------------------
# ParamHandle: the double buffer itself
# ---------------------------------------------------------------------------

def _handle_state(h):
    return [h.step, h.pending_step, h.newest_step, h.swap_count]


def _param_handle_stage_supersede_and_flip(ns, root, rng):
    t1, t2, t3 = ({"w": rng.standard_normal(8)} for _ in range(3))
    h = ns.ParamHandle(t1, step=1)
    cur = h.current
    obs = [("born", _handle_state(h))]
    assert h.step == 1 and h.pending_step is None and h.newest_step == 1
    assert not h.commit_pending()                  # nothing staged: no-op

    h.stage(t2, 2)
    assert h.current is cur, "staging must not touch the served tree"
    assert h.step == 1 and h.pending_step == 2 and h.newest_step == 2
    obs.append(("staged 2", _handle_state(h)))

    h.stage(t3, 3)                                 # newer push supersedes
    assert h.pending_step == 3
    obs.append(("staged 3", _handle_state(h)))
    assert h.commit_pending()
    assert h.current is t3 and h.step == 3 and h.pending_step is None
    assert h.swap_count == 1
    assert not h.commit_pending()                  # drained
    obs.append(("flipped", _handle_state(h) + [h.current]))
    return obs


def test_param_handle_stage_supersede_and_flip(tmp_path):
    _held_against_reference(_param_handle_stage_supersede_and_flip, tmp_path)


# ---------------------------------------------------------------------------
# the headline: a warm-but-stale follower fetches EXACTLY the delta, with
# zero shared-tier bytes, and never promotes/invalidates anything
# ---------------------------------------------------------------------------

def _stale_follower_fetches_delta(ns, root, rng):
    fab = Fabric(ns, root)
    pub = fab.publisher()
    tree1 = _tree(rng)
    fab.push(pub, 1, tree1)

    mgr, handle, client, man = fab.follower(tree1)  # warm-up: promotes step 1
    assert man["step"] == 1
    assert client.lag() == 0 and client.sync_once() is None

    # the push: one leaf changes -> one delta chunk set
    tree2 = _mutate(tree1, ["l0"])
    save_stats = pub.save(2, tree2)
    man2 = pub.commit(2)
    pub.wait_promotions()
    fab.registry.announce_push(step=2, node="pub")
    delta_bytes = save_stats["delta"]["bytes_written"]

    rec = client.sync_once()
    assert rec is not None and rec["step"] == 2 and rec["from_step"] == 1
    by_tier = rec["bytes_by_tier"]
    assert by_tier.get("shared", 0) == 0, by_tier  # fabric, not the pfs
    peer_bytes = sum(v for t, v in by_tier.items() if ns.is_peer_tier(t))
    assert 0 < peer_bytes <= 2 * delta_bytes, (peer_bytes, delta_bytes)
    assert by_tier.get("local", 0) > 0             # unchanged chunks: own cache
    assert rec["delta"] and rec["manifest_version"] == 2
    obs = [("delta bytes written", delta_bytes), ("sync record", rec),
           ("lag after the fetch", client.lag())]

    # decode-visible state is untouched until the boundary swap
    assert handle.step == 1 and handle.pending_step == 2
    _assert_trees_equal(ns, handle.current, tree1)
    assert handle.commit_pending()
    _assert_trees_equal(ns, handle.current, tree2)
    assert handle.step == man2["step"] == 2
    obs.append(("served tree after the swap", handle.current))

    # READ-ONLY follower: the fetch must not have promoted step 2 into (or
    # invalidated) the node cache another process may be serving from
    marker = json.loads(
        (root / "nodes" / "r0" / "local" / "node0" / "ckpt"
         / "PROMOTED.json").read_text())
    assert marker["step"] == 1
    obs.append(("promoted marker step", marker["step"]))
    mgr.close()
    pub.close()
    return obs


def test_stale_follower_fetches_delta_with_zero_shared_bytes(tmp_path):
    _held_against_reference(_stale_follower_fetches_delta, tmp_path)


def _second_sync_is_idempotent(ns, root, rng):
    fab = Fabric(ns, root)
    pub = fab.publisher()
    tree1 = _tree(rng)
    fab.push(pub, 1, tree1)
    mgr, handle, client, _ = fab.follower(tree1)

    tree2 = _mutate(tree1, ["l1"])
    fab.push(pub, 2, tree2)
    assert client.sync_once() is not None
    # staged counts as "have": a second poll before the swap must not refetch
    assert client.lag() == 0 and client.sync_once() is None
    assert len(client.history) == 1
    handle.commit_pending()
    _assert_trees_equal(ns, handle.current, tree2)
    obs = [("history", client.history), ("served tree", handle.current)]
    mgr.close()
    pub.close()
    return obs


def test_second_sync_is_idempotent_and_history_records(tmp_path):
    _held_against_reference(_second_sync_is_idempotent, tmp_path)


# ---------------------------------------------------------------------------
# the registry push plane
# ---------------------------------------------------------------------------

def _push_plane(ns, root, rng):
    reg = ns.CacheRegistry(root / "registry")
    assert reg.latest_push() is None
    reg.announce_push(step=3, node="pub", manifest_version=2)
    reg.announce_push(step=5, node="pub")
    ann = reg.latest_push()
    assert ann["step"] == 5 and ann["node"] == "pub"

    reg.publish_replica("r0", step=5, phase="serving")
    reg.publish_replica("r1", step=3, target_step=5, phase="fetching")
    status = reg.replica_status()
    assert status["r0"]["lag"] == 0
    assert status["r1"]["lag"] == 2 and status["r1"]["phase"] == "fetching"
    return [("latest push", ann), ("replica status", status)]


def test_push_plane_announce_latest_and_replica_status(tmp_path):
    _held_against_reference(_push_plane, tmp_path)


def _torn_push_announcement(ns, root, rng):
    reg = ns.CacheRegistry(root / "registry")
    reg.announce_push(step=1, node="pub")
    (root / "registry" / "PUSH.json").write_text("{torn")
    assert reg.latest_push() is None               # advisory plane: no crash
    return [("latest push", reg.latest_push())]


def test_torn_push_announcement_reads_as_absent(tmp_path):
    _held_against_reference(_torn_push_announcement, tmp_path)


# ---------------------------------------------------------------------------
# staleness gate (--max-lag-steps)
# ---------------------------------------------------------------------------

def _max_lag_gate_forces_swap(ns, root, rng):
    fab = Fabric(ns, root)
    pub = fab.publisher()
    tree1 = _tree(rng)
    fab.push(pub, 1, tree1)
    mgr, handle, client, _ = fab.follower(tree1, max_lag_steps=1)

    # within the bound: the gate is a no-op (no fetch, no swap)
    tree2 = _mutate(tree1, ["l0"])
    fab.push(pub, 2, tree2)
    assert client.lag() == 1
    assert client.ensure_fresh() == 1 and handle.step == 1

    # past the bound: the gate fetches AND swaps at this boundary
    tree3 = _mutate(tree2, ["l1"])
    fab.push(pub, 3, tree3)
    assert client.lag() == 2
    assert client.ensure_fresh() == 0
    assert handle.step == 3
    _assert_trees_equal(ns, handle.current, tree3)
    obs = [("handle", _handle_state(handle)), ("history", client.history),
           ("served tree", handle.current)]
    mgr.close()
    pub.close()
    return obs


def test_max_lag_gate_forces_swap_when_exceeded(tmp_path):
    _held_against_reference(_max_lag_gate_forces_swap, tmp_path)


def _max_lag_gate_fails_replica(ns, root, rng):
    # the publisher ANNOUNCED a step it never committed (crashed mid-push):
    # the replica keeps serving within the bound; with on_stale="raise" it
    # fails out of rotation — rather than serving unboundedly stale
    # weights — once past it (the drain path is tested below)
    fab = Fabric(ns, root)
    pub = fab.publisher()
    tree1 = _tree(rng)
    fab.push(pub, 1, tree1)
    mgr, handle, client, _ = fab.follower(tree1, max_lag_steps=2, on_stale="raise")

    fab.registry.announce_push(step=9, node="pub")  # never committed
    assert client.sync_once() is None               # keeps serving step 1
    assert handle.step == 1
    with pytest.raises(ns.StaleReplicaError, match="behind") as err:
        client.ensure_fresh()
    assert fab.registry.replica_status()["r0"]["phase"] == "stalled"
    obs = [("error", str(err.value)), ("replica status", fab.registry.replica_status())]

    # no bound configured -> the same situation never raises
    client.max_lag_steps = None
    assert client.ensure_fresh() == 8
    obs.append(("handle", _handle_state(handle)))
    mgr.close()
    pub.close()
    return obs


def test_max_lag_gate_fails_replica_under_paused_publisher(tmp_path):
    _held_against_reference(_max_lag_gate_fails_replica, tmp_path)


def _follow_loop_applies_pushes(ns, root, rng):
    fab = Fabric(ns, root)
    pub = fab.publisher()
    tree1 = _tree(rng)
    fab.push(pub, 1, tree1)
    mgr, handle, client, _ = fab.follower(tree1)
    tree2 = _mutate(tree1, ["l2"])
    fab.push(pub, 2, tree2)
    seen = []
    n = client.follow(poll_s=0.01, max_polls=3, on_sync=seen.append)
    assert n == 1 and [r["step"] for r in seen] == [2]
    assert handle.pending_step == 2                # swap stays engine-owned
    obs = [("synced", n), ("records", seen), ("handle", _handle_state(handle))]
    mgr.close()
    pub.close()
    return obs


def test_follow_loop_applies_pushes(tmp_path):
    _held_against_reference(_follow_loop_applies_pushes, tmp_path)


# ---------------------------------------------------------------------------
# draining admission control (on_stale="drain", the default)
# ---------------------------------------------------------------------------

def _drain_and_readmit(ns, root, rng):
    # same paused-publisher situation as above, default policy: the replica
    # DRAINS (refuses new admissions, keeps serving what it started, shows
    # "draining" fleet-wide) instead of raising mid-batch, and re-admits on
    # the first boundary after it catches up
    fab = Fabric(ns, root)
    pub = fab.publisher()
    tree1 = _tree(rng)
    fab.push(pub, 1, tree1)
    mgr, handle, client, _ = fab.follower(tree1, max_lag_steps=2)

    assert client.admit() and not client.draining   # healthy: admitted

    fab.registry.announce_push(step=9, node="pub")  # never committed
    assert client.ensure_fresh() == 8               # returns lag, no raise
    assert client.draining and client.drain_count == 1
    assert not client.admit()                       # new work refused
    assert client.admit() is False                  # stays draining...
    assert client.drain_count == 1                  # ...but counted ONCE
    assert fab.registry.replica_status()["r0"]["phase"] == "draining"
    assert handle.step == 1                         # still serving step 1
    obs = [("draining status", fab.registry.replica_status())]

    # the publisher recovers and actually commits step 9
    tree9 = _mutate(tree1, ["l0", "l3"])
    fab.push(pub, 9, tree9)
    assert client.admit()                           # caught up: re-admitted
    assert not client.draining and client.readmit_count == 1
    assert handle.step == 9                         # gate forced the swap
    _assert_trees_equal(ns, handle.current, tree9)
    assert fab.registry.replica_status()["r0"]["phase"] == "serving"
    obs += [("counts", [client.drain_count, client.readmit_count]),
            ("serving status", fab.registry.replica_status()),
            ("history", client.history), ("served tree", handle.current)]
    mgr.close()
    pub.close()
    return obs


def test_drain_and_readmit_under_paused_publisher(tmp_path):
    _held_against_reference(_drain_and_readmit, tmp_path)


def _engine_admit_gates_on_sync_client(ns, root, rng):
    # Engine.admit() without a sync client is always True; with one it
    # mirrors the client's drain state (the port's engine, over each
    # package's client)
    from repro_torch.serve.engine import Engine

    eng = object.__new__(Engine)
    eng.sync_client = None
    assert eng.admit()

    fab = Fabric(ns, root)
    pub = fab.publisher()
    tree1 = _tree(rng)
    fab.push(pub, 1, tree1)
    mgr, handle, client, _ = fab.follower(tree1, max_lag_steps=1)
    eng.sync_client = client
    obs = [("admitted", eng.admit())]
    fab.registry.announce_push(step=7, node="pub")  # uncommitted: can't close
    obs.append(("admitted behind an uncommitted push", eng.admit()))
    assert obs == [("admitted", True), ("admitted behind an uncommitted push", False)]
    mgr.close()
    pub.close()
    return obs


def test_engine_admit_gates_on_sync_client(tmp_path):
    _held_against_reference(_engine_admit_gates_on_sync_client, tmp_path)


# ---------------------------------------------------------------------------
# thread safety: follow() thread + boundary ensure_fresh() must never
# double-fetch one step or tear history
# ---------------------------------------------------------------------------

def _sync_once_thread_safe(ns, root, rng):
    fab = Fabric(ns, root)
    pub = fab.publisher()
    tree1 = _tree(rng)
    fab.push(pub, 1, tree1)
    mgr, handle, client, _ = fab.follower(tree1, max_lag_steps=0)

    # a slow, concurrency-counting restore: without the sync lock both
    # threads pass the "target <= have" check before either stages, and
    # the step is fetched twice
    orig = mgr.restore
    calls = {"n": 0, "live": 0, "max_live": 0}
    mu = threading.Lock()

    def slow_restore(*a, **kw):
        with mu:
            calls["n"] += 1
            calls["live"] += 1
            calls["max_live"] = max(calls["max_live"], calls["live"])
        try:
            time.sleep(0.05)
            return orig(*a, **kw)
        finally:
            with mu:
                calls["live"] -= 1
    mgr.restore = slow_restore

    tree2 = _mutate(tree1, ["l0"])
    fab.push(pub, 2, tree2)
    start = threading.Barrier(2)
    errs = []

    def worker(fn):
        try:
            start.wait()
            fn()
        except Exception as e:                      # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=worker, args=(client.sync_once,)),
          threading.Thread(target=worker, args=(client.ensure_fresh,))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs
    assert calls["n"] == 1, "the same step was fetched twice"
    assert calls["max_live"] == 1, "restores overlapped"
    assert [r["step"] for r in client.history] == [2]
    handle.commit_pending()
    _assert_trees_equal(ns, handle.current, tree2)
    obs = [("restores", [calls["n"], calls["max_live"]]),
           ("history", client.history), ("served tree", handle.current)]
    mgr.close()
    pub.close()
    return obs


def test_sync_once_thread_safe_no_double_fetch(tmp_path):
    _held_against_reference(_sync_once_thread_safe, tmp_path)


# ---------------------------------------------------------------------------
# registry fixes: negative-lag clamp + unique-tmp atomic writes
# ---------------------------------------------------------------------------

def _replica_status_clamps(ns, root, rng):
    reg = ns.CacheRegistry(root / "registry")
    reg.announce_push(step=3, node="pub")           # stale announcement
    reg.publish_replica("r0", step=5, phase="serving")  # replica is AHEAD
    status = reg.replica_status()
    # must agree with WeightSyncClient.lag()'s max(0, ...) clamp, not -2
    assert status["r0"]["lag"] == 0
    return [("replica status", status)]


def test_replica_status_clamps_replica_ahead_of_announcement(tmp_path):
    _held_against_reference(_replica_status_clamps, tmp_path)


def _registry_atomic_writes(ns, root, rng):
    # the old fixed `<name>.json.tmp` path let two writers interleave
    # write/rename: one renames the other's half-written tmp (or crashes on
    # a vanished tmp), publishing torn-in-content JSON.  With mkstemp each
    # writer renames only bytes it wrote in full.
    reg = ns.CacheRegistry(root / "registry")
    stop = threading.Event()
    errs: list = []
    torn: list = []

    def writer(tid):
        try:
            for i in range(200):
                reg.announce_push(step=i, node=f"w{tid}")
        except Exception as e:                      # noqa: BLE001
            errs.append(e)
        finally:
            stop.set()

    def reader():
        while not stop.is_set():
            ann = reg.latest_push()
            if ann is not None and ann["node"] not in ("w0", "w1"):
                torn.append(ann)

    ts = [threading.Thread(target=writer, args=(i,)) for i in range(2)]
    rt = threading.Thread(target=reader)
    rt.start()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    stop.set()
    rt.join()
    assert not errs, errs
    assert not torn, torn
    last = reg.latest_push()
    assert last is not None                         # final entry parseable
    assert not list((root / "registry").glob("*.tmp"))  # none leaked
    # which writer landed last is a race; the entry's shape is not
    return [("final entry keys", sorted(last)), ("final step", last["step"])]


def test_registry_atomic_writes_survive_concurrent_writers(tmp_path):
    _held_against_reference(_registry_atomic_writes, tmp_path)


# ---------------------------------------------------------------------------
# pipelined device upload: to_native of push N overlaps the next fetch
# ---------------------------------------------------------------------------

def _pipelined_upload(ns, root, rng):
    fab = Fabric(ns, root)
    pub = fab.publisher()
    tree1 = _tree(rng)
    fab.push(pub, 1, tree1)

    uploaded = []
    gate = threading.Event()

    def slow_to_native(tree):                       # a fake device upload
        gate.wait(5.0)
        uploaded.append(threading.current_thread().name)
        return tree

    mgr, handle, client, _ = fab.follower(tree1, to_native=slow_to_native,
                                          pipeline_uploads=True)

    tree2 = _mutate(tree1, ["l0"])
    fab.push(pub, 2, tree2)
    rec = client.sync_once()                        # returns BEFORE upload
    assert rec is not None and rec["pipelined"]
    assert not uploaded                             # upload still in flight
    assert client.lag() == 0, "in-flight upload must count as have"
    assert client.sync_once() is None               # and dedup the poll

    tree3 = _mutate(tree2, ["l1"])
    fab.push(pub, 3, tree3)
    rec3 = client.sync_once()
    assert rec3["step"] == 3                        # fetch overlaps upload 2
    gate.set()
    client.wait_uploads()
    assert len(uploaded) == 2
    assert all("weight-upload" in n for n in uploaded)
    handle.commit_pending()
    _assert_trees_equal(ns, handle.current, tree3)  # ordered: 3 supersedes 2
    obs = [("records", [rec, rec3]), ("uploads", len(uploaded)),
           ("handle", _handle_state(handle)), ("served tree", handle.current)]
    client.close()
    mgr.close()
    pub.close()
    return obs


def test_pipelined_upload_counts_inflight_and_stages_in_order(tmp_path):
    _held_against_reference(_pipelined_upload, tmp_path)


# ---------------------------------------------------------------------------
# the tentpole, single-process: a follower that synced step N advertises its
# chunk inventory, and the NEXT replica pulls the delta from it — zero
# shared-tier bytes
# ---------------------------------------------------------------------------

def _follower_advertises(ns, root, rng):
    fab = Fabric(ns, root)
    # publisher never promotes: the ONLY non-shared source any replica can
    # use is another replica's follower cache
    pub = ns.CheckpointManager(fab.store_for("pub"), _pol(ns, promote="off"),
                               node="pub", registry=fab.registry)
    tree1 = _tree(rng)
    fab.push(pub, 1, tree1)

    mgr1 = fab.replica_manager("r1")
    host1, _ = mgr1.restore(tree1, 1, promote=False, follower_cache=True)
    st1 = mgr1.last_restore_stats
    assert st1["follower_advertised"] and st1["chunks_teed"] > 0
    ent = fab.registry.follower_entries()
    assert ent["r1"]["step"] == 1 and ent["r1"]["kind"] == "follower"
    # chunk-only entries never reach the shard fabric's source list
    assert "r1" not in fab.registry.warm_peers(1)
    assert "r1" in fab.registry.near_peers(1)
    obs = [("r1 restore", [st1["bytes_by_tier"], st1["chunks_teed"]]),
           ("entries after r1's restore", ent)]

    handle1 = ns.ParamHandle(host1, step=1)
    client1 = ns.WeightSyncClient(mgr1, handle1, tree1, registry=fab.registry,
                                  replica="r1")
    tree2 = _mutate(tree1, ["l0"])
    save_stats = pub.save(2, tree2)
    fab.push(pub, 2, tree2)
    delta_bytes = save_stats["delta"]["bytes_written"]
    rec1 = client1.sync_once()
    assert rec1["follower_advertised"]
    assert fab.registry.follower_entries()["r1"]["step"] == 2
    obs.append(("r1 sync record", rec1))

    # replica 2, cold on this node family: the whole step-2 fetch must be
    # served by r1's follower cache — zero shared-tier payload bytes
    mgr2 = fab.replica_manager("r2")
    host2, _ = mgr2.restore(tree1, 2, promote=False, follower_cache=True)
    st2 = mgr2.last_restore_stats
    by_tier = st2["bytes_by_tier"]
    assert by_tier.get("shared", 0) == 0, by_tier
    peer_bytes = sum(v for t, v in by_tier.items() if ns.is_peer_tier(t))
    assert peer_bytes > delta_bytes                 # full tree, from r1
    _assert_trees_equal(ns, host2, tree2)
    assert fab.registry.follower_entries()["r2"]["step"] == 2
    obs += [("r2 bytes by tier", by_tier), ("r2 tree", host2),
            ("entries after r2's restore", fab.registry.follower_entries())]

    # invalidation withdraws the follower entry with the cache
    mgr2.invalidate_promoted()
    assert "r2" not in fab.registry.follower_entries()
    obs.append(("entries after the invalidation", sorted(fab.registry.follower_entries())))
    mgr1.close()
    mgr2.close()
    pub.close()
    return obs


def test_follower_advertises_and_serves_next_replica(tmp_path):
    _held_against_reference(_follower_advertises, tmp_path)


# ---------------------------------------------------------------------------
# engine boundary: a push staged MID-DECODE never tears the loop — all n
# tokens come from one tree, and the swap lands at the next boundary
# ---------------------------------------------------------------------------

def test_engine_swap_never_tears_mid_decode(rng):
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Engine

    cfg = reduced(get_config("llama3.2-1b")).replace(num_layers=2)
    batch, prompt, max_seq = 2, 8, 32
    p1 = M.init_params(cfg, 0, "cpu")
    p2 = M.init_params(cfg, 1, "cpu")
    prompts = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (batch, prompt)), dtype=torch.int32)}

    # reference: uninterrupted generation on p1
    ref = Engine(cfg, p1, batch=batch, max_seq=max_seq)
    ref.prefill(prompts)
    ref_tokens = ref.generate(8)

    # follower engine: p2 lands mid-loop via on_token (the sync thread's
    # stage), and MUST NOT affect the remaining tokens of this call
    handle = ParamHandle(p1, step=1)
    eng = Engine(cfg, handle, batch=batch, max_seq=max_seq)
    eng.prefill(prompts)

    def stage_midway(tok, _calls=[]):
        _calls.append(tok)
        if len(_calls) == 2:
            handle.stage(p2, 2)

    first = eng.generate(4, on_token=stage_midway)
    np.testing.assert_array_equal(first, ref_tokens[:, :4])
    assert handle.step == 1 and handle.pending_step == 2

    # the cache is updated in place by decode: copy it for the second engine
    snap = {"cache": {k: ({n: x.clone() for n, x in v.items()} if isinstance(v, dict)
                          else v.clone()) for k, v in eng.cache.items()},
            "last_tokens": eng.last_tokens.clone()}

    # continuation AFTER the boundary: identical to an engine that was born
    # on p2 and restored at the same point
    rest = eng.generate(4)             # maybe_swap() flips to p2 here
    assert handle.step == 2 and handle.swap_count == 1

    eng2 = Engine(cfg, p2, batch=batch, max_seq=max_seq)
    eng2.restore(snap)
    rest_ref = eng2.generate(4)
    np.testing.assert_array_equal(rest, rest_ref)
