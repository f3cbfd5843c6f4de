"""The port's miniature Slurm and restore-aware placement (the scenarios of
tests/test_placement.py, on ``repro_torch``): a preempted trainer requeued
onto its warm node restores with zero shared-tier bytes and finishes bit for
bit on the uninterrupted run; a blind baseline does not; under injected
faults (torn marker, truncated promoted shard, stale marker, a kill mid
promotion) the scheduler never restores stale bytes and always converges.

Two kinds of job: the port's real trainer (``python -m
repro_torch.launch.train --device cpu --reduced``), preempted scancel-style
after its first step, where a whole training state is the point; and, where a
fault has to be planted inside the job or the peer fabric switched off, the
numpy job at the end of this file (run as ``python tests/test_torch_sched.py
--ckpt-dir D --report-dir R ...``), which restores, advances a deterministic
tree, commits and exits 85 until its step budget is done.

Every placement the port's scheduler makes is held against the reference
(``repro.sched.placement``): each ``rank_nodes`` and ``warm_peer_roots`` call
is repeated with the reference's on the same node directories, and the
scores, probe states (valid, step, latest, files, reason) and peer hints
must be equal.  Each cache-inventory state is probed by both packages'
``validate_promoted_cache`` on the same store.  The trainer child has no
reference counterpart here: the reference's trainer needs JAX's sharding."""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import faults
from repro.checkpoint.manager import validate_promoted_cache as ref_validate_promoted_cache
from repro.checkpoint.store import TieredStore as RefStore
from repro.sched import placement as RPL
from repro_torch.checkpoint.manager import (CheckpointManager, CheckpointPolicy,
                                            validate_promoted_cache)
from repro_torch.checkpoint.store import (TieredStore, is_peer_tier,
                                          node_local_tier_roots)
from repro_torch.core.requeue import RequeueFile, WalltimeTracker, detect_node
from repro_torch.sched.cache_registry import (ENV_PEER_ROOTS, REGISTRY_DIRNAME,
                                              CacheRegistry, parse_peer_roots)
from repro_torch.sched import placement as PL
from repro_torch.sched.placement import (SCORE_COLD, SCORE_HINT, SCORE_WARM,
                                         CacheAffinity, rank_nodes)
from repro_torch.sched.slurmsim import REQUEUE_EXIT, JobSpec, SlurmSim

JOB = Path(__file__).resolve()
SRC = str(JOB.parents[1] / "src")
TRAIN = ["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu", "--batch", "2",
         "--seq", "16", "--steps", "3", "--step-sleep", "0.3"]


# ---------------------------------------------------------------------------
# the numpy job
# ---------------------------------------------------------------------------

class CountingStore(faults.ByteCountingStoreMixin, TieredStore):
    """Counts every byte fetched, by tier: the job's evidence for the
    zero-shared-bytes assertions."""


def make_tree() -> dict:
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((128, 64)).astype(np.float32),
            "b": rng.standard_normal((4096,)).astype(np.float32),
            "k": rng.standard_normal((16384,)).astype(np.float32)}


def advance(tree: dict) -> dict:
    """One deterministic 'training step'."""
    return {k: (v + 1.0).astype(v.dtype) for k, v in tree.items()}


def state_sum(tree: dict) -> float:
    return float(sum(np.asarray(v, np.float64).sum() for v in tree.values()))


def expected_sum(total_steps: int) -> float:
    """``state_sum`` after ``total_steps`` committed steps: no stale bytes
    were ever restored."""
    tree = make_tree()
    return state_sum(tree) + total_steps * float(sum(v.size for v in tree.values()))


def job_main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--report-dir", required=True)
    ap.add_argument("--total-steps", type=int, default=3)
    ap.add_argument("--promote", default="eager", choices=["off", "on_restore", "eager"])
    ap.add_argument("--mode", default="normal", choices=["normal", "kill-mid-promotion"])
    ap.add_argument("--kill-on-attempt", type=int, default=0)
    ap.add_argument("--peer-discovery", default="env", choices=["env", "registry", "off"])
    args = ap.parse_args(argv)

    node = detect_node() or "?"
    attempt = int(os.environ.get("SLURM_RESTART_COUNT", "0"))
    local_root = os.environ.get("REPRO_LOCAL_ROOT")
    store = CountingStore(Path(args.ckpt_dir), seed=0,
                          tier_roots=node_local_tier_roots(local_root) if local_root else None)
    peers = (parse_peer_roots(os.environ.get(ENV_PEER_ROOTS))
             if args.peer_discovery == "env" else {})
    registry = (CacheRegistry(Path(args.ckpt_dir) / REGISTRY_DIRNAME)
                if args.peer_discovery == "registry" else None)
    m = CheckpointManager(store, CheckpointPolicy(replicas=1, promote=args.promote),
                          peer_roots=peers, node=node, registry=registry)
    if args.mode == "kill-mid-promotion" and attempt == args.kill_on_attempt:
        def torn_copy(src_tier, rel, dst_tier, **kw):
            # the copier dies mid-copy: a torn .tmp and NO marker must be all
            # it leaves (two-phase promotion)
            src = store.replica_paths(src_tier, rel)[0]
            dst = store._node_dirs(dst_tier)[0] / rel
            dst.parent.mkdir(parents=True, exist_ok=True)
            raw = src.read_bytes()
            dst.with_suffix(dst.suffix + ".tmp").write_bytes(raw[: len(raw) // 2])
            os._exit(REQUEUE_EXIT)              # SIGKILL-like node loss

        store.copy_file = torn_copy

    restore_stats = None
    try:
        tree, man = m.restore(make_tree())
        start = man["step"] + 1
        restore_stats = m.last_restore_stats
    except FileNotFoundError:
        tree, start = make_tree(), 0
    reads = dict(store.read_by_tier)
    last = start - 1
    if start < args.total_steps:                # one step a life
        tree, last = advance(tree), start
        m.save(last, tree)
        m.commit(last)
        m.wait_promotions()                     # never returns under the kill mode
        RequeueFile(Path(args.ckpt_dir) / "requeue.json").save(
            WalltimeTracker(limit_s=1e9), last, reason="life-end", node=node)
    report = {"attempt": attempt, "node": node, "start_step": start, "last_step": last,
              "restore_stats": restore_stats, "restore_reads_by_tier": reads,
              "peer_read_bytes": sum(v for t, v in reads.items() if is_peer_tier(t)),
              "state_sum": state_sum(tree)}
    rdir = Path(args.report_dir)
    rdir.mkdir(parents=True, exist_ok=True)
    (rdir / f"attempt_{attempt:02d}.json").write_text(json.dumps(report))
    m.close()
    return 0 if last >= args.total_steps - 1 else REQUEUE_EXIT


def job_spec(ckpt, rdir, *, total=3, warm_wait_s=5.0, name="job", **opts):
    cmd = [sys.executable, str(JOB), "--ckpt-dir", str(ckpt), "--report-dir", str(rdir),
           "--total-steps", str(total)]
    for k, v in opts.items():
        cmd += [f"--{k.replace('_', '-')}", str(v)]
    return JobSpec(name=name, cmd=cmd, walltime_s=120, env={"PYTHONPATH": SRC},
                   cache_affinity=CacheAffinity(ckpt_dir=str(ckpt), warm_wait_s=warm_wait_s))


def reports(rdir: Path) -> list[dict]:
    return [json.loads(p.read_text()) for p in sorted(Path(rdir).glob("attempt_*.json"))]


def node_ckpt_root(sim: SlurmSim, name: str) -> Path:
    """A node's local-tier checkpoint prefix (the local tier has one node
    dir, ``node0``, inside every cluster node's root)."""
    return sim.node(name).local_root / "local" / "node0" / "ckpt"


# ---------------------------------------------------------------------------
# the reference beside the port
# ---------------------------------------------------------------------------

def _ref_affinity(aff: CacheAffinity) -> RPL.CacheAffinity:
    return RPL.CacheAffinity(**dataclasses.asdict(aff))


@pytest.fixture
def ref_ranks(monkeypatch):
    """Every placement probe the port's scheduler makes, repeated by the
    reference on the same node directories: a list of (what, port's answer,
    reference's answer)."""
    pairs = []
    port_rank, port_peers = PL.rank_nodes, PL.warm_peer_roots

    def rank_both(candidates, aff, last_node=None):
        got = port_rank(candidates, aff, last_node=last_node)
        pairs.append(("rank_nodes", got,
                      RPL.rank_nodes(candidates, _ref_affinity(aff), last_node=last_node)))
        return got

    def peers_both(candidates, ranked, exclude=()):
        got = port_peers(candidates, ranked, exclude=exclude)
        pairs.append(("warm_peer_roots", got,
                      RPL.warm_peer_roots(candidates, ranked, exclude=exclude)))
        return got

    monkeypatch.setattr(PL, "rank_nodes", rank_both)
    monkeypatch.setattr(PL, "warm_peer_roots", peers_both)
    return pairs


def assert_ranks_match(pairs: list, sim: SlurmSim, ckpt: Path) -> None:
    """The scheduler's probes agreed with the reference's, and so do both
    packages' probes of every node's cache as the run left it."""
    aff = CacheAffinity(ckpt_dir=str(ckpt))
    nodes = [(nd.name, nd.local_root) for nd in sim.nodes]
    if sim.placement != "blind":
        assert any(what == "rank_nodes" for what, _, _ in pairs), "no placement was probed"
    pairs = pairs + [("final rank_nodes", rank_nodes(nodes, aff),
                      RPL.rank_nodes(nodes, _ref_affinity(aff)))]
    for what, got, want in pairs:
        assert got == want, (what, got, want)


def same_probe(root: Path, tier_roots=None, **kw) -> dict:
    """``validate_promoted_cache`` of the port and of the reference on one
    store directory; they must agree.  Returns the port's."""
    got = validate_promoted_cache(TieredStore(root, seed=0, tier_roots=tier_roots), **kw)
    want = ref_validate_promoted_cache(RefStore(root, seed=0, tier_roots=tier_roots), **kw)
    assert got == want, (got, want)
    return got


# ---------------------------------------------------------------------------
# the port's trainer under the scheduler
# ---------------------------------------------------------------------------

def _trainer_spec(ckpt: Path, metrics: Path, *extra) -> JobSpec:
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *TRAIN, "--ckpt-dir", str(ckpt),
           "--metrics-out", str(metrics), "--ckpt-promote", "eager", *extra]
    return JobSpec(name="train", cmd=cmd, walltime_s=300, env={"PYTHONPATH": SRC},
                   cache_affinity=CacheAffinity(ckpt_dir=str(ckpt), warm_wait_s=5.0))


def _run_preempted_after_first_step(sim: SlurmSim, spec: JobSpec, metrics: Path) -> dict:
    """Run ``spec`` to its end, preempting (SIGTERM, scancel-style) its first
    attempt once that has logged step 0.  Returns each attempt's metrics."""
    jid = sim.submit(spec)
    per_attempt: dict = {}

    def keep_metrics(rec):                      # before each launch: the last attempt's
        if rec.requeues and metrics.exists():
            per_attempt[rec.requeues - 1] = json.loads(metrics.read_text())

    sim.pre_launch = keep_metrics
    out = sim.workdir / f"{spec.name}.out"

    def preempt_after_step0():
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if out.exists() and "step 0 loss" in out.read_text():
                sim.preempt(jid)
                return
            time.sleep(0.05)

    watcher = threading.Thread(target=preempt_after_step0, daemon=True)
    watcher.start()
    sim.run(timeout_s=240)
    watcher.join(timeout=5)
    rec = sim.job(jid)
    per_attempt[rec.requeues] = json.loads(metrics.read_text())
    return {"rec": rec, "metrics": per_attempt, "log": out.read_text()}


def test_preempted_trainer_requeues_onto_its_warm_node(tmp_path, ref_ranks):
    ref_metrics = tmp_path / "ref.json"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *TRAIN, "--step-sleep", "0",
         "--ckpt-dir", str(tmp_path / "ref"), "--metrics-out", str(ref_metrics)],
        env={**os.environ, "PYTHONPATH": SRC}, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    ref = json.loads(ref_metrics.read_text())

    ckpt, metrics = tmp_path / "ck", tmp_path / "m.json"
    sim = SlurmSim(tmp_path / "sim", nodes=2)
    run = _run_preempted_after_first_step(sim, _trainer_spec(ckpt, metrics), metrics)
    rec = run["rec"]
    assert rec.state == "COMPLETED", (rec.exit_codes, run["log"][-3000:])
    assert rec.exit_codes == [REQUEUE_EXIT, 0]
    assert rec.placements[1] == rec.placements[0]
    entry = rec.placement_log[1]
    assert entry["node"] == rec.placements[0]
    assert entry["scores"][rec.placements[0]] == SCORE_WARM, entry
    st = run["metrics"][1]["restore_stats"]
    assert st["promoted"] is True and st["tier"] == "local", st
    assert st["bytes_by_tier"].get("shared", 0) == 0 and st["bytes_by_tier"]["local"] > 0
    steps = run["metrics"][0]["steps"] + run["metrics"][1]["steps"]
    assert [s["step"] for s in steps] == [s["step"] for s in ref["steps"]]
    assert [s["loss"] for s in steps] == [s["loss"] for s in ref["steps"]]
    assert "SLURMSIM_NODE" not in os.environ      # the sim sets it for the job only
    assert_ranks_match(ref_ranks, sim, ckpt)


def test_trainer_blind_placement_restores_cold(tmp_path, ref_ranks):
    """Round-robin placement requeues onto the other node: nothing is promoted
    there, so the restore reads no local byte.  The trainer always keeps the
    registry's peer fabric, so the bytes come from node0 over the fabric or
    from the shared tier (the numpy job below turns the fabric off)."""
    ckpt, metrics = tmp_path / "ck", tmp_path / "m.json"
    sim = SlurmSim(tmp_path / "sim", nodes=2, placement="blind")
    run = _run_preempted_after_first_step(sim, _trainer_spec(ckpt, metrics), metrics)
    rec = run["rec"]
    assert rec.state == "COMPLETED", (rec.exit_codes, run["log"][-3000:])
    assert rec.exit_codes == [REQUEUE_EXIT, 0]
    assert rec.placements == ["node0", "node1"]
    assert rec.placement_log[1]["policy"] == "blind"
    st = run["metrics"][1]["restore_stats"]
    assert not st["promoted"] and st["bytes_by_tier"].get("local", 0) == 0, st
    assert set(st["bytes_by_tier"]) <= {"shared", "peer:node0"}, st
    assert st["bytes_read"] > 0
    assert_ranks_match(ref_ranks, sim, ckpt)


# ---------------------------------------------------------------------------
# the numpy job: warm requeues, and every injected fault converges
# ---------------------------------------------------------------------------

def test_warm_node_requeue_restores_zero_shared_bytes(tmp_path, ref_ranks):
    ckpt, rdir = tmp_path / "ck", tmp_path / "reports"
    sim = SlurmSim(tmp_path / "sim", nodes=2)
    jid = sim.submit(job_spec(ckpt, rdir, total=3))
    sim.run(timeout_s=120)
    rec = sim.job(jid)
    assert rec.state == "COMPLETED", (rec.state, rec.exit_codes)
    assert rec.exit_codes == [REQUEUE_EXIT] * 2 + [0]
    assert rec.placements == ["node0"] * 3
    reps = reports(rdir)
    assert [r["attempt"] for r in reps] == [0, 1, 2]
    for r in reps[1:]:
        assert r["restore_stats"]["promoted"] is True
        assert r["restore_stats"]["tier"] == "local"
        assert r["restore_reads_by_tier"].get("shared", 0) == 0, r
        assert r["restore_reads_by_tier"].get("local", 0) > 0
    for entry in rec.placement_log[1:]:
        assert entry["scores"]["node0"] == SCORE_WARM and entry["node"] == "node0"
    assert reps[-1]["state_sum"] == pytest.approx(expected_sum(3))
    assert_ranks_match(ref_ranks, sim, ckpt)


def test_blind_placement_baseline_reads_shared_bytes(tmp_path, ref_ranks):
    ckpt, rdir = tmp_path / "ck", tmp_path / "reports"
    sim = SlurmSim(tmp_path / "sim", nodes=2, placement="blind")
    jid = sim.submit(job_spec(ckpt, rdir, total=2))
    sim.run(timeout_s=120)
    rec = sim.job(jid)
    assert rec.state == "COMPLETED", (rec.state, rec.exit_codes)
    assert rec.placements == ["node0", "node1"]
    r1 = reports(rdir)[1]
    assert r1["node"] == "node1"
    assert not (r1["restore_stats"] or {}).get("promoted")
    assert r1["restore_reads_by_tier"].get("shared", 0) > 0
    assert r1["state_sum"] == pytest.approx(expected_sum(2))
    assert_ranks_match(ref_ranks, sim, ckpt)


def test_torn_marker_is_cold_not_fatal(tmp_path, ref_ranks):
    """PROMOTED.json torn mid-write reads as cold, placement falls back to the
    requeue hint, and the restore comes from the shared tier."""
    ckpt, rdir = tmp_path / "ck", tmp_path / "reports"
    torn = []

    def hook(rec):
        if rec.requeues == 1:
            marker = node_ckpt_root(sim, "node0") / "PROMOTED.json"
            faults.tear_json(marker)
            torn.append(str(marker))

    sim = SlurmSim(tmp_path / "sim", nodes=2, pre_launch=hook)
    jid = sim.submit(job_spec(ckpt, rdir, total=2, warm_wait_s=0.0))
    sim.run(timeout_s=120)
    rec = sim.job(jid)
    assert torn and rec.state == "COMPLETED", (rec.state, rec.exit_codes)
    entry = rec.placement_log[1]
    assert entry["reasons"]["node0"] == "torn promoted marker"
    assert entry["scores"]["node0"] == SCORE_HINT
    r1 = reports(rdir)[1]
    assert not (r1["restore_stats"] or {}).get("promoted")
    assert r1["restore_reads_by_tier"].get("shared", 0) > 0
    assert r1["state_sum"] == pytest.approx(expected_sum(2))
    assert_ranks_match(ref_ranks, sim, ckpt)


def test_truncated_promoted_shard_falls_back_to_shared(tmp_path, ref_ranks):
    """Marker intact, a promoted shard truncated, and the damaged node the only
    one: the probe and the restore both notice, and shared serves the bytes."""
    ckpt, rdir = tmp_path / "ck", tmp_path / "reports"
    truncated = []

    def hook(rec):
        if rec.requeues == 1:
            shards = sorted(node_ckpt_root(sim, "node0").glob("step_*/shard_*.bin"))
            assert shards, "no promoted shard to truncate"
            faults.truncate_file(shards[0])
            truncated.append(str(shards[0]))
            probe = same_probe(Path(ckpt), {"local": sim.node("node0").local_root})
            assert not probe["valid"] and probe["reason"].startswith("size mismatch")

    sim = SlurmSim(tmp_path / "sim", nodes=1, pre_launch=hook)
    jid = sim.submit(job_spec(ckpt, rdir, total=2, warm_wait_s=0.0))
    sim.run(timeout_s=120)
    rec = sim.job(jid)
    assert truncated and rec.state == "COMPLETED", (rec.state, rec.exit_codes)
    r1 = reports(rdir)[1]
    assert not (r1["restore_stats"] or {}).get("promoted")
    assert r1["restore_reads_by_tier"].get("shared", 0) > 0
    assert r1["state_sum"] == pytest.approx(expected_sum(2))
    assert_ranks_match(ref_ranks, sim, ckpt)


def test_mid_promotion_kill_leaves_no_marker_and_recovers(tmp_path, ref_ranks):
    ckpt, rdir = tmp_path / "ck", tmp_path / "reports"
    observed = {}

    def hook(rec):
        if rec.requeues == 1:                   # right after the death mid-promotion
            root = node_ckpt_root(sim, "node0")
            observed["marker_exists"] = (root / "PROMOTED.json").exists()
            observed["torn_tmps"] = [str(p) for p in root.rglob("*.tmp")]

    sim = SlurmSim(tmp_path / "sim", nodes=2, pre_launch=hook)
    jid = sim.submit(job_spec(ckpt, rdir, total=3, warm_wait_s=0.0,
                              mode="kill-mid-promotion", kill_on_attempt=0))
    sim.run(timeout_s=120)
    rec = sim.job(jid)
    assert rec.state == "COMPLETED", (rec.state, rec.exit_codes)
    assert rec.exit_codes[0] == REQUEUE_EXIT
    assert observed["marker_exists"] is False, "a torn promotion published a marker"
    assert observed["torn_tmps"], "the kill did not land mid-copy"
    assert rec.placement_log[1]["reasons"]["node0"] == "no promoted marker"
    reps = reports(rdir)
    assert reps[0]["attempt"] == 1 and reps[0]["start_step"] == 1
    assert reps[0]["restore_reads_by_tier"].get("shared", 0) > 0
    assert reps[-1]["state_sum"] == pytest.approx(expected_sum(3))
    assert_ranks_match(ref_ranks, sim, ckpt)


def test_stale_marker_is_never_served(tmp_path, ref_ranks):
    """A newer step committed elsewhere supersedes node0's promoted cache: the
    probe reads it as stale and the restore serves the NEW bytes."""
    ckpt, rdir = tmp_path / "ck", tmp_path / "reports"
    ext_tree = {k: np.full_like(v, 7.0) for k, v in make_tree().items()}
    injected = []

    def hook(rec):
        if rec.requeues == 1:
            ext = CheckpointManager(TieredStore(Path(ckpt)), CheckpointPolicy(replicas=1))
            ext.save(5, ext_tree)
            ext.commit(5)
            ext.close()
            injected.append(5)

    sim = SlurmSim(tmp_path / "sim", nodes=2, pre_launch=hook)
    jid = sim.submit(job_spec(ckpt, rdir, total=2, warm_wait_s=0.0))
    sim.run(timeout_s=120)
    rec = sim.job(jid)
    assert injected and rec.state == "COMPLETED", (rec.state, rec.exit_codes)
    entry = rec.placement_log[1]
    assert entry["reasons"]["node0"].startswith("stale")
    assert entry["scores"]["node0"] == SCORE_HINT
    r1 = reports(rdir)[1]
    assert not (r1["restore_stats"] or {}).get("promoted")
    assert r1["state_sum"] == pytest.approx(state_sum(ext_tree))
    assert_ranks_match(ref_ranks, sim, ckpt)


# ---------------------------------------------------------------------------
# bounded wait for the warm node
# ---------------------------------------------------------------------------

def _warm_node0(sim: SlurmSim, ckpt: Path) -> None:
    store = TieredStore(Path(ckpt), tier_roots={"local": sim.node("node0").local_root})
    m = CheckpointManager(store, CheckpointPolicy(replicas=1, promote="eager"))
    m.save(0, make_tree())
    m.commit(0)
    m.wait_promotions()
    m.close()
    assert same_probe(Path(ckpt), {"local": sim.node("node0").local_root})["valid"]


def _blocker_spec(seconds: float) -> JobSpec:
    return JobSpec(name="blocker", cmd=[sys.executable, "-c", f"import time; time.sleep({seconds})"],
                   walltime_s=60, requeue=False)


def test_bounded_wait_waits_for_busy_warm_node(tmp_path, ref_ranks):
    ckpt, rdir = tmp_path / "ck", tmp_path / "reports"
    sim = SlurmSim(tmp_path / "sim", nodes=2)
    _warm_node0(sim, ckpt)
    sim.submit(_blocker_spec(1.2))                     # occupies node0
    jid = sim.submit(job_spec(ckpt, rdir, total=1, warm_wait_s=30.0))
    sim.run(timeout_s=120)
    rec = sim.job(jid)
    assert rec.state == "COMPLETED", (rec.state, rec.exit_codes)
    entry = rec.placement_log[0]
    assert entry["node"] == "node0" and entry["waited_s"] >= 0.5
    r0 = reports(rdir)[0]
    assert r0["restore_stats"]["promoted"] is True
    assert r0["restore_reads_by_tier"].get("shared", 0) == 0
    assert_ranks_match(ref_ranks, sim, ckpt)


@pytest.mark.parametrize("fabric", ["env", "off"])
def test_bounded_wait_expires(tmp_path, fabric, ref_ranks):
    """The wait budget runs out with the warm node still busy, so the job is
    placed cold.  With the fabric it is handed the warm node as a peer and
    restores over it (zero shared bytes); with the fabric off it pays
    shared-filesystem bytes."""
    ckpt, rdir = tmp_path / "ck", tmp_path / "reports"
    sim = SlurmSim(tmp_path / "sim", nodes=2)
    _warm_node0(sim, ckpt)
    sim.submit(_blocker_spec(2.5))
    jid = sim.submit(job_spec(ckpt, rdir, total=1, warm_wait_s=0.15,
                              peer_discovery=fabric))
    sim.run(timeout_s=120)
    rec = sim.job(jid)
    assert rec.state == "COMPLETED", (rec.state, rec.exit_codes)
    entry = rec.placement_log[0]
    assert entry["node"] == "node1" and 0.15 <= entry["waited_s"] < 2.0
    assert entry["peers"] == ["node0"]
    r0 = reports(rdir)[0]
    assert not (r0["restore_stats"] or {}).get("promoted")
    if fabric == "env":
        assert (r0["restore_stats"] or {}).get("peer") is True
        assert r0["restore_reads_by_tier"].get("shared", 0) == 0, r0
        assert r0["peer_read_bytes"] > 0
    else:
        assert r0["restore_reads_by_tier"].get("shared", 0) > 0
    assert r0["state_sum"] == pytest.approx(state_sum(make_tree()))
    assert_ranks_match(ref_ranks, sim, ckpt)


# ---------------------------------------------------------------------------
# cache inventory and the requeue-record hint (in process, no scheduler)
# ---------------------------------------------------------------------------

def test_cache_inventory_validation_states(tmp_path):
    rng = np.random.default_rng(0)
    store = TieredStore(tmp_path, seed=0)
    m = CheckpointManager(store, CheckpointPolicy(replicas=1, promote="eager", keep_last=10))
    tree = {"w": rng.standard_normal((256,)).astype(np.float32),
            "b": rng.standard_normal((64,)).astype(np.float32)}
    m.save(1, tree)
    m.commit(1)
    m.wait_promotions()
    inv = m.cache_inventory()
    assert inv == same_probe(tmp_path)
    assert inv["valid"] and inv["step"] == inv["latest"] == 1
    assert inv["reason"] == "warm" and inv["files"] >= 1

    # a newer commit without promotion -> stale
    m_off = CheckpointManager(store, CheckpointPolicy(replicas=1, promote="off", keep_last=10))
    m_off.save(2, tree)
    m_off.commit(2)
    inv = same_probe(tmp_path)
    assert not inv["valid"] and inv["reason"].startswith("stale")
    assert inv["step"] == 1 and inv["latest"] == 2

    # re-promote the latest, then damage it in ever subtler ways
    m.prefetch_latest()
    m.wait_promotions()
    assert same_probe(tmp_path)["valid"]
    local = store.root / "local" / "node0" / "ckpt"
    shard = sorted(local.glob("step_*/shard_*.bin"))[-1]
    faults.truncate_file(shard)
    inv = same_probe(tmp_path)
    assert not inv["valid"] and inv["reason"].startswith("size mismatch")
    shard.unlink()
    inv = same_probe(tmp_path)
    assert not inv["valid"] and inv["reason"].startswith("missing promoted")
    faults.tear_json(local / "PROMOTED.json")
    inv = same_probe(tmp_path)
    assert not inv["valid"] and inv["reason"] == "torn promoted marker"
    m.close()
    m_off.close()


def test_requeue_record_hint_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setenv("SLURMSIM_NODE", "nodeX")
    rf = RequeueFile(tmp_path / "requeue.json")
    rec = rf.save(WalltimeTracker(limit_s=10), last_step=3, reason="test")
    assert rec["node"] == "nodeX" and rec["placements"] == ["nodeX"]
    aff = CacheAffinity(ckpt_dir=str(tmp_path))
    assert aff.requeue_record()["node"] == "nodeX"
    ref_aff = _ref_affinity(aff)
    assert ref_aff.requeue_record() == aff.requeue_record()    # the reference reads it alike
    nodes = [("nodeX", tmp_path / "a"), ("nodeY", tmp_path / "b")]
    ranked = rank_nodes(nodes, aff)
    assert ranked["nodeX"]["score"] == SCORE_HINT
    assert ranked["nodeY"]["score"] == SCORE_COLD
    assert ranked == RPL.rank_nodes(nodes, ref_aff)


if __name__ == "__main__":
    sys.exit(job_main())
