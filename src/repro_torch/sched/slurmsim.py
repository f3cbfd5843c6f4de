"""A miniature Slurm for integration tests — real subprocesses, real signals.

Reproduces the scheduler behaviours the paper's workflow (Fig. 3) depends on:
  * walltime limits with an advance-warning signal (``--signal=B:USR1@60``):
    jobs get ``warn_signal`` ``signal_margin_s`` before the limit, then SIGKILL;
  * requeue on preemption / timeout / exit code 85 (REQUEUE_EXIT), appending
    output (``open(..., "ab")`` — the paper's append-mode logging);
  * manual preemption (``scancel``-style) for tests;
  * a job comment file tracking consumed walltime across requeues (the
    paper's ``--comment`` accounting — survives even a fresh SlurmSim).
    Accounting is keyed by job NAME so a resubmission resumes its budget;
    reuse a name only for resubmissions, never for concurrent unrelated
    jobs in one workdir;
  * a small multi-node cluster model with restore-aware placement: each
    ``NodeSpec`` owns a node-local tier root, and a requeued job with a
    ``cache_affinity`` is preferentially placed on the node whose promoted
    checkpoint cache is warm for its latest committed step (the paper's
    container-image-cache effect, scheduler-side), with a bounded
    wait-for-warm-node policy before falling back to any free node — and a
    job that ends up on a COLD node is handed the warm nodes as a peer hint
    (``REPRO_PEER_ROOTS``) so its restore sources the checkpoint from a warm
    peer's local cache instead of the shared filesystem.

The "cluster" is this machine; each node is a directory (its local tier
root), each job one subprocess.  Jobs learn their placement through
``SLURMSIM_NODE`` / ``SLURMD_NODENAME`` and mount the node's local tier via
``REPRO_LOCAL_ROOT`` (see launch/train.py).
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import time
from pathlib import Path
from typing import Callable, Optional

from repro_torch.sched import cache_registry as CR
from repro_torch.sched import placement as PL

REQUEUE_EXIT = 85     # exit code meaning "checkpointed, please requeue"


@dataclasses.dataclass
class NodeSpec:
    """One cluster node: a name, a job capacity (``slots=0`` = unlimited —
    the single-machine mode), and a node-local filesystem root (the per-node
    ``local``/``ram`` tier mount — promotion caches land here)."""

    name: str
    slots: int = 1
    local_root: Optional[Path] = None


@dataclasses.dataclass
class JobSpec:
    name: str
    cmd: list
    walltime_s: float
    signal_margin_s: float = 5.0
    warn_signal: int = signal.SIGUSR1
    requeue: bool = True
    max_requeues: int = 10
    env: Optional[dict] = None
    cwd: Optional[str] = None
    cache_affinity: Optional[PL.CacheAffinity] = None


@dataclasses.dataclass
class JobRecord:
    job_id: int
    spec: JobSpec
    state: str = "PENDING"          # PENDING RUNNING COMPLETED FAILED REQUEUED
    requeues: int = 0
    exit_codes: list = dataclasses.field(default_factory=list)
    started_at: float = 0.0
    warned: bool = False
    proc: Optional[subprocess.Popen] = None
    preempt_requested: bool = False
    node: Optional[str] = None              # current / last placement
    consumed_s: float = 0.0                 # walltime across all attempts
    pending_since: float = 0.0              # for the bounded warm-node wait
    placements: list = dataclasses.field(default_factory=list)
    placement_log: list = dataclasses.field(default_factory=list)
    peer_hint: dict = dataclasses.field(default_factory=dict)  # node -> root


class SlurmSim:
    """``nodes`` may be an int (that many one-slot nodes, local roots under
    ``workdir/nodes/``) or a list of ``NodeSpec``.  ``placement`` selects the
    policy: ``"affinity"`` (restore-aware scoring via ``sched/placement.py``)
    or ``"blind"`` (round-robin by attempt — the baseline the benchmarks and
    tests compare against).  ``pre_launch(rec)`` runs right before every
    launch attempt — the fault-injection hook the chaos harness uses to
    corrupt caches at exact requeue boundaries."""

    def __init__(self, workdir: Path, poll_s: float = 0.05,
                 nodes: int | list[NodeSpec] | None = None,
                 placement: str = "affinity",
                 pre_launch: Optional[Callable[["JobRecord"], None]] = None):
        assert placement in ("affinity", "blind")
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.poll_s = poll_s
        self.placement = placement
        self.pre_launch = pre_launch
        if nodes is None:
            # legacy single-machine mode: one node, unlimited slots, so every
            # pending job still launches concurrently as before the cluster
            # model existed
            nodes = [NodeSpec("node0", slots=0)]
        if isinstance(nodes, int):
            nodes = [NodeSpec(f"node{i}") for i in range(nodes)]
        self.nodes: list[NodeSpec] = []
        for nd in nodes:
            if nd.local_root is None:
                nd = dataclasses.replace(
                    nd, local_root=self.workdir / "nodes" / nd.name)
            nd.local_root = Path(nd.local_root)
            nd.local_root.mkdir(parents=True, exist_ok=True)
            self.nodes.append(nd)
        self._busy: dict[str, int] = {nd.name: 0 for nd in self.nodes}
        self._jobs: dict[int, JobRecord] = {}
        self._hooked: set = set()           # (job_id, attempt) already hooked
        # cache-probe results while a job waits for a busy warm node: the
        # poll loop calls _place every poll_s, and probing every node's
        # marker/manifest/file sizes each tick would hammer the shared
        # filesystem for information that only changes when checkpoints do
        self.probe_ttl_s = 1.0
        self._probes: dict[int, tuple[int, float, dict]] = {}
        self._next_id = 1000

    # ------------------------------------------------------------------
    def submit(self, spec: JobSpec) -> int:
        jid = self._next_id
        self._next_id += 1
        rec = JobRecord(job_id=jid, spec=spec,
                        pending_since=time.monotonic())
        # the comment file outlives the scheduler: a resubmitted job resumes
        # its consumed-walltime accounting (the paper's --comment round-trip)
        prior = self._read_comment(spec.name)
        rec.consumed_s = float(prior.get("consumed_s", 0.0))
        self._jobs[jid] = rec
        return jid

    def job(self, jid: int) -> JobRecord:
        return self._jobs[jid]

    def node(self, name: str) -> NodeSpec:
        return next(nd for nd in self.nodes if nd.name == name)

    def preempt(self, jid: int) -> None:
        """scancel-with-requeue: deliver SIGTERM now; job should checkpoint+exit."""
        rec = self._jobs[jid]
        rec.preempt_requested = True
        if rec.proc and rec.proc.poll() is None:
            rec.proc.send_signal(signal.SIGTERM)

    # -- comment file (paper --comment walltime accounting) -------------
    def _comment_path(self, name: str) -> Path:
        return self.workdir / f"{name}.comment"

    def _read_comment(self, name: str) -> dict:
        try:
            return json.loads(self._comment_path(name).read_text())
        except (FileNotFoundError, ValueError, OSError):
            return {}

    def _write_comment(self, rec: JobRecord) -> None:
        p = self._comment_path(rec.spec.name)
        tmp = p.with_suffix(p.suffix + ".tmp")
        tmp.write_text(json.dumps({
            "consumed_s": rec.consumed_s,
            "requeues": rec.requeues,
            "placements": rec.placements,
            "state": rec.state,
        }))
        tmp.rename(p)

    # -- placement ------------------------------------------------------
    def _free(self, nd: NodeSpec) -> bool:
        return nd.slots == 0 or self._busy[nd.name] < nd.slots

    def _place(self, rec: JobRecord) -> Optional[NodeSpec]:
        """Pick a node for a PENDING job, or None to keep it queued.

        Affinity policy: score every node (warm promoted cache > requeue-hint
        > cold; sched/placement.py) and take the best FREE one — unless a
        busy node scores strictly higher and the job's ``warm_wait_s`` budget
        has not run out, in which case the job waits (bounded) for the warm
        node to drain.  Blind policy: round-robin by attempt number.
        """
        free = [nd for nd in self.nodes if self._free(nd)]
        aff = rec.spec.cache_affinity
        if not free:
            return None
        if aff is None or self.placement == "blind":
            want = self.nodes[rec.requeues % len(self.nodes)]
            chosen = want if self._free(want) else free[0]
            rec.peer_hint = {}              # blind baseline: no fabric help
            rec.placement_log.append({
                "attempt": rec.requeues, "node": chosen.name,
                "policy": "blind", "scores": None,
                "waited_s": time.monotonic() - rec.pending_since})
            return chosen
        now = time.monotonic()
        cached = self._probes.get(rec.job_id)
        if (cached is not None and cached[0] == rec.requeues
                and now - cached[1] <= self.probe_ttl_s):
            ranked = cached[2]
        else:
            ranked = PL.rank_nodes(
                [(nd.name, nd.local_root) for nd in self.nodes], aff,
                last_node=rec.node)
            self._probes[rec.job_id] = (rec.requeues, now, ranked)
        best_free = max(free, key=lambda nd: ranked[nd.name]["score"])
        best_any = max(self.nodes, key=lambda nd: ranked[nd.name]["score"])
        waited = time.monotonic() - rec.pending_since
        if (ranked[best_any.name]["score"] > ranked[best_free.name]["score"]
                and waited < aff.warm_wait_s):
            return None                     # bounded wait for the warm node
        # the peer hint: every OTHER warm node, handed to the job so a
        # cold placement restores from a warm peer's cache, not the shared FS
        rec.peer_hint = PL.warm_peer_roots(
            [(nd.name, nd.local_root) for nd in self.nodes], ranked,
            exclude=(best_free.name,))
        rec.placement_log.append({
            "attempt": rec.requeues, "node": best_free.name,
            "policy": "affinity",
            "scores": {n: r["score"] for n, r in ranked.items()},
            "reasons": {n: r["probe"]["reason"] for n, r in ranked.items()},
            "peers": sorted(rec.peer_hint),
            "waited_s": waited})
        return best_free

    # ------------------------------------------------------------------
    def _launch(self, rec: JobRecord, node: NodeSpec) -> None:
        spec = rec.spec
        out = self.workdir / f"{spec.name}.out"
        env = dict(os.environ)
        env.update(spec.env or {})
        env["SLURM_JOB_ID"] = str(rec.job_id)
        env["SLURM_RESTART_COUNT"] = str(rec.requeues)
        env["SLURMSIM_NODE"] = node.name
        env["SLURMD_NODENAME"] = node.name
        env["REPRO_LOCAL_ROOT"] = str(node.local_root)
        if rec.peer_hint:
            env[CR.ENV_PEER_ROOTS] = CR.format_peer_roots(rec.peer_hint)
        else:
            env.pop(CR.ENV_PEER_ROOTS, None)
        with open(out, "ab") as fh:                      # append across requeues
            fh.write(f"\n=== launch attempt {rec.requeues} "
                     f"on {node.name} ===\n".encode())
            fh.flush()
            rec.proc = subprocess.Popen(
                spec.cmd, stdout=fh, stderr=subprocess.STDOUT,
                env=env, cwd=spec.cwd)
        rec.state = "RUNNING"
        rec.node = node.name
        rec.placements.append(node.name)
        self._busy[node.name] += 1
        rec.started_at = time.monotonic()
        rec.warned = False

    def _tick(self, rec: JobRecord) -> None:
        if rec.state != "RUNNING":
            return
        proc = rec.proc
        assert proc is not None
        code = proc.poll()
        spec = rec.spec
        elapsed = time.monotonic() - rec.started_at
        if code is None:
            if (not rec.warned
                    and elapsed >= spec.walltime_s - spec.signal_margin_s):
                proc.send_signal(spec.warn_signal)
                rec.warned = True
            if elapsed >= spec.walltime_s:
                proc.kill()                               # hard limit
            return
        rec.exit_codes.append(code)
        rec.consumed_s += elapsed
        if rec.node is not None:
            self._busy[rec.node] -= 1
        should_requeue = spec.requeue and rec.requeues < spec.max_requeues and (
            code == REQUEUE_EXIT or code == -signal.SIGKILL
            or (rec.preempt_requested and code != 0))
        if code == 0:
            rec.state = "COMPLETED"
        elif should_requeue:
            rec.requeues += 1
            rec.preempt_requested = False
            rec.state = "PENDING"                         # back to the queue
            rec.pending_since = time.monotonic()
        else:
            rec.state = "FAILED"
        if rec.state in ("COMPLETED", "FAILED"):   # per-job bookkeeping done
            self._probes.pop(rec.job_id, None)
            self._hooked = {k for k in self._hooked if k[0] != rec.job_id}
        self._write_comment(rec)

    def run(self, timeout_s: float = 600.0) -> None:
        """Event loop until every job is COMPLETED or FAILED."""
        t0 = time.monotonic()
        while True:
            pending_done = True
            for rec in self._jobs.values():
                if rec.state == "PENDING":
                    # the fault hook fires BEFORE the placement probe (once
                    # per attempt) so injected cache damage is what the
                    # scheduler's scoring actually sees
                    key = (rec.job_id, rec.requeues)
                    if self.pre_launch is not None and key not in self._hooked:
                        self._hooked.add(key)
                        self.pre_launch(rec)
                    node = self._place(rec)
                    if node is not None:
                        self._launch(rec, node)
                self._tick(rec)
                if rec.state in ("PENDING", "RUNNING"):
                    pending_done = False
            if pending_done:
                return
            if time.monotonic() - t0 > timeout_s:
                for rec in self._jobs.values():
                    if rec.proc and rec.proc.poll() is None:
                        rec.proc.kill()
                raise TimeoutError("slurmsim timeout")
            time.sleep(self.poll_s)

    def states(self) -> dict:
        return {j: r.state for j, r in self._jobs.items()}
