"""CRManager — glues the C/R core into a training loop (paper Fig. 3 workflow).

One object owns: the checkpoint manager (storage), the coordinator client (or
inline coordinator), the signal trap, and the walltime tracker.  The training
loop touches three methods:

    state, data_state, start_step = crm.restore_or_init(init_fn, templates, axes)
    for step in range(start_step, total):
        state = train_step(state, batch)
        action = crm.step_boundary(step, state_snapshot_fn, data_state_fn)
        if action == "exit":           # preempted / walltime -> checkpointed
            crm.request_requeue(step); break

Exit paths mirror the paper: trapped SIGTERM/USR1, coordinator EXIT_REQ,
walltime margin — each forces a final checkpoint round, records the requeue
file, and returns "exit".  Periodic checkpoints happen every
``interval_steps`` or via a coordinator interval trigger.

Ranks (``ranks``: the job was started as the ranks of a process group,
``launch.mesh.start_ranks``): every step boundary reduces the exit reason
over the group (one all-reduce, MAX over a code of the trap, the
coordinator's exit request and the walltime tracker), so a signal that
reaches one rank stops all of them at the same step, each with the same
checkpoint.  Rank ``r`` writes the leaves it owns as worker ``r`` of the
world (``core.virtualization.owned_tree``); the group commits the round
(``core.worker.GroupCoordinator``).  Only rank 0 records the requeue file
and promotes a restore into the node-local tier.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.manifest import capture_manifest, verify_manifest
from repro_torch.core.requeue import RequeueFile, WalltimeTracker, detect_node
from repro_torch.core.signals import SignalTrap
from repro_torch.core.virtualization import fetch_tree, owned_tree, place_tree
from repro_torch.core.worker import InlineCoordinator

# exit reasons as codes, reduced (MAX) over the ranks: a signal outranks the
# coordinator's exit request, which outranks the walltime margin; a signal's
# code carries its number
_WALLTIME, _COORDINATOR, _SIGNAL = 1 << 6, 2 << 6, 3 << 6


class CRManager:
    def __init__(self, ckpt: CheckpointManager, *,
                 client=None,
                 signal_trap: Optional[SignalTrap] = None,
                 walltime: Optional[WalltimeTracker] = None,
                 requeue_file: Optional[RequeueFile] = None,
                 interval_steps: Optional[int] = None,
                 predump: bool = False, predump_lead: int = 1,
                 rules, cfg=None, device="cpu", node: Optional[str] = None,
                 peers: Optional[dict] = None, ranks=None,
                 log: Callable[[str], None] = print):
        self.ckpt = ckpt
        # the job's place in its process group (``launch.mesh.Ranks``), or
        # None for a job that was not started as ranks
        self.ranks = ranks
        self.rank = ranks.rank if ranks is not None else 0
        # predump=True (delta mode only): ``predump_lead`` steps before each
        # interval checkpoint, snapshot + hand the hash/fingerprint/pre-write
        # work to the manager's background pool (CheckpointManager.precommit)
        # so the interval save pays only for bytes dirtied in the last
        # ``predump_lead`` steps — CRIU's pre-dump, at the training loop level
        self.predump = predump
        self.predump_lead = predump_lead
        # which cluster node this attempt runs on — recorded into the requeue
        # file so the scheduler can round-trip the placement hint
        self.node = node if node is not None else detect_node()
        # the warm-peer roots this attempt was handed (scheduler hint) —
        # recorded into the requeue file so a scheduler-less restart can
        # still source its restore through the peer fabric
        self.peers = peers
        self.client = client or InlineCoordinator(commit_fn=ckpt.commit)
        self.signal_trap = signal_trap
        self.walltime = walltime
        self.requeue_file = requeue_file
        self.interval_steps = interval_steps
        self.cfg = cfg
        # a restore lays the state out for the mesh of ``rules`` (its logical
        # axes given) on ``device``, the device the train state lives on
        self.rules = rules
        self.device = device
        self.log = log
        self.events: list[dict] = []
        # each save's delta-plane stats (stall_s, fp_device_s, d2h_bytes, ...)
        # as the manager returned them, for the trainer's metrics output
        self.saves: list[dict] = []
        self._restored_meta: Optional[dict] = None
        self._state_axes = None          # the state's logical axes (restore_or_init's)
        # the exit reason the last step boundary acted on (agreed by the ranks)
        self.exit_cause: Optional[str] = None

    # ------------------------------------------------------------------
    def restore_or_init(self, init_fn, templates: dict, axes: dict):
        """templates: {"state": template tree (meta tensors do)}; axes:
        {"state": its logical-axes tree}.  Returns (device_state,
        manifest_meta|None, start_step).  Every rank restores every worker
        part (a checkpoint of N workers restores at M ranks) and places its
        blocks; ranks other than 0 read without promoting."""
        self._state_axes = axes["state"]
        try:
            host_state, manifest = self.ckpt.restore(
                templates["state"], promote=None if self.rank == 0 else False)
        except FileNotFoundError:
            state = init_fn()
            self.log("[cr] no checkpoint found — cold start")
            return state, None, 0
        stats = getattr(self.ckpt, "last_restore_stats", None)
        if stats:
            src = "promoted " + stats["tier"] if stats.get("promoted") else stats["tier"]
            if stats.get("peer"):
                src = "peers " + ",".join(stats.get("peer_tiers") or [])
            self.log(f"[cr] restore engine: tier={src} mode={stats['mode']} "
                     f"workers={stats.get('workers')} "
                     f"tasks={stats.get('tasks', stats.get('files'))}")
        meta = manifest.get("meta", {})
        if meta.get("run_manifest"):
            verify_manifest(meta["run_manifest"], cfg=self.cfg, log=self.log,
                            device=self.device)
        state = place_tree(host_state, axes["state"], self.rules, self.device)
        start_step = int(meta.get("next_step", manifest["step"] + 1))
        self._restored_meta = meta
        self.log(f"[cr] restored checkpoint step={manifest['step']} "
                 f"-> resuming at {start_step}")
        return state, meta, start_step

    # ------------------------------------------------------------------
    def _save_fn(self, step: int, state_fn, extra_meta: dict):
        def save(label=None):
            state = self._owned(state_fn())
            # device_fp: the manager fingerprints LIVE device leaves and
            # gathers only dirty chunks itself — a full fetch here would
            # pay the D2H bill the mode exists to avoid
            host = (state if getattr(self.ckpt, "device_fp", False)
                    else fetch_tree(state))  # quiesce point: device -> host
            meta = dict(extra_meta)
            meta["next_step"] = step + 1
            meta["run_manifest"] = capture_manifest(self.cfg, device=self.device)
            part = self.ckpt.save(label if label is not None else step,
                                  host, extra_meta=meta)
            self.saves.append({"step": step, **(part.get("delta") or {})})
            return part
        return save

    def _owned(self, state):
        """The leaves of ``state`` this rank writes (every leaf, on one rank)."""
        if self.ranks is None or self.ranks.world == 1:
            return state
        return owned_tree(state, self._state_axes, self.rules, self.rank, self.ranks.world)

    def checkpoint_now(self, step: int, state_fn, *, reason: str = "manual",
                       extra_meta: Optional[dict] = None) -> Optional[dict]:
        if isinstance(self.client, InlineCoordinator):
            self.client.request(reason)
        outcome = self.client.service(
            step, self._save_fn(step, state_fn, extra_meta or {}))
        if outcome:
            self.events.append({"step": step, "reason": reason, **outcome})
        return outcome

    # ------------------------------------------------------------------
    def exit_reason(self) -> Optional[str]:
        if self.signal_trap is not None and self.signal_trap.triggered:
            return f"signal:{self.signal_trap.received}"
        if getattr(self.client, "exit_requested", False):
            return f"coordinator:{self.client.exit_reason}"
        if self.walltime is not None and self.walltime.near_limit():
            return "walltime"
        return None

    def agreed_exit_reason(self) -> Optional[str]:
        """``exit_reason`` of this process or, for ranks, the strongest of
        every rank's (one all-reduce: every rank calls)."""
        reason = self.exit_reason()
        if self.ranks is None:
            return reason
        code = 0
        if reason is not None:
            kind, _, detail = reason.partition(":")
            code = {"walltime": _WALLTIME, "coordinator": _COORDINATOR}.get(kind)
            code = code or _SIGNAL + int(detail)
        t = torch.tensor([code], dtype=torch.int64, device=self.ranks.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        code = int(t.item())
        if code == 0:
            return None
        if code >= _SIGNAL:
            return f"signal:{code - _SIGNAL}"
        if code >= _COORDINATOR:
            return reason if reason and reason.startswith("coordinator") else "coordinator"
        return "walltime"

    def step_boundary(self, step: int, state_fn, *,
                      extra_meta: Optional[dict] = None) -> str:
        """Returns 'exit' | 'checkpointed' | 'continue'."""
        reason = self.exit_cause = self.agreed_exit_reason()
        if reason is not None:
            self.log(f"[cr] exit condition at step {step}: {reason}")
            self.checkpoint_now(step, state_fn, reason=reason,
                                extra_meta=extra_meta)
            return "exit"
        if self.client.checkpoint_pending():
            self.client.service(step, self._save_fn(step, state_fn,
                                                    extra_meta or {}))
            return "checkpointed"
        if self.interval_steps and step > 0 and step % self.interval_steps == 0:
            self.checkpoint_now(step, state_fn, reason="interval",
                                extra_meta=extra_meta)
            return "checkpointed"
        if (self.predump and self.interval_steps
                and getattr(self.ckpt, "delta", False)):
            from repro_torch.train.step import predump_boundary
            if predump_boundary(step, self.interval_steps, self.predump_lead):
                state = self._owned(state_fn())
                host = (state if getattr(self.ckpt, "device_fp", False)
                        else fetch_tree(state))  # quiesce: device -> host only
                info = self.ckpt.precommit(step, host)
                self.events.append({"step": step, "reason": "predump",
                                    **info})
        return "continue"

    # ------------------------------------------------------------------
    def request_requeue(self, step: int, reason: str = "") -> None:
        if self.requeue_file is not None and self.walltime is not None and self.rank == 0:
            rec = self.requeue_file.save(self.walltime, step, reason=reason,
                                         node=self.node, peers=self.peers)
            self.log(f"[cr] requeue recorded: {rec}")

    def close(self) -> None:
        try:
            self.ckpt.close()
        finally:
            self.client.close()   # BYE must go out even if a write failed
