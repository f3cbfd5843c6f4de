"""Worker-side checkpoint client — the framework's in-process "CKPT thread".

A daemon thread holds the coordinator socket (paper Fig. 1).  It cannot
interrupt XLA mid-step (DESIGN.md §2: instruction-level -> iteration-level
quiescence), so it raises flags that the training loop polls at step
boundaries via ``service()``:

    client = CkptClient(host, port, worker_id, save_fn=...)
    while training:
        state = train_step(state, batch)
        client.service(step, lambda: snapshot(state))   # quiesce point

``service`` handles a pending CKPT_REQ: sends READY (phase-1 barrier), runs the
save function, sends WRITTEN, then blocks for COMMIT/ABORT.  ``exit_requested``
becomes True on EXIT_REQ (coordinator-propagated preemption).
"""
from __future__ import annotations

import socket
import threading
import time
from typing import Callable, Optional

from repro_torch.core import protocol as P


class CkptClient:
    def __init__(self, host: str, port: int, worker_id: int, *,
                 connect_timeout: float = 30.0,
                 log: Callable[[str], None] = lambda s: None):
        self.worker_id = worker_id
        self.log = log
        self._sock = P.configure(
            socket.create_connection((host, port), timeout=connect_timeout))
        P.send_msg(self._sock, P.msg(P.INTRO, worker_id=worker_id))
        self._lock = threading.Lock()
        self._pending_req: Optional[dict] = None
        self._outcome: Optional[dict] = None
        self._cv = threading.Condition(self._lock)
        self.exit_requested = False
        self.exit_reason: Optional[str] = None
        self._closed = False
        self._rx = threading.Thread(target=self._recv_loop, daemon=True)
        self._rx.start()

    # ------------------------------------------------------------------
    def _recv_loop(self):
        while not self._closed:
            try:
                m = P.recv_msg(self._sock, timeout=0.5)
            except socket.timeout:
                continue
            except OSError:
                return
            if m is None:
                return
            kind = m.get("type")
            with self._cv:
                if kind == P.CKPT_REQ:
                    self._pending_req = m
                elif kind in (P.COMMIT, P.ABORT):
                    self._outcome = m
                elif kind == P.EXIT_REQ:
                    self.exit_requested = True
                    self.exit_reason = m.get("reason")
                self._cv.notify_all()

    def _send(self, m: dict):
        try:
            P.send_msg(self._sock, m)
        except OSError as e:
            raise CoordinatorLost(str(e)) from e

    # ------------------------------------------------------------------
    def checkpoint_pending(self) -> bool:
        with self._lock:
            return self._pending_req is not None

    def service(self, step: int, save_fn: Callable[[], dict],
                *, commit_timeout: float = 300.0) -> Optional[dict]:
        """Call at every step boundary.  Runs a checkpoint round if requested.

        ``save_fn(label)`` must perform this worker's snapshot+write under the
        coordinator-assigned checkpoint ``label`` and return the worker-part
        metadata.  Returns the round outcome (COMMIT/ABORT dict) or None if no
        round was pending.
        """
        with self._lock:
            req = self._pending_req
            self._pending_req = None
            self._outcome = None
        if req is None:
            return None
        rid = req["round"]
        label = req.get("step", step)   # coordinator-assigned checkpoint label
        self._send(P.msg(P.READY, round=rid, worker_id=self.worker_id, step=step))
        try:
            meta = save_fn(label) or {}
            self._send(P.msg(P.WRITTEN, round=rid, worker_id=self.worker_id,
                             meta={k: v for k, v in meta.items()
                                   if isinstance(v, (int, float, str, bool))}))
        except Exception as e:  # noqa: BLE001
            self.log(f"worker {self.worker_id} save failed: {e}")
            self._send(P.msg(P.FAILED, round=rid, worker_id=self.worker_id,
                             error=str(e)))
            raise
        deadline = time.time() + commit_timeout
        with self._cv:
            while self._outcome is None or self._outcome.get("round") != rid:
                remaining = deadline - time.time()
                if remaining <= 0:
                    raise CoordinatorLost("no COMMIT/ABORT from coordinator")
                self._cv.wait(timeout=min(remaining, 0.5))
            return self._outcome

    def close(self):
        self._closed = True
        try:
            P.send_msg(self._sock, P.msg(P.BYE, worker_id=self.worker_id))
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


class CoordinatorLost(RuntimeError):
    pass


class InlineCoordinator:
    """Single-process stand-in: same service() contract, no sockets.

    Used by quickstart/simple jobs where coordinator and worker share the
    process (DMTCP equally works single-node); triggers come from interval /
    signal / walltime sources via ``request()``.
    """

    def __init__(self, commit_fn=None):
        self._pending: Optional[dict] = None
        self.commit_fn = commit_fn
        self.exit_requested = False
        self.exit_reason: Optional[str] = None
        self.history: list[dict] = []

    def request(self, reason: str = "manual"):
        self._pending = {"reason": reason}

    def request_exit(self, reason: str):
        self.exit_requested = True
        self.exit_reason = reason

    def checkpoint_pending(self) -> bool:
        return self._pending is not None

    def service(self, step: int, save_fn, **_) -> Optional[dict]:
        req, self._pending = self._pending, None
        if req is None:
            return None
        t0 = time.time()
        save_fn(step)
        manifest = self.commit_fn(step, num_workers=1) if self.commit_fn else {}
        rec = {"type": P.COMMIT, "step": step, "reason": req["reason"],
               "duration_s": time.time() - t0,
               "manifest_step": manifest.get("step")}
        self.history.append(rec)
        return rec

    def close(self):
        pass


class GroupCoordinator(InlineCoordinator):
    """``InlineCoordinator`` for the ranks of a ``torch.distributed`` group,
    where the group is the coordinator: every rank writes its part
    (``save_fn``, then ``written_fn`` until its writes are on the store), a
    barrier (phase one), rank 0 commits the manifest of ``world`` parts,
    and a second barrier holds every rank until the manifest exists, so
    the next save of any rank diffs against it.  Every rank calls
    ``service`` at the same step boundaries (the requests come from
    sources that every rank agrees on)."""

    def __init__(self, commit_fn, *, rank: int, world: int, written_fn=None):
        super().__init__(commit_fn=commit_fn)
        self.rank, self.world = rank, world
        self.written_fn = written_fn

    def service(self, step: int, save_fn, **_) -> Optional[dict]:
        import torch.distributed as dist

        req, self._pending = self._pending, None
        if req is None:
            return None
        t0 = time.time()
        save_fn(step)
        if self.written_fn is not None:
            self.written_fn()
        dist.barrier()
        manifest = self.commit_fn(step, num_workers=self.world) if self.rank == 0 else {}
        dist.barrier()
        rec = {"type": P.COMMIT, "step": step, "reason": req["reason"],
               "duration_s": time.time() - t0,
               "manifest_step": manifest.get("step") if self.rank == 0 else step}
        self.history.append(rec)
        return rec
