"""Checkpoint coordinator — the framework's ``dmtcp_coordinator``.

A TCP server coordinating checkpoint rounds across worker checkpoint threads
with a two-phase barrier:

  phase 1 (quiesce):  CKPT_REQ -> all workers; wait for READY from every live
                      worker (each worker is parked at a step boundary).
  phase 2 (write):    workers snapshot + write their shards; wait for WRITTEN.
  commit:             verify parts, write MANIFEST.json atomically, broadcast
                      COMMIT.  Any FAILED / disconnect / straggler timeout
                      instead broadcasts ABORT — no manifest, the previous
                      checkpoint stays authoritative.

Straggler mitigation: a worker that misses ``straggler_timeout`` in either
phase fails the round (and is dropped if its socket died); the job-level
requeue logic decides whether to retry with the survivors (elastic restart).

Like DMTCP, multiple independent coordinators can run (one per job) — they are
plain instances bound to distinct ports.  Periodic checkpointing (`interval_s`)
matches ``dmtcp_coordinator -i``.
"""
from __future__ import annotations

import socket
import threading
import time
from typing import Callable, Optional

from repro_torch.core import protocol as P


class _WorkerConn:
    def __init__(self, sock: socket.socket, addr):
        self.sock = sock
        self.addr = addr
        self.worker_id: Optional[int] = None
        self.alive = True
        self.lock = threading.Lock()

    def send(self, message: dict) -> bool:
        with self.lock:
            if not self.alive:
                return False
            try:
                P.send_msg(self.sock, message)
                return True
            except OSError:
                self.alive = False
                return False


class CoordinatorError(RuntimeError):
    pass


class CheckpointCoordinator:
    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 expected_workers: int = 1,
                 straggler_timeout: float = 120.0,
                 interval_s: Optional[float] = None,
                 commit_fn: Optional[Callable[[int, int], dict]] = None,
                 log: Callable[[str], None] = lambda s: None):
        """``commit_fn(step, num_workers)`` writes the manifest (usually
        ``CheckpointManager.commit``); called only when all workers WROTE."""
        self.expected_workers = expected_workers
        self.straggler_timeout = straggler_timeout
        self.interval_s = interval_s
        self.commit_fn = commit_fn
        self.log = log
        self._conns: dict[int, _WorkerConn] = {}
        self._conns_lock = threading.Lock()
        self._round_lock = threading.Lock()
        self._round_cv = threading.Condition(self._round_lock)
        self._round_id = 0
        self._acks: dict[str, set[int]] = {}
        self._failed: set[int] = set()
        self._written_meta: dict[int, dict] = {}
        self._stop = threading.Event()
        self._history: list[dict] = []

        self._srv = socket.create_server((host, port))
        self.host, self.port = self._srv.getsockname()
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._accept_thread.start()
        self._interval_thread = None
        if interval_s:
            self._interval_thread = threading.Thread(
                target=self._interval_loop, daemon=True)
            self._interval_thread.start()

    # ------------------------------------------------------------------
    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                self._srv.settimeout(0.2)
                sock, addr = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn = _WorkerConn(P.configure(sock), addr)
            threading.Thread(target=self._serve_conn, args=(conn,), daemon=True).start()

    def _serve_conn(self, conn: _WorkerConn):
        try:
            while not self._stop.is_set():
                m = P.recv_msg(conn.sock, timeout=1.0)
                if m is None:
                    break
                self._handle(conn, m)
        except socket.timeout:
            if not self._stop.is_set():
                # keep listening; timeouts are normal between messages
                return self._serve_conn(conn)
        except OSError:
            pass
        finally:
            conn.alive = False
            if conn.worker_id is not None:
                self.log(f"worker {conn.worker_id} disconnected")
                with self._round_cv:
                    self._failed.add(conn.worker_id)
                    self._round_cv.notify_all()

    def _handle(self, conn: _WorkerConn, m: dict):
        kind = m.get("type")
        if kind == P.INTRO:
            conn.worker_id = int(m["worker_id"])
            with self._conns_lock:
                self._conns[conn.worker_id] = conn
            self.log(f"worker {conn.worker_id} connected")
            return
        wid = conn.worker_id
        if wid is None:
            return
        if kind in (P.READY, P.WRITTEN, P.FAILED):
            with self._round_cv:
                if m.get("round") == self._round_id:
                    if kind == P.FAILED:
                        self._failed.add(wid)
                    else:
                        self._acks.setdefault(kind, set()).add(wid)
                        if kind == P.WRITTEN:
                            self._written_meta[wid] = m.get("meta", {})
                self._round_cv.notify_all()
        elif kind == P.BYE:
            conn.alive = False

    # ------------------------------------------------------------------
    def connected_workers(self) -> list[int]:
        with self._conns_lock:
            return sorted(w for w, c in self._conns.items() if c.alive)

    def wait_for_workers(self, n: Optional[int] = None, timeout: float = 60.0) -> None:
        n = n or self.expected_workers
        t0 = time.time()
        while len(self.connected_workers()) < n:
            if time.time() - t0 > timeout:
                raise CoordinatorError(
                    f"only {len(self.connected_workers())}/{n} workers connected")
            time.sleep(0.02)

    def _broadcast(self, message: dict, workers: list[int]) -> None:
        with self._conns_lock:
            for w in workers:
                c = self._conns.get(w)
                if c:
                    c.send(message)

    def _await_acks(self, kind: str, workers: set[int], timeout: float) -> bool:
        deadline = time.time() + timeout
        with self._round_cv:
            while True:
                got = self._acks.get(kind, set())
                if self._failed & workers:
                    return False
                if workers <= got:
                    return True
                remaining = deadline - time.time()
                if remaining <= 0:
                    self.log(f"straggler timeout waiting for {kind}: "
                             f"missing {sorted(workers - got)}")
                    return False
                self._round_cv.wait(timeout=min(remaining, 0.5))

    # ------------------------------------------------------------------
    def trigger_checkpoint(self, step: int, *, reason: str = "interval") -> dict:
        """Run one full two-phase checkpoint round.  Returns a result record."""
        with self._round_lock:
            self._round_id += 1
            rid = self._round_id
            self._acks = {}
            self._failed = set()
            self._written_meta = {}
        workers = set(self.connected_workers())
        # the checkpoint LABEL is coordinator-assigned: the caller's step when
        # known, else the round id (interval triggers).  Workers write their
        # shards under this label regardless of their local step counters, so
        # the round forms one consistent named cut.
        label = step if step >= 0 else rid
        rec = {"round": rid, "step": label, "reason": reason,
               "workers": sorted(workers), "t_start": time.time()}
        if not workers:
            rec.update(ok=False, error="no workers")
            self._history.append(rec)
            return rec
        self._broadcast(P.msg(P.CKPT_REQ, round=rid, step=label, reason=reason),
                        sorted(workers))
        if not self._await_acks(P.READY, workers, self.straggler_timeout):
            self._abort(rid, workers, rec, "quiesce barrier failed")
            return rec
        rec["t_quiesced"] = time.time()
        if not self._await_acks(P.WRITTEN, workers, self.straggler_timeout):
            self._abort(rid, workers, rec, "write barrier failed")
            return rec
        rec["t_written"] = time.time()
        try:
            manifest = (self.commit_fn(label, num_workers=len(workers))
                        if self.commit_fn else {"step": label})
        except Exception as e:  # noqa: BLE001
            self._abort(rid, workers, rec, f"commit failed: {e}")
            return rec
        self._broadcast(P.msg(P.COMMIT, round=rid, step=step), sorted(workers))
        rec.update(ok=True, t_commit=time.time(),
                   manifest_step=manifest.get("step"),
                   written_meta=self._written_meta)
        self._history.append(rec)
        self.log(f"checkpoint round {rid} (step {step}) committed")
        return rec

    def _abort(self, rid, workers, rec, why):
        self._broadcast(P.msg(P.ABORT, round=rid, reason=why), sorted(workers))
        rec.update(ok=False, error=why, t_abort=time.time())
        self._history.append(rec)
        self.log(f"checkpoint round {rid} ABORTED: {why}")

    def request_exit(self, reason: str = "preemption") -> None:
        """Ask every worker to checkpoint-and-exit (paper: SIGTERM propagation)."""
        self._broadcast(P.msg(P.EXIT_REQ, reason=reason), self.connected_workers())

    # ------------------------------------------------------------------
    def _interval_loop(self):
        last = time.time()
        while not self._stop.wait(0.2):
            if time.time() - last >= self.interval_s and self.connected_workers():
                self.trigger_checkpoint(step=-1, reason="interval")
                last = time.time()

    @property
    def history(self) -> list[dict]:
        return list(self._history)

    def close(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
