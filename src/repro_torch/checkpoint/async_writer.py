"""Background checkpoint worker pools (beyond-paper optimization).

``WorkPool`` is the shared primitive: a small pool of daemon threads with a
bounded in-flight count — ``submit`` blocks once the bound is hit, which is
the backpressure knob for everything the checkpoint plane runs off the
training thread.  Three users:

* ``AsyncWriter`` (save path): the paper's DMTCP checkpoint is synchronous —
  user threads quiesce for the whole image write (the CPU dips in its
  Fig. 4).  Here the quiesce only lasts for the device->host snapshot
  (double buffer); serialization + store writes run on the pool overlapped
  with training.  Every pending write pins a full host snapshot via its
  closure, so the in-flight bound is a memory bound.
* tier promotion (restore path): ``CheckpointManager`` tees restored shard
  bytes into the node-local tier write-behind on a ``WorkPool`` so the
  restore returns as soon as the state is materialized — the copy into the
  container-image-cache-like tier never blocks the restart.
* chunk hashing (delta save path): ``serialization.ChunkHashEngine`` fans
  every leaf's blake2b/CRC chunk digests across a pool — both primitives
  release the GIL on multi-KB buffers, so the hash pass scales with memory
  bandwidth instead of single-core hash speed.  The pre-dump (``precommit``)
  phase additionally runs whole hash+pre-write passes as single pool tasks,
  overlapped with the next training step.

``wait()`` drains the queue — called before a requeue/exit so the last image
is durable, and by the two-phase coordinator barrier before WRITTEN is sent.
"""
from __future__ import annotations

import os
import queue
import threading
import traceback
from typing import Callable, Optional


class WorkPool:
    """Bounded-in-flight daemon thread pool.

    ``max_inflight`` bounds TOTAL unfinished tasks (queued + executing);
    ``submit`` blocks when the producer outpaces the consumers.  The first
    task exception is re-raised on the producer thread at the next
    ``submit``/``wait`` (tasks after a failure still run — each task must be
    independently meaningful, which checkpoint writes and promotions are).
    """

    def __init__(self, max_inflight: int = 3, workers: int = 1,
                 name: str = "ckpt-pool"):
        self._max_inflight = max(1, max_inflight)
        workers = min(max(1, workers), self._max_inflight)
        self.workers = workers          # resolved size, for bench run_meta
        self._q: queue.Queue = queue.Queue()   # _inflight gate does the bounding
        self._err: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._inflight = 0
        self._done = threading.Condition()
        self._closed = False
        self._threads = [
            threading.Thread(target=self._run, daemon=True, name=f"{name}-{i}")
            for i in range(workers)
        ]
        for t in self._threads:
            t.start()

    def _run(self):
        while True:
            fn = self._q.get()
            if fn is None:
                return
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — surfaced on wait()
                with self._lock:
                    self._err = e
                traceback.print_exc()
            finally:
                with self._done:
                    self._inflight -= 1
                    self._done.notify_all()

    def submit(self, fn: Callable[[], None]) -> None:
        if self._closed:
            raise RuntimeError(f"{type(self).__name__} is closed")
        self.raise_if_failed()
        with self._done:
            self._done.wait_for(lambda: self._inflight < self._max_inflight)
            self._inflight += 1
        self._q.put(fn)

    def try_submit(self, fn: Callable[[], None]) -> bool:
        """Non-blocking submit: False when the in-flight bound is reached.
        For best-effort work (tier promotion) that must never apply
        backpressure to the caller — dropping is the correct behavior for an
        opportunistic cache."""
        if self._closed:
            raise RuntimeError(f"{type(self).__name__} is closed")
        self.raise_if_failed()
        with self._done:
            if self._inflight >= self._max_inflight:
                return False
            self._inflight += 1
        self._q.put(fn)
        return True

    def wait(self, timeout: Optional[float] = None) -> None:
        with self._done:
            self._done.wait_for(lambda: self._inflight == 0, timeout=timeout)
        self.raise_if_failed()

    def raise_if_failed(self) -> None:
        with self._lock:
            if self._err is not None:
                err, self._err = self._err, None
                raise RuntimeError("background checkpoint task failed") from err

    def close(self) -> None:
        """Drain, stop the threads, then surface any task failure.  The
        thread teardown runs even when a task failed — a raising ``close``
        must not leak pool threads or leave the pool half-open."""
        if self._closed:
            return
        try:
            self.wait()
        finally:
            self._closed = True
            for _ in self._threads:
                self._q.put(None)
            for t in self._threads:
                t.join(timeout=5)


class AsyncWriter(WorkPool):
    """Save-path pool: the default in-flight bound matches the seed's memory
    budget (2 queued + 1 executing host snapshots)."""

    def __init__(self, max_inflight: int = 3, workers: Optional[int] = None):
        if workers is None:
            workers = max(2, min(4, (os.cpu_count() or 2) // 2))
        super().__init__(max_inflight=max_inflight, workers=workers,
                         name="ckpt-writer")
