"""Serving-fleet weight distribution on the checkpoint chunk fabric.

The paper's C/R machinery moves TRAINING state between jobs; a production
inference fleet needs the same bytes moved the other way — a fine-tune/RLHF
trainer commits step N+1 as a delta checkpoint, and every serving replica
must converge to it without dropping requests.  This module is that
consumer:

* ``ParamHandle`` double-buffers the parameter tree: decode always reads one
  coherent tree, a newer one is STAGED off to the side, and the swap is a
  pointer flip at a generation boundary — the only request-visible cost.
* ``WeightSyncClient`` subscribes to the ``CacheRegistry`` push plane
  (``announce_push``/``latest_push``), fetches a newer step through the
  unified ``CheckpointManager.restore`` as a READ-ONLY follower
  (``promote=False`` — never invalidates or promotes cache markers some
  other replica on the node may be serving from), stages it, and publishes
  per-replica sync state (step, lag, bytes by tier, swap stall) back
  through the registry.

Because the fetch rides the chunk plane's own-cache -> exact-peer ->
stale-peer -> shared resolution, a warm-but-stale replica pulls only the
chunks the new step changed — fleet-wide shared-tier traffic is ~delta
size, not N x full model size (see benchmarks/bench_weight_push.py).

Deliberately jax-free: trees are whatever the caller serves (the engine
passes device arrays through ``to_native``), so the unit tests drive the
whole protocol on numpy.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Optional


class StaleReplicaError(RuntimeError):
    """A replica exceeded its staleness bound and could not close the gap."""


class ParamHandle:
    """Double-buffered parameter tree.

    ``current`` is what decode reads; ``stage()`` parks a newer tree without
    touching it; ``commit_pending()`` flips the pointer.  The flip is the
    ONLY mutation ``current`` ever sees, so a generation loop that captures
    ``current`` once can never observe a torn update — the swap lands at
    the next capture point (the engine calls ``commit_pending()`` exactly
    at generation boundaries).
    """

    def __init__(self, tree, step: Optional[int] = None):
        self._lock = threading.Lock()
        self._current = tree
        self._step = step
        self._pending: Optional[tuple] = None      # (tree, step)
        self.swap_count = 0
        self.last_swap_s = 0.0                     # request-visible stall

    @property
    def current(self):
        with self._lock:
            return self._current

    @property
    def step(self) -> Optional[int]:
        with self._lock:
            return self._step

    @property
    def pending_step(self) -> Optional[int]:
        with self._lock:
            return self._pending[1] if self._pending is not None else None

    @property
    def newest_step(self) -> Optional[int]:
        """The step this handle has BYTES for (staged counts — it is one
        pointer flip away), which is what staleness is measured against."""
        with self._lock:
            return self._pending[1] if self._pending is not None else self._step

    def stage(self, tree, step: Optional[int]) -> None:
        """Park a newer tree; a later stage before the swap supersedes it
        (the fleet converges to the NEWEST push, intermediate ones are
        skippable by design — bounded staleness, not a replay log)."""
        with self._lock:
            self._pending = (tree, step)

    def commit_pending(self) -> bool:
        """Flip to the staged tree, if any.  Returns True when a swap
        happened.  ``last_swap_s`` times exactly this flip — the fetch that
        produced the staged tree ran off the request path."""
        with self._lock:
            if self._pending is None:
                return False
            t0 = time.perf_counter()
            self._current, self._step = self._pending
            self._pending = None
            self.swap_count += 1
            self.last_swap_s = time.perf_counter() - t0
            return True


class WeightSyncClient:
    """One serving replica's subscription to the weight-push plane.

    ``manager`` is a READ-ONLY follower ``CheckpointManager`` (typically
    ``promote="off"``; every restore here passes ``promote=False`` anyway);
    ``handle`` is the engine's ``ParamHandle``; ``template`` a same-shape
    host tree for ``restore``.  ``sources`` pins the fetch plan
    (``"auto"`` plans own-cache -> peers -> shared).  ``to_native``
    converts the restored host tree into whatever the engine serves
    (device placement) BEFORE it is staged, so the boundary swap stays a
    pointer flip.

    ``on_stale`` picks what the staleness gate does when even a forced
    sync cannot close the gap: ``"drain"`` (default) flips the replica
    into a DRAINING phase — in-flight generations finish, ``admit()``
    refuses new ones, the registry shows ``draining`` — and re-admits it
    once it catches up; ``"raise"`` keeps the older behavior of failing the
    replica out of rotation with ``StaleReplicaError``.

    ``pipeline_uploads=True`` moves ``to_native`` + ``stage`` onto a
    single background upload thread, so the (device-upload-heavy) native
    conversion of push N overlaps the FETCH of push N+1; the in-flight
    step still counts as "have" for lag, and ``wait_uploads()`` (called by
    the gate before a forced swap) drains the pipeline and re-raises any
    upload failure at the boundary that needs the bytes.

    ``advertise=True`` (default) passes ``follower_cache=True`` into the
    manager's restore: fetched delta chunks are parked in the node-local
    tier and the synced step is advertised as a registry follower-cache
    entry, so the NEXT replica pulls the delta from this one instead of
    the shared tier (see ``CacheRegistry.publish_follower``).

    Thread-safe: one ``RLock`` serializes the poll -> fetch -> stage path,
    so a background ``follow()`` thread and a boundary ``ensure_fresh()``/
    ``admit()`` call can never double-fetch one step, tear ``history``, or
    interleave their status publishes.
    """

    def __init__(self, manager, handle: ParamHandle, template, *,
                 registry=None, replica: Optional[str] = None,
                 max_lag_steps: Optional[int] = None, sources="auto",
                 to_native: Optional[Callable] = None,
                 on_stale: str = "drain", pipeline_uploads: bool = False,
                 advertise: bool = True):
        if on_stale not in ("drain", "raise"):
            raise ValueError("on_stale must be 'drain' or 'raise'")
        self.manager = manager
        self.handle = handle
        self.template = template
        self.registry = registry if registry is not None else manager.registry
        self.replica = replica or manager.node or "replica"
        self.max_lag_steps = max_lag_steps
        self.sources = sources
        self.to_native = to_native
        self.on_stale = on_stale
        self.pipeline_uploads = pipeline_uploads
        self.advertise = advertise
        self.history: list[dict] = []          # one record per applied sync
        self.drain_count = 0                   # times the replica drained
        self.readmit_count = 0                 # times it re-admitted after
        self._sync_lock = threading.RLock()
        self._draining = False
        self._upload_pool: Optional[ThreadPoolExecutor] = None
        self._upload_futures: list[Future] = []
        self._inflight_step: Optional[int] = None

    @property
    def draining(self) -> bool:
        """True while the replica is refusing new admissions (over its
        staleness bound, waiting to catch up)."""
        with self._sync_lock:
            return self._draining

    # -- push-plane polling --------------------------------------------
    def published_step(self) -> Optional[int]:
        """Newest step the publisher advertised.  One tiny registry read
        per poll; falls back to listing committed manifests only when no
        announcement exists (cold registry / out-of-band publisher)."""
        if self.registry is not None:
            ann = self.registry.latest_push()
            if ann is not None:
                return ann["step"]
        steps = self.manager.steps()
        return steps[-1] if steps else None

    def _newest_have(self) -> Optional[int]:
        """Newest step this replica has bytes for: staged counts (one flip
        away) and so does a step whose upload is still IN FLIGHT on the
        pipeline thread — the fetch is done, the bytes exist, only the
        native conversion lags."""
        have = self.handle.newest_step
        infl = self._inflight_step
        if infl is not None and (have is None or infl > have):
            return infl
        return have

    def lag(self) -> Optional[int]:
        """Published step minus the newest step this replica has bytes for
        (staged-but-unswapped and in-flight-upload count; None when either
        side is unknown)."""
        target = self.published_step()
        with self._sync_lock:
            have = self._newest_have()
        if target is None or have is None:
            return None
        return max(0, target - have)

    # -- sync ----------------------------------------------------------
    def sync_once(self) -> Optional[dict]:
        """Poll; if a newer step is published, fetch its delta and stage it
        (directly, or via the upload pipeline).  Returns the sync record
        (also appended to ``history``) or None when already current.  The
        fetch never blocks decode — the engine keeps serving
        ``handle.current`` until its next boundary swap."""
        with self._sync_lock:
            target = self.published_step()
            have = self._newest_have()
            if target is None or (have is not None and target <= have):
                self._publish_status(phase="serving")
                return None
            self._publish_status(phase="fetching", target_step=target)
            t0 = time.perf_counter()
            try:
                tree, manifest = self.manager.restore(
                    self.template, target, sources=self.sources,
                    promote=False, follower_cache=self.advertise)
            except FileNotFoundError:
                # announced but not (yet) visible — a paused or failed
                # publisher mid-push.  Keep serving the current weights;
                # the staleness gate decides when that stops being OK.
                self._publish_status(phase="serving")
                return None
            fetch_s = time.perf_counter() - t0
            stats = self.manager.last_restore_stats or {}
            rec = {
                "step": target,
                "from_step": have,
                "fetch_s": fetch_s,
                "bytes_read": stats.get("bytes_read", 0),
                "bytes_by_tier": dict(stats.get("bytes_by_tier") or {}),
                "chunks": stats.get("chunks", 0),
                "delta": stats.get("delta", False),
                "follower_advertised": stats.get("follower_advertised",
                                                 False),
                "pipelined": bool(self.pipeline_uploads),
                "manifest_version": manifest.get("manifest_version", 1),
            }
            self.history.append(rec)
            if self.pipeline_uploads:
                # overlap to_native of THIS push with the fetch of the
                # next: the single-worker pool keeps stages ordered, and
                # _inflight_step keeps lag()/dedup honest meanwhile
                self._inflight_step = target
                self._upload_futures.append(
                    self._upload_executor().submit(
                        self._upload, tree, target, rec))
            else:
                if self.to_native is not None:
                    tree = self.to_native(tree)
                self.handle.stage(tree, target)
                self._publish_status(phase="staged", target_step=target,
                                     stats=rec)
            return rec

    # -- pipelined device upload ----------------------------------------
    def _upload_executor(self) -> ThreadPoolExecutor:
        if self._upload_pool is None:
            self._upload_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="weight-upload")
        return self._upload_pool

    def _upload(self, tree, step: int, rec: dict) -> None:
        # runs on the upload thread; deliberately lock-free (wait_uploads
        # blocks on this future WHILE holding the sync lock)
        if self.to_native is not None:
            tree = self.to_native(tree)
        self.handle.stage(tree, step)
        self._publish_status(phase="staged", target_step=step, stats=rec)

    def wait_uploads(self) -> None:
        """Drain the upload pipeline.  The first failed upload re-raises
        HERE — at the boundary that needs the bytes — not on a background
        thread; after a failure the in-flight step no longer counts as
        "have", so the next sync re-fetches it."""
        with self._sync_lock:
            futs, self._upload_futures = self._upload_futures, []
            self._inflight_step = None
        for f in futs:
            f.result()

    def close(self) -> None:
        """Drain and shut down the upload pipeline (no-op when unused)."""
        try:
            self.wait_uploads()
        finally:
            pool, self._upload_pool = self._upload_pool, None
            if pool is not None:
                pool.shutdown(wait=True)

    # -- staleness gate / draining admission control ---------------------
    def _readmit(self) -> None:
        if self._draining:
            self._draining = False
            self.readmit_count += 1
            self._publish_status(phase="serving")

    def _gate(self) -> int:
        """Shared staleness gate (callers hold ``_sync_lock``): when the
        bound is exceeded, sync, drain the upload pipeline and force a swap
        AT THIS BOUNDARY; if even that cannot close the gap, either enter
        the draining phase (``on_stale="drain"``) or raise
        ``StaleReplicaError`` (``on_stale="raise"``).  Returns the lag
        after the gate and clears draining whenever the replica is back
        within its bound."""
        lag = self.lag()
        if (self.max_lag_steps is None or lag is None
                or lag <= self.max_lag_steps):
            self._readmit()
            return lag or 0
        self.sync_once()
        self.wait_uploads()
        self.handle.commit_pending()
        lag = self.lag() or 0
        if lag <= self.max_lag_steps:
            self._readmit()
            return lag
        if self.on_stale == "raise":
            self._publish_status(phase="stalled")
            raise StaleReplicaError(
                f"replica {self.replica} is {lag} steps behind the "
                f"published weights (bound {self.max_lag_steps})")
        if not self._draining:
            self._draining = True
            self.drain_count += 1
        self._publish_status(phase="draining")
        return lag

    def ensure_fresh(self) -> int:
        """Staleness gate for the serving loop: when the bound is exceeded,
        sync and force a swap AT THIS BOUNDARY before another request is
        decoded.  If even that cannot close the gap the replica DRAINS
        (default) — check ``draining`` / use ``admit()`` — or, with
        ``on_stale="raise"``, fails out of rotation with
        ``StaleReplicaError``.  Returns the lag after the gate.  With no
        bound configured this never blocks, drains, or raises."""
        with self._sync_lock:
            return self._gate()

    def admit(self) -> bool:
        """Admission control for the serving loop: True when the replica
        may take a NEW generation at this boundary.  Runs the staleness
        gate first, so a recovered replica re-admits on the same call that
        observes it caught up; a draining replica keeps finishing in-flight
        work (the engine only asks ``admit()`` for new admissions) and
        keeps returning False until the gap closes."""
        with self._sync_lock:
            self._gate()
            return not self._draining

    # -- registry status ------------------------------------------------
    def _publish_status(self, *, phase: str,
                        target_step: Optional[int] = None,
                        stats: Optional[dict] = None) -> None:
        if self.registry is None:
            return
        try:
            self.registry.publish_replica(
                self.replica, step=self.handle.step,
                target_step=target_step, phase=phase, stats=stats)
        except OSError:
            pass        # advisory, like every registry write: an unwritable
            #             inventory must never take the replica down

    # -- follower loop (launch/serve.py --follow) ----------------------
    def follow(self, *, poll_s: float = 0.5,
               stop: Optional[threading.Event] = None,
               on_sync: Optional[Callable[[dict], None]] = None,
               max_polls: Optional[int] = None) -> int:
        """Poll/fetch/stage until ``stop`` is set (or ``max_polls`` polls
        ran).  Swaps are still the ENGINE's business at its generation
        boundaries; this loop only keeps the staged side fresh.  Returns
        the number of syncs applied."""
        n = polls = 0
        while not (stop is not None and stop.is_set()):
            rec = self.sync_once()
            if rec is not None:
                n += 1
                if on_sync is not None:
                    on_sync(rec)
            polls += 1
            if max_polls is not None and polls >= max_polls:
                break
            if stop is not None:
                stop.wait(poll_s)
            else:
                time.sleep(poll_s)
        return n
