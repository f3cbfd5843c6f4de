"""Tiered checkpoint storage with k-replication.

Models the paper's Fig.-2 filesystem hierarchy: a container-image-cache-like
node-local tier (``ram`` / ``local``) vs a shared parallel filesystem
(``shared``).  Tiers carry simulated bandwidth/latency so benchmarks can
reproduce the paper's startup-time-vs-ranks effect on a single box; simulation
is off (factor 0) everywhere except the benchmarks.

Replication: a shard written at replication k lands in k distinct "node"
directories of the tier; reads fall back across replicas on checksum failure
or I/O error (the paper: "redundantly storing checkpoint images").  The
payload is serialized ONCE — the primary replica is written from the source
bytes/stream and the remaining k-1 replicas are fanned out with
``shutil.copyfile`` (kernel ``sendfile``/``copy_file_range`` on Linux), so
replica count multiplies disk traffic but not CPU serialization work.

Ranged access: ``get_range`` / ``read_shard_leaves`` serve sub-file reads via
positional ``pread``-style access, which is what lets the manager's
incremental restore pull single leaves out of multi-GB shards.  The ``_pread``
choke point keeps one open fd per replica file (``os.pread`` is positional and
thread-safe), so a task's coalesced reads — and the header/trailer/footer
triplet of every plan — reuse a descriptor instead of re-opening the shard
per range; every store-side mutation (rename-into-place, delete) invalidates
the cached descriptor so a replaced file is never read through a stale fd.

Peer tiers: ``add_peer`` registers another node's local root as an
addressable read-only tier (``peer:<node>``) carrying the ``peer``
``TierSpec`` — its own concurrency slots and simulated inter-node latency —
which is what lets the restore engine source ranges from a warm peer's
promoted cache instead of the shared parallel filesystem.

Chunk plane (v3 delta checkpoints): content-addressed chunk files live under
``<prefix>/chunks/<hash-prefix>/<hash>`` — one file per unique chunk,
whatever step(s) reference it.  ``put_chunk`` is the dedup write (a chunk
already present is never re-written), ``chunk_digests`` lists a tier's
inventory, and ``chunk_refcounts`` folds manifests into per-chunk reference
counts so GC reaps exactly the chunks no live manifest references (the CRIU
dirty-page idea applied to the store: a delta step writes only changed
chunks, and an unchanged chunk's single copy stays pinned by its refcount).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import queue
import random
import shutil
import threading
import time
from collections import OrderedDict
from pathlib import Path
from typing import BinaryIO, Callable, Iterable, Optional

from repro_torch.checkpoint import io_backend as IOB
from repro_torch.checkpoint import serialization as SER
from repro_torch.utils.atomic import atomic_write_bytes

# tiers whose backing store is a real (cold/shared parallel) filesystem —
# the ones worth reading O_DIRECT when the kernel supports it there.  The
# hot node-local tiers (ram/local) WANT the page cache; bypassing it would
# only add alignment waste.
DIRECT_IO_TIERS = ("shared",)


class _FanoutSink:
    """Write-once tee: chunks handed to ``write`` are streamed to every
    replica file by a dedicated kernel-writer thread each.

    Chunks are enqueued by reference (zero-copy for ``memoryview``s whose
    backing buffers outlive the ``put_stream`` call, which holds the source
    arrays).  Bounded queues give backpressure so a slow replica cannot make
    the producer buffer the whole shard.
    """

    _CLOSE = object()

    def __init__(self, paths: list[Path], queue_depth: int = 4):
        self.nbytes = 0
        self._queues = [queue.Queue(maxsize=queue_depth) for _ in paths]
        self._errs: list[BaseException] = []
        self._threads = [
            threading.Thread(target=self._drain, args=(p, q), daemon=True,
                             name=f"ckpt-fanout-{i}")
            for i, (p, q) in enumerate(zip(paths, self._queues))
        ]
        for t in self._threads:
            t.start()

    def _drain(self, path: Path, q: queue.Queue) -> None:
        try:
            with open(path, "wb") as fp:
                while True:
                    chunk = q.get()
                    if chunk is self._CLOSE:
                        return
                    fp.write(chunk)
        except BaseException as e:  # noqa: BLE001 — re-raised on the producer
            self._errs.append(e)
            while q.get() is not self._CLOSE:   # unblock the producer
                pass

    def writable(self) -> bool:
        return True

    def write(self, chunk) -> int:
        if self._errs:
            raise self._errs[0]
        for q in self._queues:
            q.put(chunk)
        n = len(chunk) if not isinstance(chunk, memoryview) else chunk.nbytes
        self.nbytes += n
        return n

    def _join(self) -> None:
        for q in self._queues:
            q.put(self._CLOSE)
        for t in self._threads:
            t.join()

    def finish(self) -> None:
        self._join()
        if self._errs:
            raise self._errs[0]

    def abort(self) -> None:
        self._join()


class _FdEntry:
    """One cached read descriptor: refcounted so LRU eviction / invalidation
    never closes an fd another thread is mid-``pread`` on."""

    __slots__ = ("fd", "refs", "dead")

    def __init__(self, fd: int):
        self.fd = fd
        self.refs = 0
        self.dead = False


@dataclasses.dataclass
class TierSpec:
    name: str
    bandwidth_gbps: float      # simulated sequential bandwidth
    latency_s: float           # simulated per-op latency
    nodes: int = 1             # distinct failure domains within the tier
    concurrency: int = 0       # max in-flight restore reads (0 = unbounded)


DEFAULT_TIERS = {
    "ram": TierSpec("ram", 40.0, 0.00005, nodes=1, concurrency=16),
    "local": TierSpec("local", 3.0, 0.0005, nodes=1, concurrency=4),
    "shared": TierSpec("shared", 1.0, 0.02, nodes=8, concurrency=8),
    # template for peer tiers (add_peer): a warm peer's node-local cache read
    # over the interconnect — slower than our own local tier, but far lower
    # per-op latency than the contended shared parallel FS, and each peer
    # brings its OWN concurrency slots (bandwidth aggregates across k peers)
    "peer": TierSpec("peer", 2.5, 0.002, nodes=1, concurrency=4),
}

PEER_TIER_PREFIX = "peer:"


def is_peer_tier(tier: str) -> bool:
    return tier.startswith(PEER_TIER_PREFIX)


# -- content-addressed chunk plane (v3 delta checkpoints) -------------------

CHUNKS_DIRNAME = "chunks"


def chunk_rel(prefix: str, digest: str) -> str:
    """Store-relative path of one content-addressed chunk.  The two-hex-char
    fan-out directory keeps any single directory from holding the whole
    chunk population (the classic git-objects layout)."""
    return f"{prefix}/{CHUNKS_DIRNAME}/{digest[:2]}/{digest}"


def chunk_digest_of(rel: str) -> Optional[str]:
    """Inverse of ``chunk_rel``: the digest if ``rel`` is a chunk file path,
    else None."""
    parts = Path(rel).parts
    if len(parts) >= 3 and parts[-3] == CHUNKS_DIRNAME:
        return parts[-1]
    return None


def manifest_chunk_hashes(manifest: dict) -> set[str]:
    """Every chunk digest a manifest's leaves reference (empty for v1/v2
    file-based manifests)."""
    return {c["hash"] for e in manifest.get("leaves", ())
            for c in (e.get("chunks") or ())}


def chunk_refcounts(manifests: Iterable[dict]) -> dict[str, int]:
    """Fold manifests into per-chunk reference counts — the GC input: a
    chunk is live while its count is nonzero, reapable at exactly zero.
    Counted per MANIFEST (a chunk shared by two leaves of one step still
    counts once per step), so the count is 'how many committed steps pin
    this chunk'."""
    counts: dict[str, int] = {}
    for man in manifests:
        for h in manifest_chunk_hashes(man):
            counts[h] = counts.get(h, 0) + 1
    return counts

# tiers that live on a cluster node rather than the shared parallel FS —
# the set every per-node mount point must cover
NODE_LOCAL_TIERS = ("ram", "local")


def node_local_tier_roots(local_root) -> dict:
    """The ``tier_roots`` mapping that mounts every node-local tier under one
    per-node directory (the single definition train.py, the placement test
    job, and the benchmarks all share)."""
    return {t: Path(local_root) for t in NODE_LOCAL_TIERS}


class TieredStore:
    def __init__(self, root: Path, tiers: Optional[dict] = None,
                 sim_io_factor: float = 0.0,
                 rng: Optional[random.Random] = None,
                 seed: Optional[int] = None,
                 tier_roots: Optional[dict] = None):
        self.root = Path(root)
        self.tiers = tiers or dict(DEFAULT_TIERS)
        # tier_roots: per-tier root override — the multi-node cluster model:
        # every simulated cluster node shares the same ``shared`` tier root but
        # mounts ITS OWN ``local``/``ram`` roots (sched/slurmsim.py NodeSpec),
        # so a shared->local promotion warms exactly one node's cache.
        self.tier_roots = {t: Path(p) for t, p in (tier_roots or {}).items()}
        self.sim_io_factor = sim_io_factor
        # Replica placement is randomized; an injectable RNG (or just a seed)
        # makes placement deterministic for tests/CI.  Never the module-level
        # ``random`` — a seeded test elsewhere must not change our placement.
        self._rng = rng if rng is not None else random.Random(seed)
        self._sems: dict[str, threading.BoundedSemaphore] = {}
        self._sems_lock = threading.Lock()
        # peer tiers: tier name -> concrete replica dirs on the peer's root
        self._peer_dirs: dict[str, list[Path]] = {}
        # fd cache for positional reads (see _pread); bounded, refcounted
        self._fds: OrderedDict[Path, _FdEntry] = OrderedDict()
        self._fd_lock = threading.Lock()
        self._fd_cap = 64
        # batched-read plane: per-tier O_DIRECT alignment (None = buffered),
        # probed lazily on the first batch against that tier.  direct_io:
        # "auto" probes DIRECT_IO_TIERS, False disables, True probes every
        # tier (benchmarks A/B the modes explicitly).
        self.direct_io: object = "auto"
        self._direct_align: dict[str, Optional[int]] = {}
        self._direct_lock = threading.Lock()

    # ------------------------------------------------------------------
    def add_peer(self, name: str, root, *, via_tier: str = "local") -> str:
        """Register (or re-point) another node's local root as a read-only
        tier ``peer:<name>``.  ``via_tier`` is the tier the peer's promoted
        cache lives in under its root (the peer's ``promote_tier``).  The new
        tier carries the ``peer`` TierSpec — its own concurrency slots and
        simulated inter-node latency — so peer reads are costed and bounded
        independently of every other source."""
        tier = f"{PEER_TIER_PREFIX}{name}"
        template = self.tiers.get("peer", DEFAULT_TIERS["peer"])
        self.tiers[tier] = dataclasses.replace(template, name=tier)
        n = self.tiers[via_tier].nodes if via_tier in self.tiers else 1
        self._peer_dirs[tier] = [
            Path(root) / via_tier / f"node{i}" for i in range(n)]
        return tier

    def peer_tiers(self) -> list[str]:
        return sorted(self._peer_dirs)

    # ------------------------------------------------------------------
    def _node_dirs(self, tier: str) -> list[Path]:
        if tier in self._peer_dirs:
            return self._peer_dirs[tier]
        spec = self.tiers[tier]
        root = self.tier_roots.get(tier, self.root)
        return [root / tier / f"node{i}" for i in range(spec.nodes)]

    def _rel_of(self, p: Path) -> str:
        """Store-relative name of a replica file, whichever root it nests
        under (the main root or a tier_roots override)."""
        for root in (self.root, *self.tier_roots.values()):
            try:
                return str(p.relative_to(root))
            except ValueError:
                continue
        return str(p)

    def _simulate(self, tier: str, nbytes: int) -> None:
        if not self.sim_io_factor:
            return
        spec = self.tiers[tier]
        t = spec.latency_s + nbytes / (spec.bandwidth_gbps * 1e9)
        time.sleep(t * self.sim_io_factor)

    def _choose_nodes(self, tier: str, replicas: int) -> list[Path]:
        nodes = self._node_dirs(tier)
        replicas = min(replicas, len(nodes))
        return nodes[:replicas] if replicas == len(nodes) else self._rng.sample(nodes, replicas)

    def tier_slots(self, tier: str):
        """Context manager bounding in-flight reads against ``tier`` to the
        spec's ``concurrency`` (the restore engine acquires one slot per
        ranged read; unbounded tiers return a no-op)."""
        spec = self.tiers[tier]
        if not spec.concurrency:
            return contextlib.nullcontext()
        with self._sems_lock:
            sem = self._sems.get(tier)
            if sem is None:
                sem = self._sems[tier] = threading.BoundedSemaphore(spec.concurrency)
        return sem

    def _replicate(self, tier: str, primary: Path, rel: str,
                   others: list[Path], written: list[str]) -> None:
        """Fan the primary replica out with an OS-level copy (no re-serialize)."""
        nbytes = primary.stat().st_size
        for nd in others:
            p = nd / rel
            p.parent.mkdir(parents=True, exist_ok=True)
            tmp = p.with_suffix(p.suffix + ".tmp")
            shutil.copyfile(primary, tmp)   # sendfile/copy_file_range path
            tmp.rename(p)
            self._fd_invalidate(p)
            self._simulate(tier, nbytes)
            written.append(self._rel_of(p))

    # ------------------------------------------------------------------
    def put(self, tier: str, rel: str, data: bytes, *, replicas: int = 1) -> list[str]:
        """Write ``data`` once, then copy-fan-out to the other replicas."""
        chosen = self._choose_nodes(tier, replicas)
        primary = chosen[0] / rel
        # unique-tmp atomic publish (utils.atomic): PROMOTED markers and
        # in-flight intent markers ride this path, and two writers racing
        # one marker must never interleave on a fixed <name>.tmp
        atomic_write_bytes(primary, data)
        self._fd_invalidate(primary)
        self._simulate(tier, len(data))
        written = [self._rel_of(primary)]
        self._replicate(tier, primary, rel, chosen[1:], written)
        return written

    def put_stream(self, tier: str, rel: str,
                   write_fn: Callable[[BinaryIO], object], *,
                   replicas: int = 1) -> list[str]:
        """Stream a payload once into all k replica files.

        ``write_fn(sink)`` is invoked exactly once — typically
        ``SER.write_shard_stream`` — so the payload is serialized a single
        time and never exists as a whole in memory.  Each chunk the writer
        emits is teed to one kernel-writer thread per replica; since both
        ``file.write`` and ``zlib.crc32`` release the GIL, the producer's CRC
        folding of chunk i+1 overlaps the disk writes of chunk i on every
        replica (the pipelined analogue of write-once + ``copyfile`` fan-out,
        minus the read-back).  Atomic per replica (tmp + rename-all at the
        end, so no torn replica is ever visible).
        """
        chosen = self._choose_nodes(tier, replicas)
        tmps, finals = [], []
        for nd in chosen:
            p = nd / rel
            p.parent.mkdir(parents=True, exist_ok=True)
            tmps.append(p.with_suffix(p.suffix + ".tmp"))
            finals.append(p)
        sink = _FanoutSink(tmps)
        try:
            write_fn(sink)
            sink.finish()
        except BaseException:
            sink.abort()
            for t in tmps:
                t.unlink(missing_ok=True)
            raise
        for tmp, final in zip(tmps, finals):
            tmp.rename(final)
            self._fd_invalidate(final)
            self._simulate(tier, sink.nbytes)
        return [self._rel_of(p) for p in finals]

    # -- chunk plane ---------------------------------------------------
    def put_chunk(self, tier: str, prefix: str, digest: str, data, *,
                  replicas: int = 1, force: bool = False) -> bool:
        """Dedup write into the chunk plane: a chunk whose content-addressed
        file already exists on ``tier`` is NOT re-written (that is the whole
        point — identical chunks across steps/leaves cost one write ever).
        Returns True iff bytes were actually written.  ``data`` may be any
        buffer (the delta writer hands zero-copy memoryviews).

        ``force=True`` writes even when the file exists (idempotent: same
        hash, same bytes, atomic tmp+rename).  The delta saver uses it for
        chunks NOT pinned by the parent manifest: trusting bare existence
        there would race a concurrent gc reaping that very file after its
        last committed reference retired (content that oscillates back)."""
        rel = chunk_rel(prefix, digest)
        if not force and self.exists(tier, rel):
            return False
        self.put(tier, rel, data, replicas=replicas)
        return True

    def get_chunk(self, tier: str, prefix: str, digest: str) -> bytes:
        return self.get(tier, chunk_rel(prefix, digest))

    def chunk_digests(self, tier: str, prefix: str) -> set[str]:
        """Every chunk digest present on ``tier`` (union across replicas)."""
        out = set()
        for rel in self.list_prefix(tier, f"{prefix}/{CHUNKS_DIRNAME}"):
            d = chunk_digest_of(rel)
            if d is not None:
                out.add(d)
        return out

    # -- fd cache ------------------------------------------------------
    def _fd_acquire(self, path: Path) -> "_FdEntry":
        with self._fd_lock:
            ent = self._fds.get(path)
            if ent is not None:
                ent.refs += 1
                self._fds.move_to_end(path)
                return ent
        # open outside the lock: a slow/erroring open must not serialize
        # every other tier's reads behind it
        fd = os.open(path, os.O_RDONLY)
        ent = _FdEntry(fd)
        ent.refs = 1
        with self._fd_lock:
            if path in self._fds:           # raced: use ours once, then close
                ent.dead = True
                return ent
            # TOCTOU guard: the file may have been renamed-over or deleted
            # between the open above and here — its _fd_invalidate found
            # nothing to kill, so caching now would pin the dead inode.
            # Checked under the lock: any mutation AFTER this stat must wait
            # for the lock and will find (and kill) our entry.
            try:
                live = os.stat(path).st_ino == os.fstat(ent.fd).st_ino
            except OSError:
                live = False
            if not live:
                ent.dead = True             # replaced mid-open: use once only
                return ent
            self._fds[path] = ent
            while len(self._fds) > self._fd_cap:
                for p, e in self._fds.items():       # LRU with refs==0 only
                    if e.refs == 0:
                        e.dead = True
                        os.close(e.fd)
                        del self._fds[p]
                        break
                else:
                    break
            return ent

    def _fd_release(self, path: Path, ent: "_FdEntry") -> None:
        with self._fd_lock:
            ent.refs -= 1
            if ent.dead and ent.refs == 0:
                os.close(ent.fd)
                if self._fds.get(path) is ent:
                    del self._fds[path]

    def _fd_invalidate(self, path: Path) -> None:
        """Drop the cached descriptor for ``path`` — called by every mutation
        that replaces or removes a file, so no read ever goes through a stale
        fd to a renamed-over or deleted inode."""
        with self._fd_lock:
            ent = self._fds.pop(Path(path), None)
            if ent is not None:
                ent.dead = True
                if ent.refs == 0:
                    os.close(ent.fd)

    def _fd_invalidate_under(self, prefix: Path) -> None:
        prefix = Path(prefix)
        with self._fd_lock:
            doomed = [p for p in self._fds
                      if p == prefix or prefix in p.parents]
        for p in doomed:
            self._fd_invalidate(p)

    def close(self) -> None:
        """Close every cached read descriptor (reads after this just re-open).

        Idempotent and shutdown-safe: callable any number of times, from
        ``__del__``, and during interpreter teardown — when module globals
        (``os``) may already be None — without raising.  ``_OS_CLOSE`` is
        bound at class-definition time so the close syscall survives the
        ``os`` module being torn down first; a descriptor that fails to
        close (EBADF from a racing release) is skipped, not fatal."""
        lock = getattr(self, "_fd_lock", None)
        if lock is None:            # __init__ never completed
            return
        with lock:
            ents, self._fds = list(self._fds.values()), OrderedDict()
        for ent in ents:
            ent.dead = True
            if ent.refs == 0:
                try:
                    self._OS_CLOSE(ent.fd)
                except (OSError, TypeError):
                    pass            # already closed / teardown half-done

    _OS_CLOSE = staticmethod(os.close)

    def __del__(self):  # noqa: D105 — best-effort fd cleanup
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter may be tearing down
            pass

    # ------------------------------------------------------------------
    def _pread(self, path: Path, offset: int, nbytes: int) -> bytes:
        """Positional read — the single choke point for all ranged I/O (tests
        wrap/override it to count bytes actually fetched).  Reuses one cached
        fd per replica file across a task's coalesced reads (``os.pread`` is
        positional, so concurrent range tasks share the descriptor safely)."""
        if not hasattr(os, "pread"):            # non-POSIX fallback
            with open(path, "rb") as fp:
                fp.seek(offset)
                return fp.read(nbytes)
        path = Path(path)
        ent = self._fd_acquire(path)
        try:
            return os.pread(ent.fd, nbytes, offset)
        finally:
            self._fd_release(path, ent)

    def replica_paths(self, tier: str, rel: str) -> list[Path]:
        """Existing replica files for ``rel``, primary-placement order.  The
        restore engine plans against the first parseable one and falls back
        across the rest per ranged read."""
        return [nd / rel for nd in self._node_dirs(tier) if (nd / rel).exists()]

    def pread(self, tier: str, path: Path, offset: int, nbytes: int) -> bytes:
        """Public positional read against a known replica file, with the
        tier's simulated I/O cost applied.  Raises ``OSError`` on a short
        read so a truncated replica triggers fallback, never silent loss."""
        data = self._pread(path, offset, nbytes)
        if len(data) != nbytes:
            raise OSError(f"short read {len(data)}/{nbytes} in {path}")
        self._simulate(tier, nbytes)
        return data

    # -- batched submission plane --------------------------------------
    def _simulate_batch(self, tier: str, nbytes: int) -> None:
        """Simulated cost of ONE batched submission: a single per-op latency
        plus the bandwidth term over the whole payload.  This is the honest
        model of what batching buys — the queue-depth latency is paid once
        per submission instead of once per range — and it is exactly why the
        ``restore_engine_io`` bench shows batched >= per-range on the same
        plan under simulation."""
        self._simulate(tier, nbytes)

    def _pread_hooked(self) -> bool:
        """True when ``_pread`` is wrapped or overridden (fault injectors,
        byte-counting test stores).  The batched backend then degrades to
        per-range ``self._pread`` calls so every instrumented byte is still
        observed — ``_pread`` stays the single choke point for ranged I/O
        whichever submission path is in front of it."""
        return ("_pread" in self.__dict__
                or type(self)._pread is not TieredStore._pread)

    def _direct_alignment(self, tier: str, sample_path: Path) -> Optional[int]:
        """O_DIRECT alignment for ``tier``, probed once per tier against the
        directory of an actual replica file (the probe is a filesystem
        property; tier roots decide the filesystem)."""
        mode = self.direct_io
        if not mode or (mode == "auto" and tier not in DIRECT_IO_TIERS):
            return None
        with self._direct_lock:
            if tier in self._direct_align:
                return self._direct_align[tier]
        align = IOB.probe_direct_io(Path(sample_path).parent)
        with self._direct_lock:
            self._direct_align[tier] = align
        return align

    def pread_batch(self, tier: str, requests) -> list:
        """Drain one batch of ``(path, offset, nbytes)`` reads against known
        replica files of ``tier`` in a single submission (``os.preadv``
        vectored reads, O_DIRECT-aligned where the tier's filesystem allows
        it).  ``nbytes=None`` reads the whole file (the chunk plane's case:
        a compressed chunk's on-disk size differs from its raw size).

        Returns a list aligned with ``requests``: ``bytes`` on success, the
        ``Exception`` for a failed/short range (not raised — the caller owns
        per-range fallback down its source chain).  Like ``pread``, the
        caller is expected to hold the tier's concurrency slot; unlike
        ``pread``, the simulated I/O cost is applied ONCE for the batch.
        """
        reqs = []
        results: list = [None] * len(requests := list(requests))
        for i, (path, offset, nbytes) in enumerate(requests):
            if nbytes is None:
                try:
                    nbytes = os.stat(path).st_size - offset
                except OSError as e:
                    results[i] = e
                    continue
            reqs.append((i, Path(path), offset, nbytes))
        if self._pread_hooked():
            # instrumented store: route every range through the choke point
            for i, path, offset, nbytes in reqs:
                try:
                    data = self._pread(path, offset, nbytes)
                    if len(data) != nbytes:
                        raise OSError(
                            f"short read {len(data)}/{nbytes} in {path}")
                    results[i] = data
                except OSError as e:
                    results[i] = e
        elif reqs:
            align = self._direct_alignment(tier, reqs[0][1])

            def _open(p: Path):
                ent = self._fd_acquire(p)
                return (ent.fd, ent)

            def _close(p: Path, handle) -> None:
                self._fd_release(p, handle[1])

            got = IOB.read_ranges([(p, off, n) for _, p, off, n in reqs],
                                  direct_align=align,
                                  open_fd=None if align else _open,
                                  close_fd=None if align else _close)
            for (i, path, offset, nbytes), data in zip(reqs, got):
                if isinstance(data, Exception):
                    results[i] = data
                elif len(data) != nbytes:
                    results[i] = OSError(
                        f"short read {len(data)}/{nbytes} in {path}")
                else:
                    results[i] = data
        ok_bytes = sum(len(r) for r in results if isinstance(r, bytes))
        self._simulate_batch(tier, ok_bytes)
        return results

    def get_ranges(self, tier: str, requests) -> list[bytes]:
        """Batched ranged read by store-relative name: ``requests`` is a
        whole plan's worth of ``(rel, offset, nbytes)`` descriptors.  Ranges
        are resolved to replica files, coalesced per file, and drained in
        one submission under ONE tier-slot acquisition; any range the batch
        could not serve retries through the per-range replica-fallback path
        (``get_range``), so the result is complete or an exception — exactly
        the serial semantics, minus the per-range submission cost."""
        requests = list(requests)
        paths: list = [None] * len(requests)
        for i, (rel, _off, _n) in enumerate(requests):
            cands = self.replica_paths(tier, rel)
            if cands:
                paths[i] = cands[0]
        with self.tier_slots(tier):
            got = self.pread_batch(
                tier, [(p, off, n) for p, (_rel, off, n)
                       in zip(paths, requests) if p is not None])
        out: list = [None] * len(requests)
        it = iter(got)
        for i, p in enumerate(paths):
            if p is not None:
                out[i] = next(it)
        for i, (rel, off, n) in enumerate(requests):
            if not isinstance(out[i], bytes):
                # replica fallback per failed range (simulated cost applies
                # again there — failures pay the retry, successes don't)
                out[i] = self.get_range(tier, rel, off, n)
        return out

    def copy_file(self, src_tier: str, rel: str, dst_tier: str,
                  *, src_path: Optional[Path] = None) -> Path:
        """OS-copy one intact-looking replica of ``src_tier:rel`` into the
        primary node of ``dst_tier`` (tmp + rename, so no torn copy is ever
        visible).  This is the tier-promotion primitive — the caller verifies
        CRCs on the copy before publishing any marker that references it."""
        if src_path is None:
            candidates = self.replica_paths(src_tier, rel)
            if not candidates:
                raise FileNotFoundError(f"{src_tier}:{rel}")
            src_path = candidates[0]
        dst = self._node_dirs(dst_tier)[0] / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        tmp = dst.with_suffix(dst.suffix + ".tmp")
        shutil.copyfile(src_path, tmp)      # sendfile/copy_file_range path
        tmp.rename(dst)
        self._fd_invalidate(dst)
        self._simulate(dst_tier, dst.stat().st_size)
        return dst

    def get(self, tier: str, rel: str) -> bytes:
        """Read with replica fallback; tries the next replica on ``OSError``
        (torn node, evicted cache) and raises ``FileNotFoundError`` only when
        no replica could be read."""
        errs: list[tuple[str, str]] = []
        for nd in self._node_dirs(tier):
            p = nd / rel
            if not p.exists():
                continue
            try:
                data = p.read_bytes()
            except OSError as e:           # damaged replica: try the next
                errs.append((str(p), str(e)))
                continue
            self._simulate(tier, len(data))
            return data
        suffix = f" (replica errors: {errs})" if errs else ""
        raise FileNotFoundError(f"{tier}:{rel}{suffix}")

    def size(self, tier: str, rel: str) -> int:
        for nd in self._node_dirs(tier):
            p = nd / rel
            try:
                return p.stat().st_size
            except OSError:
                continue
        raise FileNotFoundError(f"{tier}:{rel}")

    def mtime(self, tier: str, rel: str) -> float:
        """Modification time of the first replica that has the file (the
        orphan sweep's last-line race guard: a chunk re-touched after the
        sweep started is a writer's, not an orphan)."""
        for nd in self._node_dirs(tier):
            p = nd / rel
            try:
                return p.stat().st_mtime
            except OSError:
                continue
        raise FileNotFoundError(f"{tier}:{rel}")

    def get_range(self, tier: str, rel: str, offset: int, nbytes: int) -> bytes:
        """Ranged read with replica fallback on ``OSError``/short read (a
        truncated replica must not surface as silently-shorter data)."""
        errs: list[tuple[str, str]] = []
        for nd in self._node_dirs(tier):
            p = nd / rel
            if not p.exists():
                continue
            try:
                data = self._pread(p, offset, nbytes)
            except OSError as e:
                errs.append((str(p), str(e)))
                continue
            if len(data) != nbytes:
                errs.append((str(p), f"short read {len(data)}/{nbytes}"))
                continue
            self._simulate(tier, len(data))
            return data
        suffix = f" (replica errors: {errs})" if errs else ""
        raise FileNotFoundError(f"{tier}:{rel}{suffix}")

    def get_verified(self, tier: str, rel: str):
        """Read + parse a whole shard, falling back across replicas on crc
        failure.  Prefer ``read_shard_leaves`` when only some leaves are
        needed — it reads strictly fewer bytes."""
        return self.read_shard_leaves(tier, rel, None)

    def read_shard_leaves(self, tier: str, rel: str,
                          paths: Optional[list[str]] = None, *,
                          expect_crcs: Optional[dict[str, int]] = None):
        """Leaf-granular shard read: ({path: np.ndarray}, meta).

        Fetches only the header/footer plus the byte ranges of the requested
        ``paths`` (all leaves when ``None``).  A corrupted or unreadable
        replica triggers fallback to the next one.  ``expect_crcs`` lets the
        caller pin per-leaf CRCs (e.g. from a manifest): a mismatch against
        the shard header is detected before any payload bytes are read.
        """
        errs = []
        for nd in self._node_dirs(tier):
            p = nd / rel
            if not p.exists():
                continue

            def read_at(off: int, n: int) -> bytes:
                # per-op simulated latency (same accounting as the parallel
                # engine's ``pread``, so serial-vs-parallel timings compare)
                data = self._pread(p, off, n)
                if len(data) != n:
                    raise SER.ChecksumError(f"short read in {p}")
                self._simulate(tier, n)
                return data

            try:
                header = SER.read_shard_header(read_at, p.stat().st_size)
                if expect_crcs:
                    by_path = {t["path"]: t for t in header["tensors"]}
                    for path, crc in expect_crcs.items():
                        t = by_path.get(path)
                        if t is not None and t["crc32"] != crc:
                            raise SER.ChecksumError(
                                f"manifest crc mismatch: {path} in {rel}")
                return SER.read_shard_leaves(
                    read_at, p.stat().st_size, paths, header=header)
            except (SER.ChecksumError, OSError, ValueError, KeyError) as e:
                # KeyError: a parseable-but-stale replica missing a requested
                # leaf must fall back like any other damaged replica
                errs.append((str(p), repr(e)))
                continue
        raise SER.ChecksumError(f"no intact replica for {tier}:{rel}: {errs}")

    def exists(self, tier: str, rel: str) -> bool:
        return any((nd / rel).exists() for nd in self._node_dirs(tier))

    def delete_prefix(self, tier: str, prefix: str) -> None:
        for nd in self._node_dirs(tier):
            p = nd / prefix
            if p.is_dir():
                shutil.rmtree(p, ignore_errors=True)
                # invalidate AFTER the mutation (like put/copy_file): a read
                # racing the rmtree either misses the cache or gets an entry
                # this invalidation then kills — never a silently-pinned fd
                self._fd_invalidate_under(p)

    def delete_file(self, tier: str, rel: str) -> None:
        for nd in self._node_dirs(tier):
            p = nd / rel
            if p.exists():
                p.unlink()
                self._fd_invalidate(p)

    def glob(self, tier: str, prefix: str, pattern: str) -> set[str]:
        """Store-relative names of the files under ``prefix`` that match
        ``pattern`` (as ``Path.glob`` reads it), on every node of ``tier``."""
        out: set[str] = set()
        for nd in self._node_dirs(tier):
            for f in (nd / prefix).glob(pattern):
                if f.is_file():
                    out.add(str(f.relative_to(nd)))
        return out

    def list_prefix(self, tier: str, prefix: str) -> set[str]:
        out: set[str] = set()
        for nd in self._node_dirs(tier):
            p = nd / prefix
            if p.is_dir():
                for f in p.rglob("*"):
                    if f.is_file() and not f.name.endswith(".tmp"):
                        out.add(str(f.relative_to(nd)))
        return out
