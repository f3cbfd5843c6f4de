"""Parallel multi-shard, multi-source restore engine (paper Fig. 2).

The paper's headline cost is restoring checkpoint images from the shared
parallel filesystem at scale; DMTCP's answer is parallel per-rank restore plus
peers cooperating on restart, and NERSC's is a node-local container-image
cache.  This module is the framework analogue of all three:
``CheckpointManager.restore`` hands the manifest's (file -> leaves) map to a
``ParallelRestorer``, which fans the reads out across a thread pool instead of
walking shards one at a time — and, via ``restore_multi``, plans every
coalesced run against an ordered SOURCE LIST (local promoted cache, warm
peers' caches over the interconnect, then the shared filesystem) instead of a
single tier.

Plan phase: every referenced shard's header (a few hundred bytes) is fetched
concurrently from the first source holding a parseable replica, manifest CRCs
are pinned against it, and the requested leaves are coalesced into contiguous
runs — one ranged read each.  Runs larger than ``split_bytes`` are split at
leaf boundaries so one multi-GB shard becomes several same-order tasks
instead of a single straggler.

Schedule phase: tasks are issued largest-first (LPT — the classic greedy
bound on makespan), so the big reads start immediately and the small ones
backfill the tail.  Per-tier concurrency comes from ``TierSpec.concurrency``
via ``TieredStore.tier_slots``: each in-flight read against a tier holds one
of that tier's slots, so a pool sized for the RAM tier cannot stampede the
shared parallel filesystem — and since every registered peer tier brings its
OWN slots, k warm peers aggregate to k times the per-peer read bandwidth.
With multiple warm peers the per-task source chains are rotated round-robin,
so the range load spreads evenly across the peer set.

Fault model: each range task retries down its source chain independently —
an ``OSError`` / short read / CRC mismatch on one source falls back to the
next (the next peer, then the shared tier), exactly like the serial reader's
replica fallback, but scoped to the failed range rather than the whole shard.
Manifest CRCs are pinned whatever the source, so a stale or corrupt peer can
cost a retry, never wrong bytes.

Chunk plane (``restore_chunked``): content-addressed (v3) leaves resolve
per CHUNK instead of per byte range — every chunk independently walks an
ordered source list that starts with the node's own (possibly stale)
promoted cache, so a delta restore reads only the chunks the node is
actually missing from remote tiers.  Same fault model, same CRC pinning,
plus a whole-leaf CRC after assembly.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np

from repro_torch.checkpoint import serialization as SER
from repro_torch.checkpoint.store import chunk_rel, is_peer_tier
from repro_torch.utils.env import env_positive_int

DEFAULT_SPLIT_BYTES = 32 << 20      # target max payload bytes per range task

ENV_RESTORE_WORKERS = "REPRO_RESTORE_WORKERS"
ENV_IO_BATCH = "REPRO_IO_BATCH"
# ranges per batched submission: enough to amortize the per-submission
# latency across a plan's small ranges, small enough that one failed batch
# retries cheaply.  1 disables batching (the per-range legacy path, kept as
# the benchmark baseline).
DEFAULT_IO_BATCH = 16

log = logging.getLogger(__name__)


def auto_workers(cap: Optional[int] = None) -> int:
    """Restore pool sizing.  ``REPRO_RESTORE_WORKERS`` wins outright when
    set to a positive integer; otherwise the CPU count, capped by ``cap`` —
    the restore tier's ``TierSpec.concurrency`` budget (summed across sources
    for multi-source restores), so the pool is sized by what the storage can
    actually absorb rather than a magic constant.

    A mangled override (non-integer, zero, negative) degrades to auto sizing
    with a logged warning — an operator typo in a job script must never turn
    into a ``ValueError`` at restore time, which is exactly when the job can
    least afford to die (the parse contract lives in ``utils.env``)."""
    n = env_positive_int(ENV_RESTORE_WORKERS, logger=log)
    if n is not None:
        return n
    n = max(2, os.cpu_count() or 2)
    if cap:
        n = min(n, max(1, cap))
    return n


def auto_io_batch() -> int:
    """Ranges per batched submission.  ``REPRO_IO_BATCH`` wins when set to a
    positive integer; a mangled value degrades to the default with a logged
    warning — the same contract as the two worker knobs."""
    n = env_positive_int(ENV_IO_BATCH, logger=log)
    return n if n is not None else DEFAULT_IO_BATCH


@dataclasses.dataclass
class _ShardPlan:
    rel: str
    by_tier: dict                   # tier -> replica paths (plan-clean first)
    want: list[dict]                # offset-sorted header entries to fetch


@dataclasses.dataclass
class _RangeTask:
    rel: str
    sources: list[tuple[str, Path]]  # ordered (tier, path) fallback chain
    runs: list[list[dict]]           # contiguous runs, one submission all-up
    nbytes: int


@dataclasses.dataclass
class _ChunkWork:
    """One unique chunk to fetch (dedup'd: the same content hash wanted by
    several leaves — or several positions of one leaf — is read ONCE)."""
    digest: str
    nbytes: int
    crc32: Optional[int]
    users: list                     # (leaf_path, byte offset) placements
    by_tier: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class RestoreStats:
    workers: int
    files: int = 0
    tasks: int = 0
    bytes_read: int = 0             # payload bytes (headers excluded)
    replica_fallbacks: int = 0
    sources: list = dataclasses.field(default_factory=list)
    bytes_by_tier: dict = dataclasses.field(default_factory=dict)
    chunks: int = 0                 # unique chunks fetched (chunked restores)
    chunk_refs: int = 0             # chunk references before dedup

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class ParallelRestorer:
    """Fan manifest-referenced byte ranges out across a read pool.

    ``restore(tier, by_file)`` takes ``{shard_rel: [manifest leaf entries]}``
    and returns ``({leaf_path: np.ndarray}, RestoreStats)``;
    ``restore_multi(sources, by_file)`` does the same against an ordered
    source-tier list with per-range fallback down the chain.  Results are
    byte-identical to the serial ``TieredStore.read_shard_leaves`` loop — the
    engine only changes WHERE and WHEN each range is read, never what is
    verified.
    """

    def __init__(self, store, *, workers: int = 0,
                 split_bytes: int = DEFAULT_SPLIT_BYTES,
                 io_batch: int = 0):
        self.store = store
        self.workers = workers          # 0 = auto-size per restore (tier-aware)
        self.split_bytes = split_bytes
        # ranges per submission: 0 = $REPRO_IO_BATCH / default, 1 = the
        # per-range path (one pread per run — the pre-batching engine and
        # the benchmark baseline), N = up to N ranges per pread_batch
        self.io_batch = io_batch if io_batch > 0 else auto_io_batch()

    def _effective_workers(self, sources: list[str]) -> int:
        if self.workers > 0:
            return self.workers
        caps = [self.store.tiers[t].concurrency for t in sources
                if t in self.store.tiers]
        cap = None if (not caps or any(not c for c in caps)) else sum(caps)
        return auto_workers(cap)

    # -- plan ----------------------------------------------------------
    def _plan_shard(self, sources: list[str], rel: str, ents: list[dict],
                    shard_index: int = 0) -> _ShardPlan:
        """Parse one candidate's header, pin manifest CRCs against it, and
        keep every other candidate (all sources) as per-range fallbacks.
        Peer candidates are rotated by ``shard_index`` so header traffic —
        like range traffic — spreads across the warm peer set."""
        leaf_paths = [e["path"] for e in ents]
        expect = {e["path"]: e["crc32"] for e in ents
                  if e.get("crc32") is not None}
        by_tier = {t: self.store.replica_paths(t, rel) for t in sources}
        by_tier = {t: ps for t, ps in by_tier.items() if ps}
        candidates = [(t, p) for t in _ordered_tiers(sources, by_tier,
                                                     shard_index)
                      for p in by_tier[t]]
        errs: list[tuple[str, str, str]] = []
        for tier, p in candidates:
            try:
                # header reads hold tier slots like payload reads do — tier
                # concurrency is a property of the storage, not of the phase
                # (and it is what lets k peers aggregate during planning)
                with self.store.tier_slots(tier):
                    size = p.stat().st_size
                    header = SER.read_shard_header(
                        lambda off, n: self.store.pread(tier, p, off, n),
                        size)
                by_path = {t["path"]: t for t in header["tensors"]}
                for path, crc in expect.items():
                    t = by_path.get(path)
                    if t is not None and t["crc32"] != crc:
                        raise SER.ChecksumError(
                            f"manifest crc mismatch: {path} in {rel}")
                want = SER.select_leaves(header, leaf_paths)
                # plan-clean path first within its tier: range reads start on
                # a replica whose index is known parseable
                ps = by_tier[tier]
                by_tier[tier] = [p] + [q for q in ps if q != p]
                return _ShardPlan(rel=rel, by_tier=by_tier, want=want)
            except (SER.ChecksumError, OSError, ValueError, KeyError) as e:
                errs.append((tier, str(p), repr(e)))
        raise SER.ChecksumError(
            f"no intact replica for {'/'.join(sources)}:{rel}: {errs}")

    # -- execute -------------------------------------------------------
    @staticmethod
    def _run_span(run: list[dict]) -> tuple[int, int]:
        start = run[0]["offset"]
        return start, run[-1]["offset"] + run[-1]["nbytes"] - start

    def _exec_task(self, task: _RangeTask):
        """One submission with fallback down the (tier, path) source chain;
        returns the task's leaves plus (bytes_read, fallback_count, tier).

        A multi-run task is drained as ONE batched submission
        (``pread_batch``: vectored/direct reads, one slot, one simulated
        latency); a single-run task — and every task when ``io_batch == 1``
        — keeps the per-range ``pread``, byte-identical either way.  Any
        failed range fails the source: the whole task falls back to the
        next (tier, path), exactly the pre-batching semantics."""
        errs: list[tuple[str, str, str]] = []
        for i, (tier, p) in enumerate(task.sources):
            out: dict[str, np.ndarray] = {}
            try:
                with self.store.tier_slots(tier):
                    if len(task.runs) > 1:
                        spans = [self._run_span(r) for r in task.runs]
                        got = self.store.pread_batch(
                            tier, [(p, s, n) for s, n in spans])
                        nbytes = 0
                        for run, (start, _n), blob in zip(task.runs, spans,
                                                          got):
                            if isinstance(blob, Exception):
                                raise blob
                            nbytes += SER.read_run(
                                lambda off, n, b=blob, s=start:
                                    b[off - s:off - s + n],
                                run, out)
                    else:
                        nbytes = SER.read_run(
                            lambda off, n: self.store.pread(tier, p, off, n),
                            task.runs[0], out)
                return out, nbytes, i, tier
            except (SER.ChecksumError, OSError, ValueError) as e:
                errs.append((tier, str(p), repr(e)))
        raise SER.ChecksumError(
            f"no intact replica for {task.rel}"
            f"@{task.runs[0][0]['offset']}+{task.nbytes}: {errs}")

    # -- public --------------------------------------------------------
    def restore(self, tier: str, by_file: dict[str, list[dict]]):
        return self._run([tier], by_file)

    def restore_multi(self, sources: list[str],
                      by_file: dict[str, list[dict]]):
        """Multi-source restore: every range task gets a fallback chain built
        from ``sources`` in order, with warm peers rotated round-robin per
        task so k peers aggregate bandwidth instead of queueing on one."""
        return self._run(list(sources), by_file)

    def restore_chunked(self, sources: list[str], leaves: list[dict], *,
                        prefix: str, tee=None):
        """Restore content-addressed (v3) leaves against an ordered source
        list.  Returns ``({leaf_path: np.ndarray}, RestoreStats)``.

        Every chunk is resolved INDEPENDENTLY down the source list — which is
        what makes delta restores cheap: a requeued node whose stale local
        cache still holds 95% of the chunks reads those locally and fetches
        only the missing delta chunks from peers (or the shared tier).
        Duplicate sources and duplicate chunk references are dedup'd; chunks
        are batched into ~``split_bytes`` tasks grouped by their primary
        source, issued largest-first, with peers rotated round-robin per task.
        Per-chunk CRCs AND the whole-leaf CRC are pinned from the manifest,
        so the result is byte-identical to a full-shard restore or it fails.

        ``tee(rel, data, src_tier)``, if given, is invoked once per unique
        chunk AFTER its CRC verified, from the worker threads (callers
        bring their own synchronization).  The serving-fleet follower uses
        it to park remotely-fetched delta chunks in its node-local tier —
        the write-behind that makes replica-to-replica propagation possible
        without ever touching the node's promotion marker.
        """
        srcs = list(dict.fromkeys(sources))         # dedup, order-preserving
        workers = self._effective_workers(srcs)
        stats = RestoreStats(workers=workers, files=len(leaves),
                             sources=srcs)
        buffers: dict[str, np.ndarray] = {}
        works: dict[str, _ChunkWork] = {}
        for e in leaves:
            nbytes = sum(c["nbytes"] for c in e["chunks"])
            buffers[e["path"]] = np.empty(nbytes, dtype=np.uint8)
            off = 0
            for c in e["chunks"]:
                w = works.get(c["hash"])
                if w is None:
                    w = works[c["hash"]] = _ChunkWork(
                        digest=c["hash"], nbytes=c["nbytes"],
                        crc32=c.get("crc32"), users=[])
                w.users.append((e["path"], off))
                off += c["nbytes"]
                stats.chunk_refs += 1
        stats.chunks = len(works)
        if not works:
            return self._finish_chunked(leaves, buffers, stats)

        def locate(w: _ChunkWork) -> _ChunkWork:
            rel = chunk_rel(prefix, w.digest)
            w.by_tier = {t: ps for t in srcs
                         if (ps := self.store.replica_paths(t, rel))}
            return w

        with ThreadPoolExecutor(max_workers=workers,
                                thread_name_prefix="ckpt-restore") as pool:
            ordered = list(pool.map(locate,
                                    (works[d] for d in sorted(works))))
            # batch by primary source so one task streams from one tier;
            # cap at split_bytes so a large delta still fans out
            groups: dict[str, list[_ChunkWork]] = {}
            for w in ordered:
                first = next((t for t in srcs if w.by_tier.get(t)), "")
                groups.setdefault(first, []).append(w)
            tasks: list[list[_ChunkWork]] = []
            for _, ws in sorted(groups.items()):
                cur: list[_ChunkWork] = []
                cur_bytes = 0
                for w in ws:
                    if cur and cur_bytes + w.nbytes > self.split_bytes:
                        tasks.append(cur)
                        cur, cur_bytes = [], 0
                    cur.append(w)
                    cur_bytes += w.nbytes
                if cur:
                    tasks.append(cur)
            tasks.sort(key=lambda ws: sum(w.nbytes for w in ws),
                       reverse=True)                    # LPT order
            stats.tasks = len(tasks)
            futures = [pool.submit(self._exec_chunk_task, srcs, j, ws,
                                   buffers, prefix, tee)
                       for j, ws in enumerate(tasks)]
            for fut in futures:
                by_tier, fallbacks = fut.result()
                stats.replica_fallbacks += fallbacks
                for tier, n in by_tier.items():
                    stats.bytes_read += n
                    stats.bytes_by_tier[tier] = (
                        stats.bytes_by_tier.get(tier, 0) + n)
        return self._finish_chunked(leaves, buffers, stats)

    def _chunk_done(self, w: _ChunkWork, blob: bytes, raw: bytes, tier: str,
                    by_tier: dict, buffers: dict, prefix: str, tee) -> None:
        """Account + scatter one verified chunk.  ``blob`` is the on-disk
        file (possibly compression-framed), ``raw`` the verified content;
        byte attribution and the tee both use the FILE bytes, so
        ``bytes_by_tier`` reports what actually moved over each tier and a
        follower cache parks the same framed file the source tier holds."""
        by_tier[tier] = by_tier.get(tier, 0) + len(blob)
        if tee is not None:
            tee(chunk_rel(prefix, w.digest), blob, tier)
        for leaf_path, off in w.users:
            memoryview(buffers[leaf_path])[off:off + w.nbytes] = raw

    def _exec_chunk_task(self, srcs: list[str], index: int,
                         ws: list[_ChunkWork], buffers: dict,
                         prefix: str = "", tee=None):
        """Fetch one batch of chunks and scatter the verified bytes into the
        leaf buffers (disjoint regions, so no locking).

        With ``io_batch > 1`` the task's chunks are grouped by their
        first-choice source tier and each group drains as ONE batched
        submission (whole chunk files — a compressed chunk's on-disk size
        differs from its raw size, so the backend stats each file).  Any
        chunk the batch could not serve — and every chunk at
        ``io_batch == 1`` — retries independently down its own (tier, path)
        chain, exactly the pre-batching fault model.  Chunk files are
        unframed (``SER.unframe_chunk``) with the manifest CRC as arbiter,
        so compressed and legacy frameless chunks verify identically."""
        by_tier: dict[str, int] = {}
        fallbacks = 0
        pending: list[_ChunkWork] = list(ws)
        if self.io_batch > 1:
            groups: dict[str, list[tuple[_ChunkWork, Path]]] = {}
            unplaced: list[_ChunkWork] = []
            for w in ws:
                chain = [(t, p)
                         for t in _ordered_tiers(srcs, w.by_tier, index)
                         for p in w.by_tier[t]]
                if chain:
                    groups.setdefault(chain[0][0], []).append((w, chain[0][1]))
                else:
                    unplaced.append(w)
            pending = unplaced
            for tier, members in sorted(groups.items()):
                with self.store.tier_slots(tier):
                    got = self.store.pread_batch(
                        tier, [(p, 0, None) for _, p in members])
                for (w, _p), blob in zip(members, got):
                    raw = None
                    if isinstance(blob, bytes):
                        try:
                            raw = SER.unframe_chunk(blob, w.nbytes,
                                                    crc32=w.crc32)
                        except SER.ChecksumError:
                            raw = None
                    if raw is None:
                        pending.append(w)   # per-chunk fallback below
                    else:
                        self._chunk_done(w, blob, raw, tier, by_tier,
                                         buffers, prefix, tee)
        for w in pending:
            errs: list[tuple[str, str, str]] = []
            chain = [(t, p) for t in _ordered_tiers(srcs, w.by_tier, index)
                     for p in w.by_tier[t]]
            for i, (tier, p) in enumerate(chain):
                try:
                    with self.store.tier_slots(tier):
                        blob = self.store.pread(tier, p, 0,
                                                os.stat(p).st_size)
                    raw = SER.unframe_chunk(blob, w.nbytes, crc32=w.crc32)
                    break
                except (SER.ChecksumError, OSError, ValueError) as e:
                    errs.append((tier, str(p), repr(e)))
            else:
                raise SER.ChecksumError(
                    f"no intact source for chunk {w.digest}: {errs}")
            fallbacks += i
            self._chunk_done(w, blob, raw, tier, by_tier, buffers, prefix,
                             tee)
        return by_tier, fallbacks

    @staticmethod
    def _finish_chunked(leaves: list[dict], buffers: dict,
                        stats: RestoreStats):
        """Whole-leaf CRC check + dtype/shape materialization (zero-copy
        views over the assembled buffers)."""
        named: dict[str, np.ndarray] = {}
        for e in leaves:
            buf = buffers[e["path"]]
            if e.get("crc32") is not None and zlib.crc32(buf) != e["crc32"]:
                raise SER.ChecksumError(
                    f"leaf crc mismatch for {e['path']} after chunk assembly")
            named[e["path"]] = buf.view(
                SER.np_dtype(e["dtype"])).reshape(e["shape"])
        return named, stats

    def _run(self, sources: list[str], by_file: dict[str, list[dict]]):
        workers = self._effective_workers(sources)
        stats = RestoreStats(workers=workers, files=len(by_file),
                             sources=list(sources))
        if not by_file:
            return {}, stats
        named: dict[str, np.ndarray] = {}
        with ThreadPoolExecutor(max_workers=workers,
                                thread_name_prefix="ckpt-restore") as pool:
            plans = list(pool.map(
                lambda item: self._plan_shard(sources, item[1][0], item[1][1],
                                              shard_index=item[0]),
                enumerate(by_file.items())))
            tasks = []
            j = 0
            for plan in plans:
                runs = SER.coalesce_runs(plan.want,
                                         max_run_bytes=self.split_bytes)
                # pack runs into one submission each, up to io_batch ranges
                # and split_bytes total — small scattered leaves share one
                # vectored read, a split_bytes-sized run stays its own task
                # so LPT granularity (and the straggler bound) is unchanged
                packs: list[list[list[dict]]] = []
                cur: list[list[dict]] = []
                cur_bytes = 0
                for run in runs:
                    rb = sum(t["nbytes"] for t in run)
                    if cur and (len(cur) >= self.io_batch
                                or cur_bytes + rb > self.split_bytes):
                        packs.append(cur)
                        cur, cur_bytes = [], 0
                    cur.append(run)
                    cur_bytes += rb
                if cur:
                    packs.append(cur)
                for pack in packs:
                    chain = [(t, p)
                             for t in _ordered_tiers(sources, plan.by_tier, j)
                             for p in plan.by_tier[t]]
                    tasks.append(_RangeTask(
                        rel=plan.rel, sources=chain, runs=pack,
                        nbytes=sum(t["nbytes"] for r in pack for t in r)))
                    j += 1
            tasks.sort(key=lambda t: t.nbytes, reverse=True)   # LPT order
            stats.tasks = len(tasks)
            futures = [pool.submit(self._exec_task, t) for t in tasks]
            for fut in futures:
                out, nbytes, fallbacks, tier = fut.result()
                named.update(out)
                stats.bytes_read += nbytes
                stats.replica_fallbacks += fallbacks
                stats.bytes_by_tier[tier] = (
                    stats.bytes_by_tier.get(tier, 0) + nbytes)
        return named, stats


def _ordered_tiers(sources: list[str], by_tier: dict, index: int) -> list[str]:
    """Source order for one task: non-peer tiers keep their position, the
    peer subset is rotated by ``index`` (round-robin) so consecutive tasks
    start on different warm peers — that is the bandwidth aggregation."""
    avail = [t for t in sources if by_tier.get(t)]
    peers = [t for t in avail if is_peer_tier(t)]
    if len(peers) <= 1:
        return avail
    k = index % len(peers)
    rotated = iter(peers[k:] + peers[:k])
    return [next(rotated) if is_peer_tier(t) else t for t in avail]
