"""CheckpointManager: sharded, atomic, optionally async/incremental checkpoints.

Layout under the store (per tier):
  <prefix>/step_<N>/shard_w<world-id>.bin     one shard per worker
  <prefix>/step_<N>/wpart_<id>.json           per-worker manifest part
  <prefix>/step_<N>/MANIFEST.json             atomic commit marker (written LAST,
                                              by the coordinator / single worker)

A checkpoint exists iff MANIFEST.json exists — a preemption mid-write leaves no
manifest and the restart falls back to the previous step (two-phase commit, the
framework analogue of DMTCP's coordinator barrier).

Leaf ownership: leaf i belongs to worker (i % num_workers).  Restore reads every
worker part, so a checkpoint taken with N workers restores under M workers (the
MxN / elastic-restart property; mesh placement is re-derived by
core/virtualization.py).

Incremental mode (beyond-paper): a leaf whose crc32 is unchanged since the
previous *committed* checkpoint is not rewritten — its manifest entry points at
the older shard file.  GC keeps referenced base files alive.

Delta mode (``delta=True``, shard v3): the chunk-granular successor to
incremental — every leaf is split into fixed-size content-addressed chunks
and a save writes only the chunks whose hash changed since the parent step
(manifest v2 records the baseline+delta chain; GC reaps chunks by refcount).
Restores resolve each chunk against stale-local-cache -> peers -> shared, so
a warm-but-stale node fetches only the delta it is missing.

I/O plane (see EXPERIMENTS.md): each leaf is CRC'd exactly once per save (a
zero-copy pass that doubles as the incremental diff), then streamed through
``TieredStore.put_stream`` into a v2 shard — no whole-shard buffer, and the
k-replica fan-out is an OS-level copy of the primary.  Restore is
leaf-granular: only the byte ranges the manifest actually references are read
from each shard, so an incremental/MxN restore no longer re-reads whole base
shards.
"""
from __future__ import annotations

import json
import os
import threading
import time
import warnings
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import serialization as SER
from repro_torch.checkpoint.async_writer import AsyncWriter, WorkPool
from repro_torch.checkpoint.policy import PROMOTE_POLICIES, CheckpointPolicy
from repro_torch.checkpoint.restore_engine import ParallelRestorer
from repro_torch.checkpoint.store import (TieredStore, chunk_refcounts, chunk_rel,
                                    manifest_chunk_hashes)

__all__ = ["CheckpointManager", "CheckpointPolicy", "PROMOTE_POLICIES"]

# how far behind a stale peer's cached step may be before the chunk plane
# stops considering it a source: chunk overlap decays with step distance, and
# past this lag the probe cost (per-chunk existence checks over the
# interconnect) outweighs the expected hits
STALE_PEER_MAX_LAG = 64

# cap on per-probe stat calls in validate_promoted_cache: a delta cache
# references one file per chunk, and the scheduler probes MANY nodes
PROBE_MAX_FILES = 64


def _step_dir(prefix: str, step: int) -> str:
    return f"{prefix}/step_{step:010d}"


def is_chunked_manifest(manifest: dict) -> bool:
    """True when any leaf resolves through the content-addressed chunk plane
    (v3 delta checkpoints) rather than a shard file.  Keyed on the presence
    of ``chunks`` — a zero-byte leaf legitimately has an EMPTY chunk list
    and must still restore through the chunk plane, not vanish."""
    return any("chunks" in e for e in manifest.get("leaves") or ())


def manifest_payload_map(manifest: dict, prefix: str) -> dict[str, tuple]:
    """Every payload file a manifest references, with what verifies it:
    ``rel -> ("shard", [leaf entries])`` for v1/v2 file-based leaves,
    ``rel -> ("chunk", chunk entry)`` for content-addressed chunks.  The
    single definition promotion, cache validation and the registry all share
    — so a delta checkpoint promotes/validates chunk-by-chunk exactly like a
    full one promotes shard-by-shard."""
    out: dict[str, tuple] = {}
    for e in manifest["leaves"]:
        if "chunks" in e:
            for c in e["chunks"]:
                out.setdefault(chunk_rel(prefix, c["hash"]), ("chunk", c))
        elif e.get("file"):
            out.setdefault(e["file"], ("shard", []))[1].append(e)
    return out


def committed_steps(store: TieredStore, tier: str, prefix: str) -> list[int]:
    """Steps with a MANIFEST.json on ``tier`` (a checkpoint exists iff its
    manifest does).  Module-level so schedulers can enumerate without
    constructing a manager."""
    out = set()
    for r in store.list_prefix(tier, prefix):
        parts = Path(r).parts
        if len(parts) >= 2 and parts[-1] == "MANIFEST.json":
            out.add(int(parts[-2].split("_")[1]))
    return sorted(out)


def validate_promoted_cache(store: TieredStore, *, tier: str = "shared",
                            promote_tier: str = "local",
                            prefix: str = "ckpt",
                            latest: Optional[int] = None) -> dict:
    """Scheduler-facing cache inventory: is ``promote_tier``'s promoted cache
    warm for the LATEST step committed on ``tier``?

    Invalidation-aware and cheap (no payload reads): the marker must parse
    (a torn ``PROMOTED.json`` is cold, not an error), its step must equal the
    latest committed step (a superseded marker is stale), the promoted
    manifest must parse and match, and referenced payload files (shards or
    chunks; sampled when a delta cache references more than
    ``PROBE_MAX_FILES`` of them) must exist in the promote tier at the
    source file's size (catching truncation).
    Deliberately advisory — deep CRC verification stays in the restore path,
    so a probe that wrongly says "warm" costs one cache miss, never stale
    bytes.

    Returns ``{"valid", "step", "latest", "files", "reason"}``.  A caller
    probing MANY nodes against one shared tier can pass ``latest`` (the
    newest committed step) to skip the per-node re-listing of the shared
    prefix — the listing is node-independent.
    """
    info: dict = {"valid": False, "step": None, "latest": None,
                  "files": 0, "reason": ""}
    if latest is None:
        steps = committed_steps(store, tier, prefix)
        latest = steps[-1] if steps else None
    info["latest"] = latest
    marker_rel = f"{prefix}/PROMOTED.json"
    try:
        marker = json.loads(store.get(promote_tier, marker_rel).decode())
        if not isinstance(marker, dict):
            raise ValueError("marker is not an object")
    except FileNotFoundError:
        # get() reports an unreadable-everywhere file as not-found; a marker
        # that exists but cannot be read is torn, not absent
        info["reason"] = ("torn promoted marker"
                         if store.exists(promote_tier, marker_rel)
                         else "no promoted marker")
        return info
    except (ValueError, OSError):
        info["reason"] = "torn promoted marker"
        return info
    info["step"] = step = marker.get("step")
    if info["latest"] is None:
        info["reason"] = "no committed checkpoint on source tier"
        return info
    if step != info["latest"]:
        info["reason"] = f"stale (cached step {step}, latest {info['latest']})"
        return info
    try:
        man = json.loads(store.get(
            promote_tier, f"{_step_dir(prefix, step)}/MANIFEST.json").decode())
        if man.get("step") != step:
            raise ValueError("promoted manifest step mismatch")
        rels = sorted(manifest_payload_map(man, prefix))
    except (FileNotFoundError, ValueError, OSError, KeyError, TypeError):
        info["reason"] = "damaged promoted manifest"
        return info
    probe = rels
    if len(rels) > PROBE_MAX_FILES:
        # a chunked (delta) cache can reference thousands of chunk files;
        # stat'ing them all would break this probe's "cheap, many nodes"
        # contract.  The probe is ADVISORY by design (deep verification
        # stays in the restore path), so an evenly-spaced sample bounds the
        # cost — a wrongly-warm verdict costs one cache miss, never stale
        # bytes
        stride = len(rels) / PROBE_MAX_FILES
        probe = [rels[int(i * stride)] for i in range(PROBE_MAX_FILES)]
    for rel in probe:
        try:
            cached = store.size(promote_tier, rel)
        except FileNotFoundError:
            info["reason"] = f"missing promoted file {rel}"
            return info
        try:
            src = store.size(tier, rel)
        except FileNotFoundError:
            src = cached            # source retired by GC: existence is enough
        if cached != src:
            info["reason"] = f"size mismatch for {rel} ({cached} != {src})"
            return info
    info["files"] = len(rels)
    info["valid"] = True
    info["reason"] = "warm"
    return info


class CheckpointManager:
    def __init__(self, store: TieredStore,
                 policy: Optional[CheckpointPolicy] = None, *,
                 worker_id: int = 0, num_workers: int = 1,
                 peer_roots: Optional[dict] = None,
                 node: Optional[str] = None, registry=None, **legacy):
        """``CheckpointManager(store, CheckpointPolicy(...), worker_id=...)``.

        The second argument carries POLICY (how checkpoints are written,
        kept, promoted, restored — see ``checkpoint/policy.py``); the
        keyword arguments carry IDENTITY (who this manager is inside the
        cluster: worker/world ids, peer hints, registry handle).  The old
        flat policy kwargs (``tier=``, ``delta=``, ``promote=``, …) still
        work through a deprecation shim that builds the policy for you.
        """
        if legacy:
            if policy is not None:
                raise TypeError(
                    "pass either a CheckpointPolicy or legacy policy "
                    f"keywords, not both: {sorted(legacy)}")
            unknown = set(legacy) - set(CheckpointPolicy.field_names())
            if unknown:
                raise TypeError(
                    f"unknown CheckpointManager keyword(s): {sorted(unknown)}")
            warnings.warn(
                "CheckpointManager policy keywords "
                f"({', '.join(sorted(legacy))}) are deprecated; pass a "
                "CheckpointPolicy as the second positional argument instead",
                DeprecationWarning, stacklevel=2)
            policy = CheckpointPolicy(**legacy)
        policy = policy if policy is not None else CheckpointPolicy()
        self.policy = policy
        self.store = store
        self.tier = policy.tier
        self.worker_id = worker_id
        self.num_workers = num_workers
        self.replicas = policy.replicas
        self.mode = policy.mode
        self.incremental = policy.incremental
        # delta mode: saves go through the content-addressed chunk plane —
        # only chunks whose hash changed since the parent step are written,
        # and the manifest records the baseline+delta chain.  rebase_every
        # bounds the chain length (metadata hygiene: content addressing means
        # a "rebaseline" costs no extra payload writes, it only resets the
        # chain the manifest reports).
        self.delta = policy.delta
        self.rebase_every = policy.rebase_every
        self.chunk_bytes = policy.chunk_bytes or SER.DELTA_CHUNK_BYTES
        self.keep_last = policy.keep_last
        self.prefix = policy.prefix
        self.shard_format = policy.shard_format
        # restore_workers: 0 = auto-sized pool, 1 = serial (legacy loop, kept
        # as the benchmark baseline), N = pool of N readers
        self.restore_workers = policy.restore_workers
        # fingerprint=True: delta saves stamp a 32-bit per-chunk fingerprint
        # into the manifest and use the parent step's fingerprints as a
        # dirty-chunk PRE-FILTER — fp-equal chunks skip blake2b entirely.
        # Opt-in because a dirty chunk colliding on 32 bits (p ~ 2^-32 per
        # chunk) would be silently treated as clean; the default path keeps
        # the full-hash guarantee.  hash_workers sizes the parallel chunk
        # hash engine (0 = auto / $REPRO_HASH_WORKERS, 1 = serial).
        self.fingerprint = policy.fingerprint
        # device_fp=True: dirty detection happens ON the accelerator —
        # ``save(step, tree)`` takes the live DEVICE tree, runs the chunk
        # fingerprint kernel over every resident leaf, and device_gets only
        # the chunks whose fingerprint differs from the pre-dump/parent
        # reference; clean chunks reuse the reference entries with zero
        # device->host bytes.  Entries always carry ``fp`` so the
        # comparison survives restarts (the manifest persists the vector).
        # Same 32-bit-collision trade-off as fingerprint=True, accepted by
        # opting in.  ``device_fp_impl`` picks the kernel backend
        # (auto/pallas = the CUDA kernel for CUDA leaves and the plain
        # version for CPU ones; ref/xla = the plain version, CPU leaves only;
        # see kernels/ops.py), with an environment override for tests.
        self.device_fp = policy.device_fp
        self.device_fp_impl = os.environ.get("REPRO_DEVICE_FP_IMPL", "auto")
        self.hash_workers = policy.hash_workers
        # compress: per-chunk frame level in the dedup store (0 = frameless
        # raw bytes, the original format).  Hashes/CRCs/fingerprints
        # are always over UNCOMPRESSED content, so mixing levels across
        # steps — or reading another manager's frameless chunks — is safe.
        self.compress = policy.compress
        # io_batch: ranges per batched read submission on restore (0 = env
        # knob $REPRO_IO_BATCH / default, 1 = per-range reads)
        self.io_batch = policy.io_batch
        self._hash_engine: Optional[SER.ChunkHashEngine] = None
        # pre-dump (precommit) state: hashed/pre-written snapshot of a step,
        # produced on a background pool, consumed by the next _save_delta
        self._predump: Optional[dict] = None
        self._predump_pending = False
        self._predumper: Optional[WorkPool] = None
        self.promote = policy.promote
        self.promote_tier = policy.promote_tier
        # peer fabric: scheduler-provided warm-peer hint ({name: local_root})
        # plus an optional CacheRegistry for decentralized discovery; ``node``
        # is this manager's own cluster-node identity (what it publishes
        # registry entries under, and what it excludes from peer lookups)
        self.peer_roots = {str(k): Path(v)
                           for k, v in (peer_roots or {}).items()}
        self.node = node
        self.registry = registry
        self._writer = AsyncWriter() if self.mode == "async" else None
        # write-behind promotion: one copier, small bound — a restore returns
        # as soon as state is materialized; the tee into the node-local tier
        # trails it (and at most two promotions can be pending)
        self._promoter = (WorkPool(max_inflight=2, workers=1,
                                   name="ckpt-promote")
                          if self.promote != "off" else None)
        self.promote_failures: list[str] = []
        self.promote_skipped = 0           # promotions dropped, pool was busy
        self.promote_cancelled = 0         # promotions aborted by GC mid-copy
        # in-flight promotion bookkeeping: gc() flags a step it is about to
        # delete so the write-behind copier aborts instead of publishing a
        # marker over half-copied, source-retired files.  Counted from
        # SCHEDULE time (not execution) so a promotion still queued behind a
        # busy copier is cancellable too, and counted per-step because the
        # same step can be scheduled more than once (eager commit + restore).
        self._promo_lock = threading.Lock()
        self._promo_inflight: dict[int, int] = {}
        self._promo_doomed: set[int] = set()
        self.last_restore_stats: Optional[dict] = None
        self.last_orphan_sweep: Optional[dict] = None
        self._prev_manifest: Optional[dict] = None

    # ------------------------------------------------------------------
    def _my_leaves(self, records):
        return [
            (i, name, arr) for i, (name, arr) in enumerate(records)
            if i % self.num_workers == self.worker_id
        ]

    def save(self, step: int, tree, extra_meta: Optional[dict] = None) -> dict:
        """Snapshot + write this worker's shard.  Returns the worker part dict.

        In async mode the device->host snapshot happens here (the only quiesced
        section); serialization and store writes run on the writer pool.  Each
        leaf's CRC32 is computed exactly once per save, from a zero-copy byte
        view, and serves as both the incremental diff key and the stored shard
        checksum — see the ``diff`` comment below for where it is computed.
        """
        if self.delta and self.device_fp:
            # device-resident dirty detection: NO full snapshot — the
            # fingerprint pass runs on the live tree and only fp-dirty
            # chunk ranges are device_get'd
            return self._save_delta_device(step, tree, extra_meta)
        t0 = time.time()
        records = SER.tree_to_records(tree)            # snapshot (device_get)
        snap_s = time.time() - t0
        if self.delta:
            return self._save_delta(step, records, snap_s, extra_meta)
        mine = self._my_leaves(records)
        sdir = _step_dir(self.prefix, step)
        shard_rel = f"{sdir}/shard_w{self.worker_id:05d}.bin"

        prev_entries = {}
        # The incremental diff needs every leaf's CRC before deciding what to
        # stream, so it pre-computes them (one zero-copy pass) and hands them
        # to the writer via ``crcs=``.  Without a diff, the CRC is instead
        # folded chunk-by-chunk inside the streaming writer, overlapped with
        # the replica disk writes.  Either way: exactly one CRC per leaf
        # (except shard_format=1, whose legacy writer re-CRCs internally —
        # compat path only).  In async v2 mode the writer-pool task fills the
        # folded CRCs into the returned part's entries (atomic per-field);
        # they are final once ``wait_writes()`` returns, which ``commit()``
        # always awaits before reading parts back.
        diff = self.incremental and self._prev_manifest is not None
        if diff:
            prev_entries = {
                e["path"]: e for e in self._prev_manifest["leaves"]
            }

        entries, to_write, crcs = [], [], {}
        pending = {}                        # name -> entry awaiting writer crc
        for idx, name, arr in mine:
            if diff or self.shard_format == 1:
                crc = SER.leaf_checksum(arr)
                prev = prev_entries.get(name)
                if prev is not None and prev["crc32"] == crc and prev.get("file"):
                    entries.append({**prev, "reused": True})
                    continue
                crcs[name] = crc
            else:
                crc = None
            to_write.append((name, arr))
            entry = {
                "path": name, "index": idx, "crc32": crc,
                "dtype": SER.dtype_name(arr.dtype), "shape": list(arr.shape),
                "file": shard_rel, "reused": False,
            }
            if crc is None:
                pending[name] = entry
            entries.append(entry)

        part = {
            "worker_id": self.worker_id,
            "num_workers": self.num_workers,
            "step": step,
            "leaves": entries,
            "snapshot_s": snap_s,
            "meta": extra_meta or {},
        }

        def do_write():
            # the wpart references writer-computed CRCs, so in async mode the
            # whole body runs as one pool task; commit()'s wait_writes() is
            # the barrier before the manifest is cut
            if to_write:
                if self.shard_format == 1:     # legacy byte-identical v1 path
                    data = SER.write_shard_bytes(to_write, meta={"step": step})
                    self.store.put(self.tier, shard_rel, data,
                                   replicas=self.replicas)
                else:
                    footer = {}
                    self.store.put_stream(
                        self.tier, shard_rel,
                        lambda fp: footer.update(SER.write_shard_stream(
                            fp, to_write, meta={"step": step},
                            crcs=crcs or None)),
                        replicas=self.replicas)
                    for t in footer["tensors"]:
                        if t["path"] in pending:
                            pending[t["path"]]["crc32"] = t["crc32"]
            self.store.put(
                self.tier, f"{sdir}/wpart_{self.worker_id:05d}.json",
                json.dumps(part).encode(), replicas=self.replicas)

        if self._writer is not None:
            self._writer.submit(do_write)
        else:
            do_write()
        return part

    # -- delta (content-addressed chunk) save --------------------------
    def _parent_manifest(self) -> Optional[dict]:
        """The manifest a delta save/commit diffs against: the LATEST
        COMMITTED step on the store, with ``_prev_manifest`` as a same-step
        cache.  It must track the store, not this manager's last commit or
        restore: a distributed worker never commits (the coordinator does),
        so a baseline pinned at its restore-time manifest would (a) grow the
        per-step delta with total drift instead of per-step change and
        (b) eventually skip chunk writes against a manifest GC has already
        retired — referencing reaped chunks.  The latest committed manifest
        is always in the GC keep set, so its chunks cannot be reaped under
        an in-flight save."""
        try:
            steps = self.steps()
        except OSError:
            return self._prev_manifest
        if not steps:
            return self._prev_manifest
        latest = steps[-1]
        if (self._prev_manifest is not None
                and self._prev_manifest.get("step") == latest):
            return self._prev_manifest
        try:
            self._prev_manifest = self.read_manifest(latest)
        except (FileNotFoundError, ValueError, KeyError, OSError):
            return self._prev_manifest
        return self._prev_manifest

    @property
    def hash_engine(self) -> SER.ChunkHashEngine:
        """Lazily built parallel chunk hash/CRC engine (a WorkPool is only
        spun up on the first delta save that needs it — many short-lived
        managers never do)."""
        if self._hash_engine is None:
            self._hash_engine = SER.ChunkHashEngine(workers=self.hash_workers)
        return self._hash_engine

    # -- pre-dump (overlapped snapshot) ---------------------------------
    def precommit(self, step: int, tree,
                  extra_meta: Optional[dict] = None) -> dict:
        """CRIU-style pre-dump: snapshot now, hash/fingerprint/pre-write in
        the background, so the NEXT ``save()`` only pays for what changed
        since this call.

        The device->host snapshot happens here (the only step-visible part);
        chunking, fingerprinting, content hashing and the pre-write of
        new-vs-parent chunks all run on the writer pool (async mode) or a
        dedicated single-thread pool, overlapped with the following training
        step(s).  ``save()`` consumes the pre-dump: chunks whose live
        fingerprint equals the pre-dump fingerprint reuse the pre-computed
        hash/CRC and the already-written chunk file; only chunks dirtied
        AFTER the pre-dump are hashed and written inside the save stall.

        Pre-written chunks that the eventual save no longer references are
        orphans no manifest will ever name: the manifest-walking part of
        gc() cannot reap them, so the consuming save sweeps them directly
        when it is the only writer (see ``_save_delta``), and the
        coordinator's ``sweep_orphan_chunks`` pass reclaims them in
        multi-worker runs (barriered on the in-flight intent markers this
        pre-dump publishes).  Returns ``{"step", "snapshot_s"}``.
        """
        if not self.delta:
            raise ValueError("precommit requires delta mode")
        if self.device_fp:
            return self._precommit_device(step, tree)
        t0 = time.time()
        records = SER.tree_to_records(tree)        # snapshot (device_get)
        snap_s = time.time() - t0
        snap_bytes = sum(np.asarray(a).nbytes for _, a in records)
        mine = self._my_leaves(records)
        parent = self._parent_manifest()
        parent_hashes = manifest_chunk_hashes(parent) if parent else set()
        parent_leaves = {e["path"]: e["chunks"]
                         for e in (parent or {}).get("leaves", ())
                         if "chunks" in e}

        def do_predump():
            # intent marker FIRST: the coordinator's orphan sweep
            # (sweep_orphan_chunks) treats any fresh marker as "a writer may
            # be mid-flight" and backs off, so chunks this pre-dump is about
            # to write — referenced by no manifest yet — cannot be reaped
            # from under it
            marker_rel = self._inflight_rel("predump", step)
            self.store.put(self.tier, marker_rel,
                           json.dumps({"kind": "predump", "step": step,
                                       "worker": self.worker_id,
                                       "t": time.time()}).encode(),
                           replicas=1)
            # superseding an unconsumed pre-dump must not drop its write
            # set: those chunks are referenced by no manifest, so only the
            # consuming save's sweep can ever reclaim them.  Carrying them
            # forward keeps them in sweep scope (and skips re-writing any
            # this round re-produces).  Safe to read here: pre-dump tasks
            # run serially on one pool and _consume_predump drains it
            # before swapping.
            prev = self._predump
            if prev is not None and prev.get("chunk_bytes") != self.chunk_bytes:
                prev_leaves = {}
            else:
                prev_leaves = (prev or {}).get("leaves") or {}
            t1 = time.perf_counter()
            fps = {name: SER.fingerprint_chunks(
                       SER.as_byte_view(np.asarray(arr)), self.chunk_bytes)
                   for _, name, arr in mine}
            # iterative pre-copy (CRIU): at lead k the PREVIOUS lead's
            # entries (else the parent manifest's) are the reference — an
            # fp-clean chunk reuses its hash/CRC outright, so lead N-1
            # hashes only what dirtied since lead N-2, not the whole tree.
            # Same 32-bit trust the pre-dump consumption path already
            # accepts (fps are stamped on every pre-dump entry).
            known: dict = {}
            for _, name, _arr in mine:
                fp = fps[name]
                if name in prev_leaves:
                    refs = prev_leaves[name]["entries"]
                else:
                    refs = parent_leaves.get(name)
                if not refs:
                    continue
                kmap = {i: e for i, e in enumerate(refs)
                        if i < len(fp) and e.get("fp") is not None
                        and int(fp[i]) == int(e["fp"])}
                if kmap:
                    known[name] = kmap
            hashed, hstats = self.hash_engine.chunk_records(
                [(name, arr) for _, name, arr in mine], self.chunk_bytes,
                known=known, fps=fps)
            hash_s = time.perf_counter() - t1
            t1 = time.perf_counter()
            written: set = set((prev or {}).get("written") or ())
            cbytes: dict = dict((prev or {}).get("cbytes") or {})
            # markers travel with the write set they protect: a superseded
            # pre-dump's marker stays up until the save that consumes (and
            # sweeps) the carried chunks finally lands
            markers = list((prev or {}).get("markers") or ())
            markers.append(marker_rel)
            leaves = {}
            prewritten_n = 0
            for _, name, _arr in mine:
                entries, views, leaf_crc = hashed[name]
                leaves[name] = {"entries": entries, "crc32": leaf_crc}
                for e, v in zip(entries, views):
                    h = e["hash"]
                    if h in parent_hashes or h in written:
                        continue
                    # force=True for the same gc-race reason as the save
                    # path; the save re-checks existence before trusting a
                    # pre-written chunk, so a reap between now and then is
                    # repaired, not served
                    blob = (SER.frame_chunk(v, self.compress)
                            if self.compress else v)
                    self.store.put_chunk(self.tier, self.prefix, h, blob,
                                         replicas=self.replicas, force=True)
                    written.add(h)
                    cbytes[h] = len(blob)
                    prewritten_n += 1
            self._predump = {
                "step": step, "chunk_bytes": self.chunk_bytes,
                "leaves": leaves, "written": written, "markers": markers,
                "cbytes": cbytes,
                "hash_s": hash_s, "write_s": time.perf_counter() - t1,
                "chunks_hashed": hstats["chunks_hashed"],
                "chunks_prewritten": prewritten_n,
                "d2h_bytes": snap_bytes, "d2h_s": snap_s,
                "fp_device_s": 0.0,
                "chunks_clean_device": 0,
            }

        self._predump_pending = True
        pool = self._writer
        if pool is None:
            if self._predumper is None:
                # bound 2: one executing + one queued pre-dump; a third
                # precommit back-pressures rather than pinning snapshots
                self._predumper = WorkPool(max_inflight=2, workers=1,
                                           name="ckpt-predump")
            pool = self._predumper
        pool.submit(do_predump)
        return {"step": step, "snapshot_s": snap_s}

    def _consume_predump(self) -> Optional[dict]:
        """Claim the latest pre-dump for the save in progress (waiting out a
        still-running background phase — training finishing early shrinks
        the overlap win, never corrupts).  Chunk-size changes invalidate."""
        if not self._predump_pending and self._predump is None:
            return None
        if self._predump_pending:
            pool = self._writer if self._writer is not None else self._predumper
            if pool is not None:
                pool.wait()
            self._predump_pending = False
        pre, self._predump = self._predump, None
        if pre is not None and pre.get("chunk_bytes") != self.chunk_bytes:
            # invalidated pre-dump: its chunks become coordinator-sweep fodder
            # the moment the intent markers come down (no save will ever
            # reference or sweep them itself)
            for rel in pre.get("markers") or ():
                self.store.delete_file(self.tier, rel)
            return None
        return pre

    def _precommit_device(self, step: int, tree) -> dict:
        """Device-side pre-dump: the fingerprint pass and the ranged D2H of
        dirty chunk runs happen HERE on the training thread (donation-safe
        — no deferred device reads), so the step-visible cost is already
        proportional to what dirtied; hashing and the pre-write then run on
        the pool as usual.  At lead k the previous lead's entries are the
        fp reference, so iterative pre-dumps each touch only the bytes that
        changed since the one before (CRIU pre-copy)."""
        t0 = time.time()
        # drain (don't consume) any running pre-dump so its entries are
        # readable as this round's reference
        self.wait_predump()
        prev = self._predump
        prev_ok = (prev is not None
                   and prev.get("chunk_bytes") == self.chunk_bytes)
        prev_leaves = (prev.get("leaves") or {}) if prev_ok else {}
        prev_written = (prev.get("written") or set()) if prev_ok else set()
        from repro_torch.utils.tree import flatten_with_names

        named = flatten_with_names(tree)
        mine = [(i, name, leaf) for i, (name, leaf) in enumerate(named)
                if i % self.num_workers == self.worker_id]
        parent = self._parent_manifest()
        parent_hashes = manifest_chunk_hashes(parent) if parent else set()
        parent_leaves = {e["path"]: e for e in (parent or {}).get(
            "leaves", ()) if "chunks" in e}

        def refs_for(name):
            if name in prev_leaves:
                return prev_leaves[name]["entries"]
            pl = parent_leaves.get(name)
            return pl["chunks"] if pl else None

        def trust(h):
            # no existence probe at pre-dump time — the consuming save
            # re-verifies every pre-written hash before trusting it, so a
            # reap between now and then is repaired there
            return h in parent_hashes or h in prev_written

        plans, dstats = self._device_scan(mine, refs_for, trust)
        snap_s = time.time() - t0

        def do_predump():
            # marker-first + carry semantics identical to the host pre-dump
            # above; see the comments there
            marker_rel = self._inflight_rel("predump", step)
            self.store.put(self.tier, marker_rel,
                           json.dumps({"kind": "predump", "step": step,
                                       "worker": self.worker_id,
                                       "t": time.time()}).encode(),
                           replicas=1)
            prev2 = self._predump
            written: set = set((prev2 or {}).get("written") or ())
            cbytes: dict = dict((prev2 or {}).get("cbytes") or {})
            markers = list((prev2 or {}).get("markers") or ())
            markers.append(marker_rel)
            t1 = time.perf_counter()
            hashed, hashed_n = self._plans_to_leaves(plans)
            hash_s = time.perf_counter() - t1
            t1 = time.perf_counter()
            leaves = {}
            prewritten_n = 0
            for _idx, name, _dtype, _shape, _nbytes, _slots in plans:
                entries, views, leaf_crc = hashed[name]
                leaves[name] = {"entries": entries, "crc32": leaf_crc}
                for e, v in zip(entries, views):
                    h = e["hash"]
                    # v is None for fp-clean slots: their bytes never left
                    # the device, and their chunk is already durable (parent
                    # manifest or a previous lead's pre-write)
                    if h in parent_hashes or h in written or v is None:
                        continue
                    blob = (SER.frame_chunk(v, self.compress)
                            if self.compress else v)
                    self.store.put_chunk(self.tier, self.prefix, h, blob,
                                         replicas=self.replicas, force=True)
                    written.add(h)
                    cbytes[h] = len(blob)
                    prewritten_n += 1
            self._predump = {
                "step": step, "chunk_bytes": self.chunk_bytes,
                "leaves": leaves, "written": written, "markers": markers,
                "cbytes": cbytes,
                "hash_s": hash_s, "write_s": time.perf_counter() - t1,
                "chunks_hashed": hashed_n,
                "chunks_prewritten": prewritten_n,
                "d2h_bytes": dstats["d2h_bytes"],
                "d2h_s": dstats["d2h_s"],
                "fp_device_s": dstats["fp_device_s"],
                "chunks_clean_device": dstats["chunks_clean_device"],
            }

        self._predump_pending = True
        pool = self._writer
        if pool is None:
            if self._predumper is None:
                self._predumper = WorkPool(max_inflight=2, workers=1,
                                           name="ckpt-predump")
            pool = self._predumper
        pool.submit(do_predump)
        return {"step": step, "snapshot_s": snap_s,
                "fp_device_s": dstats["fp_device_s"],
                "d2h_bytes": dstats["d2h_bytes"],
                "d2h_s": dstats["d2h_s"]}

    def _save_delta(self, step: int, records, snap_s: float,
                    extra_meta: Optional[dict]) -> dict:
        """Chunk-plane save: every leaf is chunked/hashed/CRC'd concurrently
        (all chunks in flight across the hash engine's pool), then only
        chunks absent from the parent manifest are written to the dedup
        store (``chunks/<hh>/<hash>``) — save cost is proportional to the
        CHANGE RATE, not the model size.  A payload-free v3 index file
        records the leaf -> chunk mapping next to the wpart.

        Two pre-filters can shrink the hash pass itself:

        * a consumed pre-dump (``precommit``): chunks whose live fingerprint
          matches the pre-dump's reuse its hash/CRC AND its already-written
          chunk file — the stall pays only for bytes dirtied after the
          pre-dump;
        * ``fingerprint=True``: same comparison against the fingerprints
          stamped into the PARENT manifest, with no pre-dump needed.

        Per-phase wall times land in ``part["delta"]`` (``fp_s``/``hash_s``/
        ``diff_s``/``write_s`` and the step-visible ``stall_s``) so the
        bench measures, not infers."""
        t_entry = time.perf_counter()
        mine = self._my_leaves(records)
        sdir = _step_dir(self.prefix, step)
        index_rel = f"{sdir}/shard_w{self.worker_id:05d}.chunks"
        parent = self._parent_manifest()
        parent_hashes = manifest_chunk_hashes(parent) if parent else set()
        # carried compressed sizes: a reused chunk's on-disk frame size is
        # whatever the step that WROTE it recorded — levels can change
        # between steps without rewriting anything
        parent_cbytes = {c["hash"]: c["cbytes"]
                         for e in (parent or {}).get("leaves", ())
                         for c in (e.get("chunks") or ())
                         if "cbytes" in c}
        pre = self._consume_predump()
        pre_leaves = (pre or {}).get("leaves") or {}
        pre_written = (pre or {}).get("written") or set()
        pre_cbytes = (pre or {}).get("cbytes") or {}
        pre_markers = (pre or {}).get("markers") or []
        parent_leaves = {}
        if self.fingerprint and parent is not None:
            parent_leaves = {e["path"]: e for e in parent["leaves"]
                             if "chunks" in e}

        # fingerprint pre-filter: per-chunk fp of the LIVE bytes, compared
        # positionally against the pre-dump state first, else the parent
        # manifest.  fp-equal chunks skip blake2b (the engine still checks
        # per-chunk nbytes, so a reshaped leaf can never alias).  The 32-bit
        # fp never NAMES a chunk — blake2b does — it only decides which
        # chunks need renaming.
        t0 = time.perf_counter()
        items = []
        known: dict = {}
        fps_by_name: dict = {}
        for idx, name, arr in mine:
            arr = np.asarray(arr)
            items.append((name, arr))
            ref_entries = None
            if name in pre_leaves:
                ref_entries = pre_leaves[name]["entries"]
            elif name in parent_leaves:
                ref_entries = parent_leaves[name]["chunks"]
            if ref_entries is None and not self.fingerprint:
                continue          # nothing to compare and nothing to stamp
            fp = SER.fingerprint_chunks(SER.as_byte_view(arr),
                                        self.chunk_bytes)
            fps_by_name[name] = fp
            if not ref_entries:
                continue
            kmap = {i: e for i, e in enumerate(ref_entries)
                    if i < len(fp) and e.get("fp") is not None
                    and int(fp[i]) == int(e["fp"])}
            if kmap:
                known[name] = kmap
        fp_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        hashed, hstats = self.hash_engine.chunk_records(
            items, self.chunk_bytes, known=known,
            fps=fps_by_name if (self.fingerprint or fps_by_name) else None)
        hash_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        entries: list[dict] = []
        new_views: dict[str, object] = {}     # hash -> zero-copy byte view
        chunks_total = bytes_total = 0
        for idx, name, arr in mine:
            arr = np.asarray(arr)
            chunks, views, leaf_crc = hashed[name]
            nbytes = sum(c["nbytes"] for c in chunks)
            fresh = 0
            for c, v in zip(chunks, views):
                chunks_total += 1
                bytes_total += c["nbytes"]
                if c["hash"] in parent_cbytes:
                    c["cbytes"] = parent_cbytes[c["hash"]]
                if c["hash"] in parent_hashes:
                    continue
                fresh += 1
                # dedup at diff time: unchanged-since-parent chunks (the
                # parent manifest is always in the GC keep set, so its
                # chunks cannot be reaped under us) and duplicates within
                # this save are never queued for writing
                if c["hash"] not in new_views:
                    new_views[c["hash"]] = v
            entries.append({
                "path": name, "index": idx, "crc32": leaf_crc,
                "dtype": SER.dtype_name(arr.dtype), "shape": list(arr.shape),
                "nbytes": nbytes, "chunks": chunks,
                "reused": not fresh,
            })
        diff_s = time.perf_counter() - t0
        part = {
            "worker_id": self.worker_id,
            "num_workers": self.num_workers,
            "step": step,
            "leaves": entries,
            "snapshot_s": snap_s,
            "meta": extra_meta or {},
            "delta": {
                "chunk_bytes": self.chunk_bytes,
                "chunks_total": chunks_total,
                "bytes_total": bytes_total,
                "chunks_new": len(new_views),
                "bytes_new": sum(v.nbytes for v in new_views.values()),
                "parent_step": parent["step"] if parent else None,
                "chunks_hashed": hstats["chunks_hashed"],
                "chunks_fp_clean": hstats["chunks_known"],
                "hash_workers": hstats["hash_workers"],
                "predump_step": pre["step"] if pre else None,
                "fp_s": fp_s, "hash_s": hash_s, "diff_s": diff_s,
                # D2H accounting, host-path baseline: save() snapshotted the
                # ENTIRE tree before this method ran, so the device->host
                # cost is the full payload regardless of churn — exactly
                # the contrast the delta_save_device bench row draws
                "d2h_bytes": sum(
                    np.asarray(a).nbytes for _, a in records),
                "d2h_s": snap_s,
                "fp_device_s": 0.0,
                "chunks_clean_device": 0,
            },
        }
        return self._finish_delta(step, part, entries, new_views,
                                  pre=pre, parent=parent,
                                  snap_s=snap_s, t_entry=t_entry)

    def _finish_delta(self, step: int, part: dict, entries: list,
                      new_views: dict, *, pre: Optional[dict],
                      parent: Optional[dict], snap_s: float,
                      t_entry: float) -> dict:
        """Shared write tail of the host (``_save_delta``) and device
        (``_save_delta_device``) delta paths: intent marker, chunk writes,
        single-worker orphan sweep, v3 index, wpart, marker teardown, and
        the stall stamp.  ``new_views`` maps hash -> byte view; the device
        path may map a hash to ``None`` when the bytes were never fetched
        (clean since the pre-dump, pre-written, existence-verified during
        the save's sync phase) — if such a chunk vanishes before the write
        loop re-checks it, the save fails LOUDLY (no manifest is cut; the
        two-phase commit keeps the previous step restorable) rather than
        committing a dangling reference."""
        sdir = _step_dir(self.prefix, step)
        index_rel = f"{sdir}/shard_w{self.worker_id:05d}.chunks"
        parent_hashes = manifest_chunk_hashes(parent) if parent else set()
        pre_written = (pre or {}).get("written") or set()
        pre_cbytes = (pre or {}).get("cbytes") or {}
        pre_markers = (pre or {}).get("markers") or []

        def do_write():
            # store writes only; the diff above already decided what moves.
            # force=True: a chunk outside the parent manifest is written even
            # if a file with its hash exists — bare existence could be a
            # doomed old step's copy that a concurrent gc is about to reap
            # (the rewrite is idempotent; unchanged-since-parent chunks never
            # reach this loop, so the dedup win is untouched).  Chunks the
            # pre-dump already wrote are skipped after an existence
            # re-check — a pre-dump chunk reaped since is rewritten (same
            # residual TOCTOU family the force=True note documents).
            # intent marker before the first chunk write: fresh markers make
            # the coordinator's sweep_orphan_chunks back off, so chunks of
            # this not-yet-committed step are never mistaken for orphans
            save_marker = self._inflight_rel("save", step)
            self.store.put(self.tier, save_marker,
                           json.dumps({"kind": "save", "step": step,
                                       "worker": self.worker_id,
                                       "t": time.time()}).encode(),
                           replicas=1)
            t1 = time.perf_counter()
            written_b = written_c = predumped = cbytes_b = 0
            cbytes_out: dict[str, int] = {}
            for h, v in new_views.items():
                if h in pre_written and self.store.exists(
                        self.tier, chunk_rel(self.prefix, h)):
                    predumped += 1
                    if h in pre_cbytes:
                        cbytes_out[h] = pre_cbytes[h]
                    continue
                if v is None:
                    # device path, clean-since-pre-dump chunk: the bytes were
                    # never gathered off the device because the pre-written
                    # file existed during the sync phase.  Gone now means a
                    # reap won the race (same TOCTOU family the force=True
                    # note documents) — with no bytes in hand the only safe
                    # move is to abort this save before any manifest names
                    # the hash; the previous committed step stays restorable
                    raise RuntimeError(
                        f"pre-written chunk {h} disappeared before the "
                        f"step-{step} write; aborting save (no manifest cut)")
                # the frame wraps the STORED bytes only: h stays the blake2b
                # of the raw view, so dedup/fingerprints are codec-blind
                blob = (SER.frame_chunk(v, self.compress)
                        if self.compress else v)
                if self.store.put_chunk(self.tier, self.prefix, h, blob,
                                        replicas=self.replicas, force=True):
                    written_c += 1
                    written_b += v.nbytes
                    cbytes_out[h] = len(blob)
                    cbytes_b += len(blob)
            if self.compress and cbytes_out:
                for e in entries:
                    for c in e["chunks"]:
                        if c["hash"] in cbytes_out:
                            c["cbytes"] = cbytes_out[c["hash"]]
            part["delta"]["chunks_written"] = written_c
            part["delta"]["bytes_written"] = written_b
            part["delta"]["cbytes_written"] = cbytes_b
            part["delta"]["chunks_predumped"] = predumped
            if pre_written and self.num_workers == 1:
                # pre-dumped chunks the live state no longer contains are
                # referenced by NO manifest ever — gc() walks manifests, so
                # they would leak forever.  Single-worker only: with
                # concurrent workers a same-content chunk could legitimately
                # belong to another worker's in-flight save; those orphans
                # are reclaimed by the coordinator-side sweep_orphan_chunks
                # pass instead (gc() runs it, barriered on the in-flight
                # intent markers).  The spare set mirrors gc()'s contract — a
                # chunk stays while ANY kept manifest references it: content
                # can recur from an older retained step whose hash the
                # parent manifest does not carry, and a pre-write of that
                # hash lands on the very file the old step still resolves
                # through.
                final = {c["hash"] for e in entries for c in e["chunks"]}
                cands = pre_written - final - parent_hashes
                keep_hashes: Optional[set] = set()
                parent_step = parent["step"] if parent else None
                if cands:          # fully-consumed pre-dump: no reads at all
                    try:
                        all_steps = self.steps()
                        kept = (all_steps[-self.keep_last:] if self.keep_last
                                else all_steps)
                        for s in kept:
                            if s != parent_step:
                                keep_hashes |= manifest_chunk_hashes(
                                    self.read_manifest(s))
                    except (FileNotFoundError, ValueError, KeyError, OSError):
                        # can't prove a chunk unreferenced: leak it (bounded,
                        # reclaimed by a later sweep) rather than tear a
                        # restorable step
                        keep_hashes = None
                if keep_hashes is not None:
                    for h in sorted(cands - keep_hashes):
                        self.store.delete_file(self.tier,
                                               chunk_rel(self.prefix, h))
            # the v3 index file is the format's on-disk artifact for tooling
            # and disaster recovery (a manifest can be rebuilt from index
            # files alone); the restore path reads the manifest, so one
            # replica of this few-KB file is plenty
            self.store.put(
                self.tier, index_rel,
                SER.write_chunk_index_bytes(entries, meta={"step": step},
                                            chunk_bytes=self.chunk_bytes),
                replicas=1)
            # write_s is final BEFORE the wpart is serialized, so the phase
            # timing actually reaches disk (the wpart put it excludes is a
            # few KB of JSON)
            part["delta"]["write_s"] = time.perf_counter() - t1
            self.store.put(
                self.tier, f"{sdir}/wpart_{self.worker_id:05d}.json",
                json.dumps(part).encode(), replicas=self.replicas)
            # markers come down only AFTER the wpart is durable: from here on
            # the sweep sees this save's chunks through the wpart's refs, so
            # the handoff leaves no window where they are unprotected.  The
            # consumed pre-dump's markers come down with it — surviving
            # pre-written orphans are now sweepable by design (single-worker
            # managers swept them above; multi-worker ones leave them to the
            # coordinator's gc pass).
            for rel in pre_markers:
                self.store.delete_file(self.tier, rel)
            self.store.delete_file(self.tier, save_marker)

        # the step-visible pause attributable to this save call: snapshot +
        # everything that ran synchronously here (in async mode the writes
        # are off-thread, so stall covers fp/hash/diff only).  In async mode
        # stall_s must be set BEFORE the handoff — the writer thread
        # serializes ``part`` into the wpart, and a training-thread dict
        # insert during that json.dumps can tear the write; post-submit cost
        # on this thread is a queue append, so nothing visible is lost.
        if self._writer is not None:
            part["delta"]["stall_s"] = snap_s + (time.perf_counter() - t_entry)
            self._writer.submit(do_write)
        else:
            do_write()
            part["delta"]["stall_s"] = snap_s + (time.perf_counter() - t_entry)
        return part

    # -- device-resident dirty detection (delta + device_fp) ------------
    def _device_scan(self, mine, refs_for, trust):
        """Fingerprint every owned leaf ON DEVICE and gather only fp-dirty
        chunk ranges host-side.

        ``mine``: [(index, name, leaf)] with leaves still device-resident
        (numpy trees ride the same path through ``leaf_words``'s host fast
        path).  ``refs_for(name)`` returns the reference entry list (the
        previous pre-dump's first, else the parent manifest's) or None.
        ``trust(hash)`` says whether an fp-clean chunk may be reused
        WITHOUT bytes in hand — callers answer with the parent-manifest
        keep-set plus whatever existence guarantee fits their phase; a
        distrusted clean chunk is simply reclassified dirty and refetched.

        Every device read happens HERE, synchronously on the calling
        (training) thread: the optimizer updates the state in place, so
        nothing may defer a read past the next step.  Dirty slots are
        coalesced into runs and each run is one ranged host copy: of the
        run's byte span for a torch leaf (always a copy, also on the CPU),
        of the covering ELEMENT span for a numpy leaf (chunk boundaries
        need not align with the leaf's itemsize — the byte view into the
        fetched span is re-offset).

        Returns ``(plans, stats)``: per-leaf
        ``(index, name, dtype, shape, nbytes, slots)`` with slots
        ``(nbytes, fp, ref_entry_or_None, view_or_None)`` — exactly one of
        entry/view is set — and the D2H accounting stats.
        """
        from repro_torch.kernels import ops as KOPS

        t0 = time.perf_counter()
        fps = KOPS.tree_chunk_fingerprints(
            [(name, leaf) for _, name, leaf in mine], self.chunk_bytes,
            impl=self.device_fp_impl)
        fp_device_s = time.perf_counter() - t0

        cb = self.chunk_bytes
        d2h_bytes, d2h_s, clean = 0, 0.0, 0
        plans = []
        for idx, name, leaf in mine:
            shape = list(leaf.shape)
            itemsize = leaf.dtype.itemsize
            nelems = int(np.prod(shape, dtype=np.int64)) if shape else 1
            nbytes = nelems * itemsize
            nchunks = -(-nbytes // cb) if nbytes else 0
            fp = fps.get(name)
            refs = refs_for(name)
            slots: list = [None] * nchunks
            dirty = []
            for i in range(nchunks):
                sn = min(cb, nbytes - i * cb)
                fpi = int(fp[i])
                e = refs[i] if refs and i < len(refs) else None
                if (e is not None and e.get("fp") is not None
                        and int(e["fp"]) == fpi and e.get("nbytes") == sn
                        and trust(e["hash"])):
                    slots[i] = (sn, fpi, e, None)
                    clean += 1
                else:
                    slots[i] = (sn, fpi, None, None)
                    dirty.append(i)
            if dirty:
                # a torch leaf (on the card, or on the CPU where training
                # updates it in place) is copied to the host as its byte
                # span; a numpy leaf is sliced by elements, as the reference
                is_torch = isinstance(leaf, torch.Tensor)
                flat = KOPS.byte_view(leaf) if is_torch else leaf.reshape(-1)
                runs, a, b = [], dirty[0], dirty[0]
                for s in dirty[1:]:
                    if s == b + 1:
                        b = s
                    else:
                        runs.append((a, b))
                        a = b = s
                runs.append((a, b))
                for a, b in runs:
                    b0 = a * cb
                    b1 = min((b + 1) * cb, nbytes)
                    e0, e1 = ((b0, b1) if is_torch
                              else (b0 // itemsize, -(-b1 // itemsize)))
                    t1 = time.perf_counter()
                    if is_torch:
                        seg = flat[e0:e1].to("cpu", copy=True).numpy()
                    else:
                        seg = np.ascontiguousarray(np.asarray(flat[e0:e1]))
                    d2h_s += time.perf_counter() - t1
                    d2h_bytes += seg.nbytes
                    segb = memoryview(seg.view(np.uint8).reshape(-1))
                    off = b0 - e0 * (1 if is_torch else itemsize)
                    for s in range(a, b + 1):
                        sn, fpi, _, _ = slots[s]
                        sb = off + (s - a) * cb
                        slots[s] = (sn, fpi, None, segb[sb:sb + sn])
            plans.append((idx, name, SER.dtype_name(leaf.dtype), shape, nbytes, slots))
        stats = {"fp_device_s": fp_device_s, "d2h_s": d2h_s,
                 "d2h_bytes": d2h_bytes, "chunks_clean_device": clean}
        return plans, stats

    def _plans_to_leaves(self, plans):
        """Scan plans -> ``{name: (entries, views, leaf_crc)}``: dirty slots
        are digested on the hash engine pool (all leaves in flight at
        once), clean slots copy the reference entry into a FRESH dict (a
        cached parent manifest is never mutated).  Every entry carries
        ``fp`` — the device path persists the fingerprint vector
        unconditionally so the next restartable comparison never needs the
        bytes.  Returns ``(leaves, chunks_hashed)``."""
        todo: list = []                      # (entries, slot index, view)
        shaped: dict = {}
        for _idx, name, _dtype, _shape, _nbytes, slots in plans:
            entries: list = [None] * len(slots)
            views: list = [None] * len(slots)
            for i, (sn, fpi, e, v) in enumerate(slots):
                if e is not None:
                    entries[i] = {"hash": e["hash"], "nbytes": sn,
                                  "crc32": e["crc32"], "fp": fpi}
                else:
                    entries[i] = {"nbytes": sn, "fp": fpi}
                    views[i] = v
                    todo.append((entries, i, v))
            shaped[name] = (entries, views)
        digests = self.hash_engine.digest_views([v for _, _, v in todo])
        for (entries, i, _v), (h, crc) in zip(todo, digests):
            e = entries[i]
            entries[i] = {"hash": h, "nbytes": e["nbytes"], "crc32": crc,
                          "fp": e["fp"]}
        leaves = {}
        for name, (entries, views) in shaped.items():
            leaf_crc = 0
            for e in entries:
                leaf_crc = SER.crc32_combine(leaf_crc, e["crc32"],
                                             e["nbytes"])
            leaves[name] = (entries, views, leaf_crc)
        return leaves, len(todo)

    def _save_delta_device(self, step: int, tree,
                           extra_meta: Optional[dict]) -> dict:
        """Delta save with dirty detection on the accelerator: the Pallas/
        jnp fingerprint pass runs over the LIVE device-resident leaves, and
        only fp-dirty chunk runs cross the device->host link — at low churn
        the D2H bill drops from the full model to ~the changed bytes
        (``d2h_bytes`` in ``part["delta"]`` measures it).  Clean chunks
        reuse the pre-dump/parent entries verbatim; pre-written-but-
        uncommitted hashes are existence-verified synchronously here and
        refetched from the device if a reap won the race."""
        t_entry = time.perf_counter()
        from repro_torch.utils.tree import flatten_with_names

        named = flatten_with_names(tree)
        mine = [(i, name, leaf) for i, (name, leaf) in enumerate(named)
                if i % self.num_workers == self.worker_id]
        parent = self._parent_manifest()
        parent_hashes = manifest_chunk_hashes(parent) if parent else set()
        parent_cbytes = {c["hash"]: c["cbytes"]
                         for e in (parent or {}).get("leaves", ())
                         for c in (e.get("chunks") or ())
                         if "cbytes" in c}
        pre = self._consume_predump()
        pre_leaves = (pre or {}).get("leaves") or {}
        pre_written = (pre or {}).get("written") or set()
        parent_leaves = {e["path"]: e for e in (parent or {}).get(
            "leaves", ()) if "chunks" in e}

        def refs_for(name):
            if name in pre_leaves:
                return pre_leaves[name]["entries"]
            pl = parent_leaves.get(name)
            return pl["chunks"] if pl else None

        def trust(h):
            if h in parent_hashes:
                return True     # GC keep set: cannot be reaped under us
            return h in pre_written and self.store.exists(
                self.tier, chunk_rel(self.prefix, h))

        plans, dstats = self._device_scan(mine, refs_for, trust)
        t0 = time.perf_counter()
        leaves, hashed_n = self._plans_to_leaves(plans)
        hash_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        entries: list[dict] = []
        new_views: dict[str, object] = {}
        new_sizes: dict[str, int] = {}
        chunks_total = bytes_total = 0
        for idx, name, dtype, shape, nbytes, _slots in plans:
            chunks, views, leaf_crc = leaves[name]
            fresh = 0
            for c, v in zip(chunks, views):
                chunks_total += 1
                bytes_total += c["nbytes"]
                if c["hash"] in parent_cbytes:
                    c["cbytes"] = parent_cbytes[c["hash"]]
                if c["hash"] in parent_hashes:
                    continue
                fresh += 1
                # keep a real view if ANY duplicate slot fetched one — the
                # write loop can then repair a reaped pre-write instead of
                # aborting on the None placeholder
                if (c["hash"] not in new_views
                        or (new_views[c["hash"]] is None and v is not None)):
                    new_views[c["hash"]] = v
                    new_sizes[c["hash"]] = c["nbytes"]
            entries.append({
                "path": name, "index": idx, "crc32": leaf_crc,
                "dtype": dtype, "shape": shape,
                "nbytes": nbytes, "chunks": chunks,
                "reused": not fresh,
            })
        diff_s = time.perf_counter() - t0
        part = {
            "worker_id": self.worker_id,
            "num_workers": self.num_workers,
            "step": step,
            "leaves": entries,
            "snapshot_s": 0.0,              # no full snapshot on this path
            "meta": extra_meta or {},
            "delta": {
                "chunk_bytes": self.chunk_bytes,
                "chunks_total": chunks_total,
                "bytes_total": bytes_total,
                "chunks_new": len(new_views),
                "bytes_new": sum(new_sizes.values()),
                "parent_step": parent["step"] if parent else None,
                "chunks_hashed": hashed_n,
                "chunks_fp_clean": dstats["chunks_clean_device"],
                "hash_workers": self.hash_engine.workers,
                "predump_step": pre["step"] if pre else None,
                "fp_s": dstats["fp_device_s"],
                "hash_s": hash_s, "diff_s": diff_s,
                "d2h_bytes": dstats["d2h_bytes"],
                "d2h_s": dstats["d2h_s"],
                "fp_device_s": dstats["fp_device_s"],
                "chunks_clean_device": dstats["chunks_clean_device"],
            },
        }
        return self._finish_delta(step, part, entries, new_views,
                                  pre=pre, parent=parent,
                                  snap_s=0.0, t_entry=t_entry)

    def wait_writes(self, timeout: Optional[float] = None) -> None:
        if self._writer is not None:
            self._writer.wait(timeout)

    def wait_predump(self, timeout: Optional[float] = None) -> Optional[dict]:
        """Drain a pending background pre-dump without consuming it (tests/
        shutdown; ``save()`` itself waits via ``_consume_predump``).

        Returns the drained pre-dump's accounting stats (``step``,
        ``hash_s``/``write_s``, ``chunks_hashed``/``chunks_prewritten`` and
        the D2H plane: ``d2h_bytes``/``d2h_s``/``fp_device_s``/
        ``chunks_clean_device``) or None if no pre-dump is buffered — the
        iterative-pre-copy bench reads these to show each lead hashing only
        what dirtied since the lead before."""
        pool = self._writer if self._writer is not None else self._predumper
        if self._predump_pending and pool is not None:
            pool.wait(timeout)
        pre = self._predump
        if pre is None:
            return None
        return {k: pre[k] for k in (
            "step", "hash_s", "write_s", "chunks_hashed",
            "chunks_prewritten", "d2h_bytes", "d2h_s", "fp_device_s",
            "chunks_clean_device") if k in pre}

    # ------------------------------------------------------------------
    def commit(self, step: int, *, num_workers: Optional[int] = None,
               extra_meta: Optional[dict] = None) -> dict:
        """Coordinator-side: verify all worker parts exist, write MANIFEST last."""
        self.wait_writes()
        nw = num_workers or self.num_workers
        sdir = _step_dir(self.prefix, step)
        leaves = []
        meta: dict = {}
        for w in range(nw):
            raw = self.store.get(self.tier, f"{sdir}/wpart_{w:05d}.json")
            part = json.loads(raw.decode())
            leaves.extend(part["leaves"])
            meta.update(part.get("meta") or {})   # worker metas merge (w0 first)
        leaves.sort(key=lambda e: e["index"])
        meta.update(extra_meta or {})
        manifest = {
            "step": step,
            "num_workers": nw,
            "leaves": leaves,
            "committed_at": time.time(),
            "meta": meta,
        }
        if any("chunks" in e for e in leaves):
            # manifest v2: record the baseline+delta chain.  The manifest is
            # SELF-CONTAINED (it lists every chunk each leaf needs, not just
            # the new ones), so the chain is provenance/observability — GC
            # and restore never have to walk ancestors.  rebase_every bounds
            # the reported chain; content addressing makes the rebaseline
            # free (unchanged chunks are never re-written).
            manifest["manifest_version"] = 2
            parent = self._parent_manifest()
            chain, baseline, parent_step = [step], step, None
            if parent is not None and is_chunked_manifest(parent):
                pdelta = parent.get("delta") or {}
                pchain = pdelta.get("chain") or [parent["step"]]
                if len(pchain) < self.rebase_every:
                    parent_step = parent["step"]
                    chain = pchain + [step]
                    baseline = pdelta.get("baseline", parent["step"])
            manifest["delta"] = {
                "baseline": baseline, "parent": parent_step, "chain": chain,
                "chunk_bytes": self.chunk_bytes,
            }
        self.store.put(self.tier, f"{sdir}/MANIFEST.json",
                       json.dumps(manifest).encode(), replicas=self.replicas)
        self._prev_manifest = manifest
        self.gc()
        if self.promote == "eager":
            # keep the node-local cache tracking the newest commit so a
            # restart on this node never touches the shared tier
            self._schedule_promotion(manifest)
        return manifest

    # ------------------------------------------------------------------
    def steps(self) -> list[int]:
        return committed_steps(self.store, self.tier, self.prefix)

    def cache_inventory(self) -> dict:
        """Validate this manager's promoted cache against its primary tier —
        see ``validate_promoted_cache``.  Usable whatever the promote policy
        (``off`` just probes whatever a previous run left behind)."""
        return validate_promoted_cache(
            self.store, tier=self.tier, promote_tier=self.promote_tier,
            prefix=self.prefix)

    def read_manifest(self, step: int) -> dict:
        raw = self.store.get(self.tier, f"{_step_dir(self.prefix, step)}/MANIFEST.json")
        return json.loads(raw.decode())

    @staticmethod
    def _by_file(manifest: dict) -> dict[str, list[dict]]:
        by_file: dict[str, list[dict]] = {}
        for e in manifest["leaves"]:
            if e.get("file"):           # chunked leaves resolve via the
                by_file.setdefault(e["file"], []).append(e)   # chunk plane
        return by_file

    def _engine(self) -> ParallelRestorer:
        """One restore engine per restore call, carrying this policy's
        worker count and batched-submission width."""
        return ParallelRestorer(self.store, workers=self.restore_workers,
                                io_batch=self.io_batch)

    def _restore_chunked(self, sources: list[str], manifest: dict,
                         tee=None):
        """Chunk-plane restore against an ordered source list (stale local
        cache first, then peers, then the primary tier): every chunk resolves
        independently down the list, so a warm-but-stale node reads its
        unchanged chunks locally and fetches only the missing delta.
        ``tee`` (see ``ParallelRestorer.restore_chunked``) observes each
        verified chunk — the follower-cache write-behind hangs off it."""
        leaves = manifest["leaves"]
        chunked = [e for e in leaves if "chunks" in e]
        engine = self._engine()
        named, st = engine.restore_chunked(sources, chunked,
                                           prefix=self.prefix, tee=tee)
        stats = {"mode": "chunked", "tier": sources[-1], "delta": True,
                 **st.as_dict()}
        by_file = self._by_file(manifest)
        if by_file:     # mixed manifest (mode switched mid-run): file leaves
            named2, st2 = (engine.restore_multi(sources, by_file)
                           if len(sources) > 1
                           else engine.restore(sources[0], by_file))
            named.update(named2)
            stats["bytes_read"] += st2.bytes_read
            stats["tasks"] += st2.tasks
            stats["files"] += st2.files
            stats["replica_fallbacks"] += st2.replica_fallbacks
            for t, n in st2.bytes_by_tier.items():
                stats["bytes_by_tier"][t] = (
                    stats["bytes_by_tier"].get(t, 0) + n)
        return named, stats

    def _restore_files(self, tier: str, manifest: dict):
        """Fetch every manifest-referenced leaf from ``tier``.  Returns
        ({leaf_path: array}, stats).  ``restore_workers=1`` keeps the serial
        per-shard loop (the pre-engine path, and the benchmark baseline);
        anything else fans out through the ParallelRestorer.  Chunked (v3)
        manifests route through the chunk plane whatever the worker count."""
        if is_chunked_manifest(manifest):
            return self._restore_chunked([tier], manifest)
        by_file = self._by_file(manifest)
        if self.restore_workers == 1:
            named: dict[str, np.ndarray] = {}
            for rel, ents in by_file.items():
                tensors, _ = self.store.read_shard_leaves(
                    tier, rel, [e["path"] for e in ents],
                    expect_crcs={e["path"]: e["crc32"] for e in ents})
                for e in ents:
                    named[e["path"]] = tensors[e["path"]]
            return named, {"mode": "serial", "tier": tier,
                           "files": len(by_file), "workers": 1}
        engine = self._engine()
        named, st = engine.restore(tier, by_file)
        return named, {"mode": "parallel", "tier": tier, **st.as_dict()}

    def restore(self, template, step: Optional[int] = None, *,
                sources="auto", promote: Optional[bool] = None,
                follower_cache: bool = False):
        """Unified restore entry.  Returns (host_tree, manifest).

        Dispatches on the MANIFEST (v1/v2 shard files vs v3 chunk plane),
        not on which method the caller picked — the old ``restore_chunked``
        and ``restore_from_peers`` names survive only as deprecated aliases
        of this.  ``last_restore_stats`` is always populated with one schema
        (see ``_finalize_stats``) whatever path served the bytes.

        ``sources`` — ``"auto"`` (default) plans the full cascade: promoted
        cache hit -> peer fabric -> own-stale-cache + primary tier.  An
        explicit tier name or ordered list of tier names (e.g.
        ``["local", "shared"]``) restores from exactly those, skipping
        discovery — the serving-fleet follower uses this to pin its fetch
        plan.

        ``promote`` — ``None`` follows the manager's promote policy;
        ``False`` forces a READ-ONLY restore: no promotion is scheduled and
        a damaged promoted cache is missed, never invalidated (no marker
        deletion).  Serving-fleet followers restore read-only mid-swap so a
        concurrent decode replica never sees its cache torn down under it.

        Leaf-granular: for each shard file the manifest references, only the
        byte ranges of the referenced leaves are fetched, coalesced into
        contiguous runs and (by default) issued in parallel, largest-first,
        across a read pool bounded by each tier's concurrency spec — see
        restore_engine.py.  Per-leaf CRCs are pinned to the manifest values
        and payload bytes are verified against them; replica fallback is
        per-range.  Reads both shard formats (v1 seed files and v2).

        With ``promote != "off"`` a restore served from the primary tier is
        teed write-behind into ``promote_tier`` so the NEXT restart on this
        node reads node-local bytes only (the paper's container-image-cache
        effect); a restore whose step is already promoted is served entirely
        from the promoted copy.

        Peer fabric: when this node is cold but warm peers are known (a
        scheduler hint in ``peer_roots`` and/or a ``CacheRegistry``), the
        restore is planned multi-source — local cache, warm peers round-robin,
        then shared — and the promotion tee copies from the peer too, so one
        cold restart warms this node without touching the shared tier at all.

        ``follower_cache=True`` (serving-fleet followers) parks every chunk
        this restore fetched remotely into ``promote_tier`` as content-
        addressed files — NO promotion marker is written, so the read-only
        contract of ``promote=False`` holds — and, when a registry + node
        name are configured, advertises the synced step as a follower-cache
        entry (``CacheRegistry.publish_follower``).  Replica N+1 of the
        fleet then pulls the delta from replica N instead of the shared
        tier.  Only chunked (v3) manifests advertise; tee failures (disk
        full on the local tier, ...) suppress the advertisement but never
        fail the restore.
        """
        all_steps = self.steps()
        if not all_steps:
            raise FileNotFoundError("no committed checkpoint found")
        step = all_steps[-1] if step is None else step
        mutate = promote is not False
        named = manifest = stats = None
        follower = tee = None
        if follower_cache:
            follower = {"teed": 0, "failures": 0}
            tee = self._follower_tee(follower)
        if isinstance(sources, str) and sources != "auto":
            sources = [sources]
        if sources == "auto":
            if self._promoter is not None or not mutate:
                got = self._restore_promoted(step, mutate=mutate)
                if got is not None:
                    named, manifest, stats = got
            if named is None and (self.peer_roots
                                  or self.registry is not None):
                got = self._restore_from_peers(step, mutate=mutate, tee=tee)
                if got is not None:
                    named, manifest, stats = got
            if named is None:
                manifest = self.read_manifest(step)
                if (is_chunked_manifest(manifest)
                        and self.promote_tier != self.tier):
                    # the node's own — possibly STALE — promoted cache joins
                    # the source list: content-addressed chunks stay valid
                    # whatever step the cache marker names, so a requeued
                    # warm-but-stale node reads unchanged chunks locally and
                    # pays the primary tier only for the delta
                    named, stats = self._restore_chunked(
                        [self.promote_tier, self.tier], manifest, tee=tee)
                else:
                    named, stats = self._restore_files(self.tier, manifest)
                if mutate:
                    self._schedule_promotion(manifest)
        else:
            # pinned source plan: the manifest still comes from the primary
            # tier (the commit marker lives there), payload bytes from
            # exactly the tiers the caller listed, in order
            sources = list(sources)
            if not sources:
                raise ValueError("sources must be 'auto' or a non-empty "
                                 "tier list")
            manifest = self.read_manifest(step)
            if is_chunked_manifest(manifest):
                named, stats = self._restore_chunked(sources, manifest,
                                                     tee=tee)
            elif len(sources) == 1:
                named, stats = self._restore_files(sources[0], manifest)
            else:
                engine = self._engine()
                named, st = engine.restore_multi(sources,
                                                 self._by_file(manifest))
                stats = {"mode": "parallel", "tier": sources[-1],
                         **st.as_dict()}
            if mutate:
                self._schedule_promotion(manifest)
        tree = SER.restore_tree(template, named)
        self._prev_manifest = manifest
        self.last_restore_stats = self._finalize_stats(stats, manifest)
        if follower is not None:
            self.last_restore_stats["chunks_teed"] = follower["teed"]
            self.last_restore_stats["follower_advertised"] = (
                self._advertise_follower(manifest, follower))
        return tree, manifest

    # every restore path lands stats in this shape; path-specific keys only
    # ever ADD information (``promoted``/``peer`` stay falsy off-path)
    _STAT_DEFAULTS = {
        "mode": None, "tier": None, "workers": 1, "files": 0, "tasks": 0,
        "bytes_read": 0, "bytes_by_tier": {}, "replica_fallbacks": 0,
        "chunks": 0, "chunk_refs": 0, "sources": None,
        "promoted": None, "peer": False, "peer_tiers": [], "delta": False,
        "chunks_teed": 0, "follower_advertised": False,
    }

    def _finalize_stats(self, stats: dict, manifest: dict) -> dict:
        """Normalize ``last_restore_stats`` to one schema whatever path
        served the restore (serial shard loop, parallel engine, chunk
        plane, promoted cache, peers): every key in ``_STAT_DEFAULTS`` is
        present, plus ``step``/``manifest_version``."""
        out = dict(self._STAT_DEFAULTS)
        out["bytes_by_tier"] = {}
        out["peer_tiers"] = []
        out.update(stats)
        if out["sources"] is None:
            out["sources"] = [out["tier"]]
        out["step"] = manifest.get("step")
        out["manifest_version"] = manifest.get("manifest_version", 1)
        return out

    def restore_chunked(self, template, step: Optional[int] = None):
        """Deprecated alias of the unified ``restore`` (which dispatches on
        manifest version, so a chunked checkpoint routes through the chunk
        plane without the caller picking a method)."""
        warnings.warn(
            "CheckpointManager.restore_chunked is deprecated; the unified "
            "restore dispatches on manifest version",
            DeprecationWarning, stacklevel=2)
        return self.restore(template, step)

    def restore_from_peers(self, template, step: Optional[int] = None):
        """Deprecated alias of the unified ``restore`` (whose auto source
        plan already prefers the peer fabric when peers are known)."""
        warnings.warn(
            "CheckpointManager.restore_from_peers is deprecated; the unified "
            "restore plans peer sources automatically",
            DeprecationWarning, stacklevel=2)
        return self.restore(template, step)

    # -- peer cache fabric ---------------------------------------------
    def _peer_sources(self, step: int) -> tuple[list[str], list[str]]:
        """Registered peer tiers whose promoted cache can serve ``step``,
        bucketed ``(exact, stale)`` in ONE marker sweep (each candidate's
        ``PROMOTED.json`` is a remote read over the latency-carrying peer
        tier — re-reading it per bucket would double the planning cost of
        exactly the warm-restart path this fabric optimizes).

        Candidates come from the scheduler hint (``peer_roots``) merged with
        the registry; each one's marker is re-read from the peer itself
        before it is trusted, so a stale inventory entry — a peer that GC'd
        or superseded its cache — is skipped, never served.  ``exact`` peers
        cache EXACTLY ``step`` (the only ones the full-shard fabric can
        use); ``stale`` peers hold a parseable cache of some other step —
        useless for shard files, but a chunk-plane restore resolves per
        content hash, so a stale peer still serves every chunk the target
        step shares with its cached one.

        FOLLOWER-cache entries (a serving replica that synced ``step`` and
        advertised its chunk inventory — see ``CacheRegistry
        .publish_follower``) fold into the ``stale`` bucket at their
        advertised lag, exact-step followers first: they own no marker to
        re-read (the node's ``PROMOTED.json`` belongs to whatever promoted
        the node last), so the entry's step is taken on trust — chunk-only
        and CRC-pinned, a lying follower costs a per-chunk fallback, never
        wrong bytes.  They never join ``exact``: no marker, no manifest, no
        shard files."""
        cands: dict[str, tuple[Path, str, Optional[int]]] = {}
        for name, root in sorted(self.peer_roots.items()):
            if self.node is not None and name == self.node:
                continue
            cands[name] = (Path(root), self.promote_tier, None)
        if self.registry is not None:
            entries = dict(self.registry.warm_peers(step,
                                                    exclude=(self.node,)))
            for name, e in self.registry.near_peers(
                    step, exclude=(self.node,),
                    max_lag=STALE_PEER_MAX_LAG).items():
                entries.setdefault(name, e)
            for name, e in entries.items():
                trusted_lag = (abs(int(e["step"]) - step)
                               if e.get("kind") == "follower" else None)
                cands.setdefault(
                    name, (Path(e["local_root"]), e.get("tier", "local"),
                           trusted_lag))
        exact: list[str] = []
        stale: list[tuple[int, str]] = []
        for name, (root, via, follower_lag) in cands.items():
            tier = self.store.add_peer(name, root, via_tier=via)
            if follower_lag is not None:
                stale.append((follower_lag, tier))
                continue
            try:
                marker = json.loads(
                    self.store.get(tier, self._marker_rel()).decode())
                if not isinstance(marker, dict):
                    continue
                cached = int(marker.get("step"))
            except (FileNotFoundError, ValueError, TypeError, OSError):
                continue
            if cached == step:
                exact.append(tier)
            elif abs(cached - step) <= STALE_PEER_MAX_LAG:
                # ordered by the MARKER's actual lag (the registry claim may
                # be outdated): the nearer the cached step, the larger the
                # expected chunk overlap, so the better the source
                stale.append((abs(cached - step), tier))
        return exact, [t for _, t in sorted(stale)]

    def _restore_from_peers(self, step: int, *, mutate: bool = True,
                            tee=None):
        """Multi-source restore of ``step`` from peers' promoted caches.
        Returns (named, manifest, stats) or None to fall through.
        ``mutate=False`` suppresses the promotion tee (read-only follower).

        Full-shard (v1/v2) manifests keep the original fabric: only exact-step
        warm peers can serve, the manifest itself comes from a peer's
        promoted copy, and every range task falls back peer -> peer ->
        shared.  Chunked (v3) manifests widen the source list with STALE
        peers and this node's own stale cache — content-addressed chunks
        are step-agnostic, so a requeued node fetches only the delta chunks
        it is missing, peers first.  Leaf/chunk CRCs from the manifest are
        enforced on every payload byte whatever the source, and the
        promotion tee is pointed at the peers first so the warm-up copy
        avoids the shared tier too."""
        peer_tiers, stale_tiers = self._peer_sources(step)
        man_rel = f"{_step_dir(self.prefix, step)}/MANIFEST.json"
        manifest = None
        for t in peer_tiers:
            try:
                man = json.loads(self.store.get(t, man_rel).decode())
                if man.get("step") != step:
                    raise ValueError("peer manifest step mismatch")
                manifest = man
                break
            except (FileNotFoundError, ValueError, OSError, KeyError):
                continue
        if manifest is None:
            # no exact-step peer could serve the manifest: only the chunk
            # plane can still profit (from stale peers), and the manifest
            # is a tiny primary-tier read next to the payload it unlocks
            if not stale_tiers:
                return None
            try:
                manifest = self.read_manifest(step)
            except (FileNotFoundError, ValueError, KeyError):
                return None
            if not is_chunked_manifest(manifest):
                return None
        if is_chunked_manifest(manifest):
            peers = peer_tiers + [t for t in stale_tiers
                                  if t not in peer_tiers]
            if not peers:
                return None           # plain stale-local + primary path
            sources = [self.promote_tier] + peers + [self.tier]
            try:
                named, stats = self._restore_chunked(sources, manifest,
                                                     tee=tee)
            except (SER.ChecksumError, OSError, ValueError, KeyError):
                return None
            stats.update({"tier": "peer", "peer": True, "peer_tiers": peers})
            if mutate:
                self._schedule_promotion(manifest,
                                         src_tiers=peers + [self.tier])
            return named, manifest, stats
        if not peer_tiers:
            return None
        sources = [self.promote_tier] + peer_tiers + [self.tier]
        engine = self._engine()
        try:
            named, st = engine.restore_multi(sources, self._by_file(manifest))
        except (SER.ChecksumError, OSError, ValueError, KeyError):
            return None          # peers useless end to end: plain shared path
        stats = {"mode": "parallel", "tier": "peer", "peer": True,
                 "peer_tiers": peer_tiers, **st.as_dict()}
        if mutate:
            self._schedule_promotion(manifest,
                                     src_tiers=peer_tiers + [self.tier])
        return named, manifest, stats

    # -- follower cache (serving-fleet replica-to-replica) -------------
    def _follower_tee(self, state: dict):
        """Write-behind for the serving fleet: park every chunk the restore
        fetched from a NON-local source in this node's promote tier as a
        plain content-addressed file (the on-disk FILE bytes — framed when
        the step was written compressed — so the parked copy is
        byte-identical to the source replica).  The promotion MARKER is never
        written — the follower does not own ``PROMOTED.json`` — so the
        ``promote=False`` read-only contract holds; what the tee builds is
        exactly the inventory ``publish_follower`` advertises.  Runs on the
        restore worker threads; per-chunk failures are counted (they
        suppress the advertisement), never raised — the cache is advisory
        and the restore result is already CRC-verified."""
        lock = threading.Lock()

        def tee(rel: str, data: bytes, src_tier: str) -> None:
            if src_tier == self.promote_tier:
                return          # already local: nothing to park
            try:
                if not self.store.exists(self.promote_tier, rel):
                    self.store.put(self.promote_tier, rel, bytes(data),
                                   replicas=1)
                with lock:
                    state["teed"] += 1
            except OSError:
                with lock:
                    state["failures"] += 1

        return tee

    def _advertise_follower(self, manifest: dict, state: dict) -> bool:
        """Publish this node's follower-cache entry for the step just
        restored (chunk plane only — the entry is chunk-only by contract).
        Advisory: any failure leaves the fleet on the shared tier, never
        fails the restore."""
        if (self.registry is None or not self.node
                or not is_chunked_manifest(manifest)
                or state["failures"]):
            return False
        local_root = self.store.tier_roots.get(self.promote_tier,
                                               self.store.root)
        delta = manifest.get("delta") or {}
        try:
            self.registry.publish_follower(
                self.node, step=int(manifest["step"]),
                local_root=local_root, tier=self.promote_tier,
                baseline_step=delta.get("baseline"),
                chunk_count=len(manifest_chunk_hashes(manifest)))
            return True
        except (OSError, ValueError, KeyError):
            return False

    # -- shared -> local tier promotion --------------------------------
    def _marker_rel(self) -> str:
        return f"{self.prefix}/PROMOTED.json"

    def _read_marker(self) -> Optional[dict]:
        try:
            return json.loads(
                self.store.get(self.promote_tier, self._marker_rel()).decode())
        except (FileNotFoundError, ValueError):
            return None

    def invalidate_promoted(self) -> None:
        """Drop the promoted-tier cache (marker first, so a concurrent reader
        never trusts files being deleted under it); the registry entry — the
        cluster-visible claim — comes off with it, so no peer keeps sourcing
        from a cache that is going away."""
        if self.registry is not None and self.node:
            try:
                self.registry.withdraw(self.node)
                self.registry.withdraw_follower(self.node)
            except OSError:
                pass    # advisory inventory: a failed withdraw must never
                        # kill the restore/gc path that is invalidating
        self.store.delete_file(self.promote_tier, self._marker_rel())
        self.store.delete_prefix(self.promote_tier, self.prefix)

    def _promo_register(self, step: int) -> None:
        with self._promo_lock:
            self._promo_inflight[step] = self._promo_inflight.get(step, 0) + 1

    def _promo_unregister(self, step: int) -> None:
        with self._promo_lock:
            n = self._promo_inflight.get(step, 0) - 1
            if n <= 0:
                self._promo_inflight.pop(step, None)
                self._promo_doomed.discard(step)
            else:
                self._promo_inflight[step] = n

    def _schedule_promotion(self, manifest: dict,
                            src_tiers: Optional[list[str]] = None) -> None:
        """Best-effort, never blocking: a busy promotion pool means this
        promotion is dropped (counted), not that the training thread waits
        on a cache copy.  Registered BEFORE submission so gc() can cancel a
        promotion that is still queued behind a busy copier — not only one
        already executing."""
        if self._promoter is None:
            return
        step = manifest["step"]
        self._promo_register(step)

        def task(man=manifest, srcs=src_tiers, s=step):
            try:
                self._promote_now(man, src_tiers=srcs)
            finally:
                self._promo_unregister(s)

        if not self._promoter.try_submit(task):
            self.promote_skipped += 1
            self._promo_unregister(step)

    def _restore_promoted(self, step: int, *, mutate: bool = True):
        """Serve a restore entirely from the promoted tier when its cached
        step matches.  A stale marker (a newer step committed since the
        promotion — manifest-driven invalidation) just misses: the cached
        FILES are deliberately left in place so the follow-up promotion can
        reuse still-referenced incremental base shards and only copy the
        delta; ``_promote_now`` retires whatever the new manifest no longer
        references.  ``mutate=False`` (read-only follower restore) treats a
        damaged cache as a plain miss — it must never delete the marker of
        a cache some OTHER consumer on this node may be serving from."""
        marker = self._read_marker()
        if marker is None or marker.get("step") != step:
            return None
        try:
            raw = self.store.get(
                self.promote_tier, f"{_step_dir(self.prefix, step)}/MANIFEST.json")
            manifest = json.loads(raw.decode())
            if manifest.get("step") != step:
                raise ValueError("promoted manifest step mismatch")
            named, stats = self._restore_files(self.promote_tier, manifest)
            stats["promoted"] = True
            return named, manifest, stats
        except (FileNotFoundError, ValueError, KeyError, OSError,
                SER.ChecksumError):
            # damaged/evicted cache: drop it and fall back to the source tier
            if mutate:
                self.invalidate_promoted()
            return None

    def _promote_cancelled(self, step: int) -> bool:
        with self._promo_lock:
            return step in self._promo_doomed

    def _promote_now(self, manifest: dict,
                     src_tiers: Optional[list[str]] = None) -> None:
        """Write-behind tee of one committed checkpoint into the promote
        tier.  Incremental-friendly: shard files the previous marker already
        promoted are kept in place (an unchanged multi-GB base shard is never
        re-copied per commit); only missing files are OS-copied and
        CRC-verified against the manifest, and files the new manifest no
        longer references are retired.  The marker comes off FIRST and is
        republished LAST (two-phase — a torn promotion is invisible and gets
        cleaned by the next one).  ``src_tiers`` orders where the copy reads
        from (peer tiers first after a peer-served restore; default the
        primary tier) with per-file fallback down the list.  A promotion
        whose step ``gc()`` starts deleting mid-copy is cancelled before any
        marker is published.  Failures are recorded, never raised: promotion
        is an opportunistic cache."""
        step = manifest["step"]
        # a doom flag set while this promotion was QUEUED must survive into
        # execution, so entry only adds a registration — never clears flags
        self._promo_register(step)
        try:
            self._promote_locked(manifest, step,
                                 src_tiers or [self.tier])
        finally:
            self._promo_unregister(step)

    def _promote_locked(self, manifest: dict, step: int,
                        src_tiers: list[str]) -> None:
        marker = self._read_marker()
        cached = marker.get("step") if marker is not None else None
        if cached == step:
            return
        if cached is not None and cached > step and cached in self.steps():
            return      # never clobber a warmer cache with an older step
        try:
            pmap = manifest_payload_map(manifest, self.prefix)
            have = set(marker.get("files") or []) if marker is not None else set()
            self.store.delete_file(self.promote_tier, self._marker_rel())
            if cached is not None:
                self.store.delete_file(
                    self.promote_tier,
                    f"{_step_dir(self.prefix, cached)}/MANIFEST.json")
            for rel in have - set(pmap):
                self.store.delete_file(self.promote_tier, rel)
            copied: list[str] = []       # this run's copies, for cancel undo
            for rel in sorted(pmap):
                if self._promote_cancelled(step):
                    self._abort_cancelled(step, copied)
                    return          # gc is deleting this step: no marker
                if rel in have and self.store.exists(self.promote_tier, rel):
                    continue        # already promoted + CRC-verified (for a
                    # delta step this skips every unchanged chunk the stale
                    # cache already holds — the tee copies only the delta)
                self._copy_promoted(rel, pmap[rel], src_tiers)
                copied.append(rel)
            if self._promote_cancelled(step):
                self._abort_cancelled(step, copied)
                return
            sdir = _step_dir(self.prefix, step)
            self.store.put(self.promote_tier, f"{sdir}/MANIFEST.json",
                           json.dumps(manifest).encode(), replicas=1)
            self.store.put(
                self.promote_tier, self._marker_rel(),
                json.dumps({"step": step, "files": sorted(pmap),
                            "promoted_at": time.time()}).encode(),
                replicas=1)
            if self.registry is not None and self.node:
                try:
                    delta = manifest.get("delta") or {}
                    chunk_count = sum(1 for k in pmap
                                      if pmap[k][0] == "chunk")
                    # the registry is a SUMMARY inventory: peers re-read the
                    # node's marker before trusting it, so the per-chunk
                    # list (which scales with model size) stays in the local
                    # marker; the registry carries only the shard files plus
                    # chunk_count/baseline_step
                    self.registry.publish(
                        self.node, step=step,
                        files=sorted(r for r in pmap
                                     if pmap[r][0] == "shard"),
                        local_root=self.store.tier_roots.get(
                            self.promote_tier, self.store.root),
                        tier=self.promote_tier,
                        baseline_step=delta.get("baseline"),
                        chunk_count=chunk_count or None)
                except OSError as e:
                    # the registry is ADVISORY: an unwritable inventory must
                    # not invalidate the (complete, CRC-verified, marker-
                    # published) local cache it merely advertises
                    self.promote_failures.append(
                        f"registry publish step {step}: {e!r}")
        except Exception as e:  # noqa: BLE001 — cache miss, not a failure
            self.promote_failures.append(f"step {step}: {e!r}")
            self.invalidate_promoted()

    def _abort_cancelled(self, step: int, copied: list[str]) -> None:
        """A cancelled promotion must not leak its partial copies: no marker
        will ever reference them, so nothing else would retire them.  Only
        THIS run's copies go — files inherited from the previous marker stay
        for the follow-up promotion to reuse."""
        self.promote_cancelled += 1
        for rel in copied:
            try:
                self.store.delete_file(self.promote_tier, rel)
            except OSError:
                pass                # best-effort: orphans are data, not harm

    def _copy_promoted(self, rel: str, payload: tuple,
                       src_tiers: list[str]) -> None:
        """Copy + CRC-verify one payload file (a shard or a single chunk)
        into the promote tier from the first source that yields intact bytes
        (a peer dying mid-promotion falls back to the next peer, then the
        primary tier)."""
        kind, info = payload
        last: Optional[Exception] = None
        for src in src_tiers:
            try:
                self.store.copy_file(src, rel, self.promote_tier)
                if kind == "chunk":
                    # unframe_chunk verifies the raw CRC whether the copied
                    # file is a frameless chunk or a compressed frame — the
                    # promoted copy is the FILE, so both must verify
                    data = self.store.get(self.promote_tier, rel)
                    SER.unframe_chunk(data, info["nbytes"],
                                      crc32=info["crc32"])
                else:
                    self.store.read_shard_leaves(
                        self.promote_tier, rel, [e["path"] for e in info],
                        expect_crcs={e["path"]: e["crc32"] for e in info})
                return
            except Exception as e:  # noqa: BLE001 — try the next source
                last = e
        raise last if last is not None else FileNotFoundError(rel)

    def prefetch_latest(self, step: Optional[int] = None) -> Optional[int]:
        """Eager promotion: schedule a write-behind copy of the latest (or
        given) committed step into the promote tier without restoring it —
        call at job start so the restart after the NEXT preemption is served
        node-locally.  Returns the step scheduled, or None."""
        if self._promoter is None:
            return None
        all_steps = self.steps()
        if not all_steps:
            return None
        step = all_steps[-1] if step is None else step
        if (marker := self._read_marker()) is not None and marker.get("step") == step:
            return step                    # already cached: skip the I/O
        manifest = self.read_manifest(step)
        self._schedule_promotion(manifest)
        return step

    def wait_promotions(self, timeout: Optional[float] = None) -> None:
        if self._promoter is not None:
            self._promoter.wait(timeout)

    # -- multi-worker orphan-chunk sweep --------------------------------
    def _inflight_rel(self, kind: str, step: int) -> str:
        return (f"{self.prefix}/inflight/"
                f"{kind}_{step:010d}_w{self.worker_id:05d}.json")

    def _fresh_inflight(self, now: float, stale_s: float) -> list[str]:
        """In-flight intent markers that are still live.  A marker older
        than ``stale_s`` belongs to a writer that died mid-save (a live one
        re-publishes per save/pre-dump); it is retired here so one crashed
        worker cannot block orphan reclamation forever."""
        fresh: list[str] = []
        for rel in sorted(self.store.list_prefix(
                self.tier, f"{self.prefix}/inflight")):
            try:
                t = float(json.loads(
                    self.store.get(self.tier, rel).decode())["t"])
            except (FileNotFoundError, ValueError, TypeError, KeyError,
                    OSError):
                t = None             # torn marker: age it out via mtime
                try:
                    t = self.store.mtime(self.tier, rel)
                except (FileNotFoundError, OSError):
                    continue
            if now - t > stale_s:
                self.store.delete_file(self.tier, rel)
                continue
            fresh.append(rel)
        return fresh

    def _uncommitted_chunk_refs(self, committed: set) -> set:
        """Chunk hashes referenced by wparts of steps with NO manifest yet —
        an in-flight commit's payload, which the sweep must treat exactly
        like kept-manifest refs (the file plane's gc has the same rule:
        never touch an uncommitted step dir)."""
        out: set = set()
        for rel in self.store.list_prefix(self.tier, self.prefix):
            parts = Path(rel).parts
            if (len(parts) < 2 or not parts[-2].startswith("step_")
                    or not parts[-1].startswith("wpart_")):
                continue
            if int(parts[-2].split("_")[1]) in committed:
                continue
            try:
                part = json.loads(self.store.get(self.tier, rel).decode())
            except (FileNotFoundError, ValueError, OSError):
                raise ValueError(f"unreadable in-flight wpart {rel}")
            for e in part.get("leaves") or ():
                out.update(c["hash"] for c in e.get("chunks") or ())
        return out

    def sweep_orphan_chunks(self, *,
                            stale_marker_s: float = 900.0) -> dict:
        """Coordinator-side reclamation of chunk files NO referent explains:
        ``chunk_digests`` minus kept-manifest refs, minus uncommitted-wpart
        refs, minus this manager's own pending pre-dump writes.  What
        remains is multi-worker pre-dump fallout — chunks pre-written for a
        step whose save no longer contains them — which the per-save sweep
        deliberately leaves alone when other writers exist (see
        ``_save_delta``).

        Barriered against in-flight saves three ways: any FRESH intent
        marker (``<prefix>/inflight/``, published by every delta save and
        pre-dump before its first chunk write) defers the whole sweep;
        markers are re-checked after candidate collection so a save that
        started mid-sweep also defers it; and a candidate whose file mtime
        is at/after the sweep's start is skipped — a writer that raced past
        both marker checks re-touched it.  Crashed writers' markers age out
        after ``stale_marker_s``.

        Returns ``{"reaped": [hashes], "skipped": reason|None}`` (also
        stored as ``last_orphan_sweep``)."""
        t0 = time.time()
        info: dict = {"reaped": [], "skipped": None}
        self.last_orphan_sweep = info
        if self._predump_pending:
            # own pre-dump still materializing on the pool: its write set is
            # unknown here, and its marker may not be on disk yet
            info["skipped"] = "own pre-dump pending"
            return info
        if self._fresh_inflight(t0, stale_marker_s):
            info["skipped"] = "in-flight saves"
            return info
        digests = self.store.chunk_digests(self.tier, self.prefix)
        if not digests:
            return info
        try:
            steps = self.steps()
            kept = steps[-self.keep_last:] if self.keep_last else steps
            keep: set = set()
            for s in kept:
                keep |= manifest_chunk_hashes(self.read_manifest(s))
            keep |= self._uncommitted_chunk_refs(set(steps))
        except (FileNotFoundError, ValueError, KeyError, OSError):
            # can't PROVE a chunk unreferenced: leak it (bounded, the next
            # sweep retries) rather than tear a restorable step
            info["skipped"] = "unreadable manifest or wpart"
            return info
        if self._predump is not None:
            keep |= set(self._predump.get("written") or ())
        cands = sorted(digests - keep)
        if not cands:
            return info
        if self._fresh_inflight(time.time(), stale_marker_s):
            info["skipped"] = "in-flight saves"
            return info
        for h in cands:
            rel = chunk_rel(self.prefix, h)
            try:
                if self.store.mtime(self.tier, rel) >= t0:
                    continue          # (re)written since the sweep started
            except (FileNotFoundError, OSError):
                continue
            self.store.delete_file(self.tier, rel)
            info["reaped"].append(h)
        return info

    # ------------------------------------------------------------------
    def gc(self) -> None:
        """Old manifests are always removed (a checkpoint 'exists' iff its
        manifest does); step dirs survive only while an incremental manifest
        in the kept set references their shard files.  Content-addressed
        chunks are reaped by REFCOUNT, not by step: a chunk stays on disk
        while ANY kept manifest references it (delta chains share most of
        their chunks, so per-step deletion would tear live data), and is
        deleted exactly when its count drops to zero."""
        steps = self.steps()
        keep = set(steps[-self.keep_last:]) if self.keep_last else set(steps)
        referenced_dirs = set()
        kept_manifests = []
        for s in keep:
            man = self.read_manifest(s)
            kept_manifests.append(man)
            for e in man["leaves"]:
                if e.get("file"):
                    referenced_dirs.add(str(Path(e["file"]).parent))
        # retired manifests are read BEFORE anything is deleted: their chunk
        # references are the reap candidates below
        retired_manifests = []
        for s in steps:
            if s not in keep:
                try:
                    retired_manifests.append(self.read_manifest(s))
                except (FileNotFoundError, ValueError, KeyError):
                    continue
        doomed = [s for s in steps
                  if s not in keep
                  and _step_dir(self.prefix, s) not in referenced_dirs]
        if doomed and self._promoter is not None:
            # GC/promotion race: the write-behind copier may be mid-copy of a
            # step whose shared shards are about to vanish.  Flag it so the
            # copier aborts before publishing a marker, and drop any marker
            # already naming a doomed step (marker first — a reader must
            # never trust files being deleted under it).
            with self._promo_lock:
                for s in doomed:
                    if s in self._promo_inflight:
                        self._promo_doomed.add(s)
            marker = self._read_marker()
            if marker is not None and marker.get("step") in doomed:
                self.invalidate_promoted()
        for s in steps:
            if s in keep:
                continue
            sdir = _step_dir(self.prefix, s)
            if sdir in referenced_dirs:
                # keep the shard data, retire the manifest + parts.  The
                # retired step may have been written under a DIFFERENT worker
                # count (elastic restart), so the part count comes from the
                # step's own manifest — not this manager's num_workers.
                try:
                    nw = int(self.read_manifest(s).get("num_workers",
                                                       self.num_workers))
                except (FileNotFoundError, ValueError, KeyError):
                    nw = 0
                self.store.delete_file(self.tier, f"{sdir}/MANIFEST.json")
                if nw:
                    for w in range(nw):
                        self.store.delete_file(
                            self.tier, f"{sdir}/wpart_{w:05d}.json")
                else:   # manifest unreadable: sweep whatever parts exist
                    for rel in self.store.list_prefix(self.tier, sdir):
                        if Path(rel).name.startswith("wpart_"):
                            self.store.delete_file(self.tier, rel)
            else:
                self.store.delete_prefix(self.tier, sdir)
        # chunk plane: refcount-aware reaping.  A chunk is reaped when the
        # manifests RETIRED this cycle referenced it and its refcount across
        # the KEPT manifests is zero (each manifest is self-contained, so
        # ancestors of a kept delta step pin nothing beyond what it lists).
        # Deliberately NOT "every on-disk chunk not in a kept manifest": a
        # worker may have already written chunks for a step whose manifest
        # is not committed yet — like the file plane, which never touches
        # uncommitted step dirs, gc must not eat an in-flight save.
        live = set(chunk_refcounts(kept_manifests))
        for h in sorted(set(chunk_refcounts(retired_manifests)) - live):
            self.store.delete_file(self.tier, chunk_rel(self.prefix, h))
        if self.delta and self.num_workers > 1:
            # multi-worker pre-dump fallout is invisible to the manifest
            # walk above (orphans are referenced by no manifest at all);
            # the coordinator — the only caller of gc(), via commit() —
            # reclaims it here, barriered on the in-flight intent markers
            self.sweep_orphan_chunks()

    def close(self) -> None:
        try:
            if self._writer is not None:
                self._writer.close()
        finally:
            try:
                if self._predumper is not None:
                    self._predumper.close()
            finally:
                try:
                    if self._hash_engine is not None:
                        self._hash_engine.close()
                finally:
                    if self._promoter is not None:
                        self._promoter.close()
