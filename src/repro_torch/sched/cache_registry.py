"""Cluster-wide inventory of warm promoted checkpoint caches (peer fabric).

The scheduler's placement probe (sched/placement.py) answers "is THIS node
warm?"; the peer fabric needs the transpose — "which OTHER nodes are warm for
step N, and where do their caches mount?" — so a job placed on a cold node
can source its restore from a warm peer's local tier instead of the shared
parallel filesystem (the DMTCP cluster story: peers cooperate on restart).

The registry is one tiny JSON file per node under a shared directory
(default ``<ckpt_dir>/peer_registry/<node>.json``), written atomically
(tmp + rename) by ``CheckpointManager`` when a promotion COMMITS (after the
two-phase ``PROMOTED.json`` marker is published) and withdrawn whenever the
node invalidates its cache.  Entry schema:

    {"node": "node3", "step": 41, "files": ["ckpt/step_.../shard_...bin"...],
     "local_root": "/.../nodes/node3", "tier": "local", "published_at": ...}

Readers treat the inventory as strictly ADVISORY: a torn entry reads as
absent, a ``step`` mismatch is stale and skipped, and even a lying entry (the
peer died between GC'ing its cache and withdrawing) only costs a per-range
fallback — the restore path re-checks the peer's marker, pins manifest CRCs,
and falls back to the next peer or the shared tier on any failure, so a stale
inventory entry is never *served*.

``REPRO_PEER_ROOTS`` (``name=root,name=root``) is the same information on the
scheduler -> job wire: SlurmSim computes warm peers from its own placement
probes and hands them to the launched process, which merges them with
whatever the registry holds.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Iterable, Optional

from repro_torch.utils.atomic import atomic_write_json

ENV_PEER_ROOTS = "REPRO_PEER_ROOTS"
REGISTRY_DIRNAME = "peer_registry"
FOLLOWER_DIRNAME = "followers"


def format_peer_roots(peers: dict) -> str:
    """``{name: root}`` -> the ``name=root,name=root`` env/CLI encoding."""
    return ",".join(f"{n}={p}" for n, p in sorted(peers.items()))


def parse_peer_roots(raw: Optional[str]) -> dict[str, Path]:
    """Parse the ``name=root,name=root`` encoding (env var or ``--peer-roots``
    flag); malformed fragments are dropped, not fatal — a mangled hint must
    degrade to a cold restore, never kill the restart."""
    out: dict[str, Path] = {}
    for part in (raw or "").split(","):
        name, sep, root = part.strip().partition("=")
        if name and sep and root:
            out[name] = Path(root)
    return out


class CacheRegistry:
    """Per-node warm-cache inventory under one shared directory."""

    def __init__(self, root: Path):
        self.root = Path(root)

    def _path(self, node: str) -> Path:
        return self.root / f"{node}.json"

    def _atomic_write(self, p: Path, obj: dict) -> None:
        """Atomic JSON publish with a UNIQUE tmp name — the shared
        ``utils.atomic`` contract (see that module for why a fixed
        ``<name>.json.tmp`` path would tear under concurrent writers of
        the same key)."""
        atomic_write_json(p, obj)

    def publish(self, node: str, *, step: int, files: Iterable[str],
                local_root, tier: str = "local",
                baseline_step: Optional[int] = None,
                chunk_count: Optional[int] = None) -> dict:
        """Record that ``node`` holds a validated promoted cache of ``step``
        under ``local_root`` (atomic tmp + rename, so a concurrent reader
        sees the old entry or the new one, never a torn one).

        Delta-aware entries additionally advertise the chunk inventory: for
        a chunked (v3) cache, ``files`` already lists the content-addressed
        chunk paths, and ``baseline_step``/``chunk_count`` tell readers the
        cache's delta-chain baseline and how many chunks it holds — what a
        cold node's planner needs to decide that a STALE peer is still worth
        sourcing from (most chunks survive across nearby steps)."""
        entry = {
            "node": node,
            "step": int(step),
            "files": sorted(files),
            "local_root": str(local_root),
            "tier": tier,
            "published_at": time.time(),
        }
        if baseline_step is not None:
            entry["baseline_step"] = int(baseline_step)
        if chunk_count is not None:
            entry["chunk_count"] = int(chunk_count)
        self._atomic_write(self._path(node), entry)
        return entry

    def withdraw(self, node: str) -> None:
        """Drop ``node``'s entry (its cache was invalidated or GC'd)."""
        self._path(node).unlink(missing_ok=True)

    # -- follower caches (serving fleet, replica-to-replica) -------------
    # A serving replica that finishes a weight sync holds every chunk of
    # the synced step in its node-local tier (its own stale promoted cache
    # plus the delta the fetch teed in) WITHOUT owning the node's
    # ``PROMOTED.json`` — it is a read-only follower, the marker may belong
    # to another consumer on the node.  These entries advertise that
    # inventory as a chunk-only peer source: replica N+1 pulls the delta
    # from replica N instead of the shared tier, so fleet-wide shared-tier
    # bytes stay ~one delta however large the fleet.  Chunk-only means
    # readers must never plan shard files or manifests against them —
    # ``near_peers`` folds them in, ``warm_peers`` (the shard fabric's
    # source) never does.

    def _follower_path(self, node: str) -> Path:
        return self.root / FOLLOWER_DIRNAME / f"{node}.json"

    def publish_follower(self, node: str, *, step: int, local_root,
                         tier: str = "local",
                         baseline_step: Optional[int] = None,
                         chunk_count: Optional[int] = None) -> dict:
        """Record that follower ``node`` holds all chunks of ``step`` under
        ``local_root`` (one file per node under ``followers/``, atomic,
        superseded by the node's next sync).  Advisory like every entry:
        the chunk plane re-pins manifest CRCs per chunk, so a lying or GC'd
        follower cache costs a per-chunk fallback, never wrong bytes."""
        entry = {
            "node": node,
            "step": int(step),
            "kind": "follower",
            "local_root": str(local_root),
            "tier": tier,
            "published_at": time.time(),
        }
        if baseline_step is not None:
            entry["baseline_step"] = int(baseline_step)
        if chunk_count is not None:
            entry["chunk_count"] = int(chunk_count)
        self._atomic_write(self._follower_path(node), entry)
        return entry

    def withdraw_follower(self, node: str) -> None:
        """Drop ``node``'s follower-cache entry (its local tier was
        invalidated, or the replica left the fleet)."""
        self._follower_path(node).unlink(missing_ok=True)

    def follower_entries(self) -> dict[str, dict]:
        """All parseable follower-cache entries, keyed by node (same torn-
        file tolerance as ``entries``)."""
        out: dict[str, dict] = {}
        fdir = self.root / FOLLOWER_DIRNAME
        if not fdir.is_dir():
            return out
        for p in sorted(fdir.glob("*.json")):
            try:
                e = json.loads(p.read_text())
            except (ValueError, OSError):
                continue
            if (isinstance(e, dict) and e.get("node")
                    and isinstance(e.get("step"), int)
                    and e.get("local_root")):
                e.setdefault("kind", "follower")
                out[e["node"]] = e
        return out

    def entries(self) -> dict[str, dict]:
        """All parseable entries, keyed by node.  Torn/malformed files read
        as absent — the writer is atomic, but a reader must survive anything
        a crashed peer left behind."""
        out: dict[str, dict] = {}
        if not self.root.is_dir():
            return out
        for p in sorted(self.root.glob("*.json")):
            try:
                e = json.loads(p.read_text())
            except (ValueError, OSError):
                continue
            if (isinstance(e, dict) and e.get("node")
                    and isinstance(e.get("step"), int)
                    and e.get("local_root")):
                out[e["node"]] = e
        return out

    def warm_peers(self, step: int, exclude: Iterable[Optional[str]] = ()
                   ) -> dict[str, dict]:
        """Entries claiming a warm cache of exactly ``step``, minus
        ``exclude`` (normally the asking node itself).  Advisory — the
        restore path re-validates every peer before reading payload."""
        ex = {n for n in exclude if n}
        return {n: e for n, e in self.entries().items()
                if e["step"] == int(step) and n not in ex}

    def near_peers(self, step: int, exclude: Iterable[Optional[str]] = (),
                   max_lag: Optional[int] = None,
                   include_followers: bool = True) -> dict[str, dict]:
        """Chunk-capable peer entries for ``step``: promoted caches of some
        OTHER step — stale for the shard fabric, but a chunk-plane (delta)
        restore resolves by content hash, so these peers still serve every
        chunk shared with the target step — plus (by default) follower-
        cache entries at ANY step within ``max_lag``, including exactly
        ``step``: a follower that synced the target step serves its whole
        delta, but only chunk-wise (no marker, no manifest), so even an
        exact-step follower belongs here and never in ``warm_peers``.
        Ordered nearest-step-first (the closer the cached step, the larger
        the expected chunk overlap), a node's nearest entry winning when it
        has both kinds.  Advisory, like everything here."""
        ex = {n for n in exclude if n}
        step = int(step)
        cands = [(abs(e["step"] - step), n, e)
                 for n, e in self.entries().items()
                 if e["step"] != step and n not in ex]
        if include_followers:
            cands += [(abs(e["step"] - step), n, e)
                      for n, e in self.follower_entries().items()
                      if n not in ex]
        out: dict[str, dict] = {}
        for lag, n, e in sorted(cands, key=lambda c: (c[0], c[1])):
            if n not in out and (max_lag is None or lag <= max_lag):
                out[n] = e
        return out

    # -- weight-push plane (serving fleet) ------------------------------
    # The publisher (a fine-tune/RLHF trainer) announces each committed
    # step; serving replicas poll the announcement to learn that a newer
    # step exists WITHOUT listing the checkpoint prefix (one tiny JSON read
    # per poll, whatever the fleet size), and publish their own sync state
    # back so operators/schedulers can see fleet-wide lag in one listing.
    # Same durability story as the cache entries: atomic writes, advisory
    # reads — a replica that trusts a torn announcement merely polls again.

    def _push_path(self) -> Path:
        return self.root / "PUSH.json"

    def announce_push(self, *, step: int, node: Optional[str] = None,
                      manifest_version: Optional[int] = None,
                      meta: Optional[dict] = None) -> dict:
        """Publisher-side: advertise that ``step`` is committed and ready
        for the fleet to pull (called after ``CheckpointManager.commit``
        — the commit marker, not this announcement, is what makes the step
        restorable; the announcement only saves followers the listing)."""
        ann = {"step": int(step), "announced_at": time.time()}
        if node:
            ann["node"] = node
        if manifest_version is not None:
            ann["manifest_version"] = int(manifest_version)
        if meta:
            ann["meta"] = meta
        self._atomic_write(self._push_path(), ann)
        return ann

    def latest_push(self) -> Optional[dict]:
        """Subscriber-side poll: the newest announcement, or None (absent
        or torn — the follower keeps serving its current weights)."""
        try:
            ann = json.loads(self._push_path().read_text())
        except (FileNotFoundError, ValueError, OSError):
            return None
        if isinstance(ann, dict) and isinstance(ann.get("step"), int):
            return ann
        return None

    def _replica_path(self, replica: str) -> Path:
        return self.root / "replicas" / f"{replica}.json"

    def publish_replica(self, replica: str, *, step: Optional[int],
                        target_step: Optional[int] = None,
                        phase: str = "serving",
                        stats: Optional[dict] = None) -> dict:
        """Replica-side: record this serving replica's sync state (current
        ``step``, the ``target_step`` it is converging to, a ``phase`` like
        ``serving``/``fetching``/``swapping``/``stalled``, and the last
        sync's fetch/swap stats).  One file per replica, atomic."""
        entry = {
            "replica": replica,
            "step": step,
            "phase": phase,
            "updated_at": time.time(),
        }
        if target_step is not None:
            entry["target_step"] = int(target_step)
        if stats:
            entry["stats"] = stats
        self._atomic_write(self._replica_path(replica), entry)
        return entry

    def replica_status(self) -> dict[str, dict]:
        """Fleet view: every parseable replica entry, keyed by replica name,
        each annotated with ``lag`` (latest announced step minus the
        replica's step; None when either side is unknown)."""
        out: dict[str, dict] = {}
        rdir = self.root / "replicas"
        if not rdir.is_dir():
            return out
        ann = self.latest_push()
        latest = ann["step"] if ann else None
        for p in sorted(rdir.glob("*.json")):
            try:
                e = json.loads(p.read_text())
            except (ValueError, OSError):
                continue
            if not (isinstance(e, dict) and e.get("replica")):
                continue
            # clamped at 0 like WeightSyncClient.lag(): a replica AHEAD of
            # the announcement (stale/torn PUSH.json, or it restored a step
            # the publisher has not announced yet) is current, not
            # negatively lagged — dashboards must agree with the replica's
            # own staleness gate
            e["lag"] = (max(0, latest - e["step"])
                        if latest is not None and isinstance(e.get("step"), int)
                        else None)
            out[e["replica"]] = e
        return out
