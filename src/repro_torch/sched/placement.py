"""Restore-aware placement scoring — prefer nodes holding a warm promoted cache.

The paper's restart cost is dominated by re-reading checkpoint and
container-image bytes from the shared filesystem; NERSC's Shifter/Podman-HPC
image caches make a SAME-NODE restart cheap.  The checkpoint plane has the
framework analogue (shared->local promotion with a two-phase ``PROMOTED.json``
marker); this module teaches the scheduler to exploit it: on requeue, probe every
candidate node's local tier and prefer the one whose promoted cache is warm
for the job's latest committed step.

Scoring (``rank_nodes``):

  SCORE_WARM (2)  node's ``PROMOTED.json`` validates against the latest
                  committed step (invalidation/truncation-aware — see
                  ``checkpoint.manager.validate_promoted_cache``);
  SCORE_HINT (1)  node matches the requeue record's last placement
                  (``<ckpt_dir>/requeue.json`` written by the job via
                  ``core/requeue.py``) — the OS page/container-image cache
                  may still be warm even when no promotion ran;
  SCORE_COLD (0)  everything else.

When the best free node is NOT warm (contention, or the warm node's
``warm_wait_s`` budget ran out), the scheduler no longer just eats the cold
restore: ``warm_peer_roots`` turns the same probe results into a peer hint —
the other nodes whose promoted caches validated warm — which the launcher
hands to the job (``REPRO_PEER_ROOTS``) so its restore engine sources ranges
from a warm peer's local tier instead of the shared filesystem (see
sched/cache_registry.py and checkpoint/restore_engine.py).

Placement is strictly advisory: a wrong pick costs shared-filesystem reads,
never correctness — stale caches are rejected at probe time AND again (CRC
pinned) in the restore path.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional

from repro_torch.checkpoint.manager import committed_steps, validate_promoted_cache
from repro_torch.checkpoint.store import TieredStore

SCORE_WARM = 2
SCORE_HINT = 1
SCORE_COLD = 0


@dataclasses.dataclass
class CacheAffinity:
    """How the scheduler probes a job's checkpoint caches.

    ``ckpt_dir`` is the job's TieredStore root (the shared tier and the
    requeue record live under it); each candidate node's local tier is
    mounted at that node's ``local_root``.  ``warm_wait_s`` bounds how long a
    requeued job may stay PENDING waiting for a busy warm node before it
    falls back to any free node (0 = never wait).
    """

    ckpt_dir: str
    prefix: str = "ckpt"
    tier: str = "shared"
    promote_tier: str = "local"
    warm_wait_s: float = 0.0

    def requeue_record(self) -> dict:
        try:
            return json.loads(
                (Path(self.ckpt_dir) / "requeue.json").read_text())
        except (FileNotFoundError, ValueError, OSError):
            return {}


def probe_cache(aff: CacheAffinity, local_root: Path,
                latest: Optional[int] = None) -> dict:
    """Validate one node's promoted cache for ``aff``'s checkpoint prefix.
    Builds a store view whose promote tier is rooted at the node.  Pass
    ``latest`` when probing many nodes so the (node-independent) shared-tier
    step listing is done once, not per node."""
    store = TieredStore(Path(aff.ckpt_dir),
                        tier_roots={aff.promote_tier: Path(local_root)})
    return validate_promoted_cache(store, tier=aff.tier,
                                   promote_tier=aff.promote_tier,
                                   prefix=aff.prefix, latest=latest)


def rank_nodes(candidates: list[tuple[str, Path]],
               aff: CacheAffinity,
               last_node: Optional[str] = None) -> dict[str, dict]:
    """Score every candidate ``(name, local_root)``.  Returns
    ``{name: {"score": int, "probe": dict|None}}`` — the scheduler picks the
    highest-scoring free node (submission order breaks ties).
    """
    if last_node is None:
        last_node = aff.requeue_record().get("node")
    # the shared tier is one filesystem for every node: list its committed
    # steps once, not once per candidate
    steps = committed_steps(TieredStore(Path(aff.ckpt_dir)),
                            aff.tier, aff.prefix)
    latest = steps[-1] if steps else None
    out: dict[str, dict] = {}
    for name, local_root in candidates:
        probe = probe_cache(aff, local_root, latest=latest)
        if probe["valid"]:
            score = SCORE_WARM
        elif last_node is not None and name == last_node:
            score = SCORE_HINT
        else:
            score = SCORE_COLD
        out[name] = {"score": score, "probe": probe}
    return out


def warm_peer_roots(candidates: list[tuple[str, Path]],
                    ranked: dict[str, dict],
                    exclude: tuple = ()) -> dict[str, str]:
    """The peer hint for a job placed on a cold node: every candidate whose
    promoted cache probed warm, minus ``exclude`` (the chosen node), as
    ``{node: local_root}`` ready for ``cache_registry.format_peer_roots``.
    Advisory like every probe — the job re-validates each peer's marker and
    pins manifest CRCs before trusting a single payload byte."""
    ex = set(exclude)
    return {name: str(root) for name, root in candidates
            if name not in ex
            and (ranked.get(name) or {}).get("probe", {}).get("valid")}
