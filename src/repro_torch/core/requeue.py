"""Walltime tracking + requeue decision — the paper's automated C/R strategy.

The paper's batch script tracks consumed vs remaining walltime (via Slurm
``--comment``), checkpoints shortly before the limit, and ``scontrol requeue``s
itself with the remaining time.  ``WalltimeTracker`` is the framework version;
``RequeueFile`` persists the accounting across requeues (our analogue of the
updated job comment).
"""
from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Optional

from repro_torch.utils.atomic import atomic_write_json


class WalltimeTracker:
    def __init__(self, limit_s: float, margin_s: float = 30.0,
                 total_budget_s: Optional[float] = None,
                 consumed_s: float = 0.0):
        """``limit_s``: this allocation's walltime.  ``margin_s``: checkpoint
        this long before the limit.  ``total_budget_s``: the whole-computation
        budget across requeues (paper: "desired duration")."""
        self.t0 = time.monotonic()
        self.limit_s = limit_s
        self.margin_s = margin_s
        self.total_budget_s = total_budget_s
        self.prior_consumed_s = consumed_s

    @property
    def elapsed_s(self) -> float:
        return time.monotonic() - self.t0

    @property
    def total_consumed_s(self) -> float:
        return self.prior_consumed_s + self.elapsed_s

    @property
    def remaining_s(self) -> float:
        return self.limit_s - self.elapsed_s

    def near_limit(self) -> bool:
        return self.remaining_s <= self.margin_s

    def budget_exhausted(self) -> bool:
        return (self.total_budget_s is not None
                and self.total_consumed_s >= self.total_budget_s)

    def human(self) -> str:
        e = int(self.elapsed_s)
        return f"{e // 3600:02d}:{(e % 3600) // 60:02d}:{e % 60:02d}"


def detect_node() -> Optional[str]:
    """Node identity under a scheduler: slurmsim sets ``SLURMSIM_NODE``, real
    Slurm sets ``SLURMD_NODENAME``."""
    return os.environ.get("SLURMSIM_NODE") or os.environ.get("SLURMD_NODENAME")


class RequeueFile:
    """Persistent per-job accounting (requeue count, consumed time, last
    step, node placements).  The recorded ``node`` is the placement hint the
    restore-aware scheduler (sched/placement.py) round-trips: the node that
    wrote the last checkpoint is the one whose caches are worth preferring.
    """

    def __init__(self, path: Path):
        self.path = Path(path)

    def load(self) -> dict:
        if self.path.exists():
            return json.loads(self.path.read_text())
        return {"requeues": 0, "consumed_s": 0.0, "last_step": -1,
                "node": None, "placements": [], "peer_roots": {}}

    def save(self, tracker: WalltimeTracker, last_step: int, *,
             reason: str = "", node: Optional[str] = None,
             peers: Optional[dict] = None) -> dict:
        rec = self.load()
        rec["requeues"] += 1
        rec["consumed_s"] = tracker.total_consumed_s
        rec["last_step"] = int(last_step)
        rec["last_reason"] = reason
        rec["pid"] = os.getpid()
        node = node if node is not None else detect_node()
        if node is not None:
            # never clobber the last known placement hint with None — a
            # scheduler-less attempt still wants the previous node preferred
            rec["node"] = node
            rec.setdefault("placements", []).append(node)
        if peers is not None:
            # the warm-peer roots this attempt knew about: a scheduler-less
            # restart can still source its restore from them (peer fabric)
            rec["peer_roots"] = {str(k): str(v) for k, v in peers.items()}
        # unique-tmp atomic publish: two attempts racing a requeue record
        # (a dying process and its replacement) must never interleave
        # write/rename on one fixed tmp path
        atomic_write_json(self.path, rec)
        return rec
