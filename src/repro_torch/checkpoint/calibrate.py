"""Calibrated tier profiles: measured bandwidth/latency instead of guesses.

``DEFAULT_TIERS`` carries hand-written numbers (40 GB/s ram, 1 GB/s shared
parallel FS) that shape everything downstream — ``_simulate`` sleep times in
benchmarks, ``tier_slots`` concurrency budgets, and through those the
restore pool sizing (``auto_workers`` caps at the summed concurrency of the
source tiers).  On a real host those guesses are wrong in both directions:
tmpfs reads run at memory speed, an NFS-backed "shared" root may be 50x
slower than the guess.  ``calibrate_tiers`` replaces the guesswork with a
short measurement against each tier's actual backing directory:

* **sequential bandwidth** — one scratch file written, then read back start
  to finish; the read side is timed (write speed is not what restore cares
  about).
* **random-read latency + bandwidth** — N positional reads at seeded-random
  offsets; the per-op time in excess of the pure transfer time is the
  latency estimate.
* **concurrency** — the bandwidth-delay product: how many in-flight ranged
  reads it takes to cover the measured latency at the measured bandwidth
  (clamped to a sane [2, 32] band).  That is exactly the number
  ``tier_slots`` should admit and ``auto_workers`` should cap at.

Results are cached as one atomic JSON file (``tier_profile.json`` under the
store root, via ``repro_torch.utils.atomic``) so a fleet of restore processes pays
the probe once per node, not once per process; ``max_age_s`` bounds staleness
and ``force=True`` re-measures.  Measurements deliberately bypass
``TieredStore`` — calibration reads the real filesystem, never the simulated
costs it exists to replace.

Peer tiers (``peer:<node>``) are never probed: their roots belong to another
node and a calibration write there would be a cross-node side effect.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Optional

from repro_torch.checkpoint import io_backend as IOB
from repro_torch.checkpoint.store import is_peer_tier
from repro_torch.utils.atomic import atomic_write_json

CALIB_FILENAME = "tier_profile.json"
CALIB_VERSION = 1
DEFAULT_MAX_AGE_S = 24 * 3600.0

# probe sizing: big enough that per-syscall overhead does not dominate the
# sequential number, small enough that calibrating a slow shared FS stays
# well under a second of I/O
PROBE_FILE_BYTES = 8 << 20
PROBE_RANGE_BYTES = 256 << 10
PROBE_RANGES = 32

_MIN_CONC, _MAX_CONC = 2, 32


def _bdp_concurrency(bandwidth_gbps: float, latency_s: float,
                     range_bytes: int = PROBE_RANGE_BYTES) -> int:
    """In-flight ranged reads needed to keep the pipe full: the classic
    bandwidth-delay product, in units of one typical restore range."""
    per_range_s = range_bytes / max(bandwidth_gbps * 1e9, 1.0)
    need = (latency_s + per_range_s) / max(per_range_s, 1e-9)
    return max(_MIN_CONC, min(_MAX_CONC, round(need)))


def _measure_root(directory: Path, *, file_bytes: int = PROBE_FILE_BYTES,
                  range_bytes: int = PROBE_RANGE_BYTES,
                  ranges: int = PROBE_RANGES) -> dict:
    """Measure one backing directory.  Returns the raw numbers; interpreting
    them into a TierSpec is ``calibrate_tiers``'s job."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    scratch = directory / f".tier_probe.{os.getpid()}"
    # incompressible-ish payload: a repeated urandom page, so a filesystem
    # with transparent compression cannot flatter the read numbers much
    # while the probe stays cheap to generate
    page = os.urandom(min(file_bytes, 1 << 20))
    reps = -(-file_bytes // len(page))
    try:
        with open(scratch, "wb") as fp:
            for _ in range(reps):
                fp.write(page)
            fp.flush()
            os.fsync(fp.fileno())
        size = scratch.stat().st_size

        fd = os.open(scratch, os.O_RDONLY)
        try:
            t0 = time.perf_counter()
            pos = 0
            while pos < size:
                got = os.pread(fd, 4 << 20, pos)
                if not got:
                    break
                pos += len(got)
            seq_s = max(time.perf_counter() - t0, 1e-9)

            # seeded offsets: the probe is deterministic for a given file
            # size, so two processes racing the cache measure the same plan
            step = max((size - range_bytes) // max(ranges, 1), 1)
            offsets = [(i * step * 2654435761) % max(size - range_bytes, 1)
                       for i in range(ranges)]
            t0 = time.perf_counter()
            for off in offsets:
                os.pread(fd, range_bytes, off)
            rand_s = max(time.perf_counter() - t0, 1e-9)
        finally:
            os.close(fd)
    finally:
        try:
            scratch.unlink()
        except OSError:
            pass

    seq_gbps = size / seq_s / 1e9
    rand_gbps = (range_bytes * ranges) / rand_s / 1e9
    # per-op time not explained by pure transfer at sequential speed is the
    # access latency; floor at 1us so a fully-cached tmpfs never yields zero
    per_op = rand_s / max(ranges, 1)
    xfer = range_bytes / max(seq_gbps * 1e9, 1.0)
    latency_s = max(per_op - xfer, 1e-6)
    return {
        "seq_gbps": round(seq_gbps, 4),
        "rand_gbps": round(rand_gbps, 4),
        "latency_s": round(latency_s, 7),
        "file_bytes": size,
        "range_bytes": range_bytes,
        "ranges": ranges,
        "direct_align": IOB.probe_direct_io(directory),
    }


def _load_cached(path: Path, max_age_s: float) -> Optional[dict]:
    try:
        profile = json.loads(path.read_text())
    except (OSError, ValueError):
        return None
    if profile.get("version") != CALIB_VERSION:
        return None
    if time.time() - float(profile.get("t", 0)) > max_age_s:
        return None
    if not isinstance(profile.get("roots"), dict):
        return None
    return profile


def apply_profile(store, profile: dict) -> dict:
    """Overwrite the store's TierSpec numbers with a profile's measurements.
    Returns ``{tier: TierSpec}`` of the specs actually replaced.  Tiers whose
    root was not measured (peers, unknown roots) keep their current spec."""
    applied = {}
    for tier, spec in list(store.tiers.items()):
        if is_peer_tier(tier):
            continue
        root = str(store.tier_roots.get(tier, store.root))
        m = profile["roots"].get(root)
        if not m:
            continue
        new = dataclasses.replace(
            spec,
            bandwidth_gbps=max(float(m["seq_gbps"]), 1e-3),
            latency_s=float(m["latency_s"]),
            concurrency=_bdp_concurrency(float(m["seq_gbps"]),
                                         float(m["latency_s"])))
        store.tiers[tier] = new
        applied[tier] = new
    # concurrency semaphores are created lazily per tier and cached; drop
    # them so the calibrated budgets take effect for the next restore
    with store._sems_lock:
        store._sems.clear()
    return applied


def calibrate_tiers(store, *, path=None, max_age_s: float = DEFAULT_MAX_AGE_S,
                    force: bool = False,
                    file_bytes: int = PROBE_FILE_BYTES,
                    range_bytes: int = PROBE_RANGE_BYTES,
                    ranges: int = PROBE_RANGES) -> dict:
    """Measure (or load the cached measurement of) every tier root and apply
    the results onto ``store.tiers``.  Returns the profile dict.

    One measurement per UNIQUE backing directory: tiers sharing a root (ram
    and local both mounted on one node-local disk) share one probe and get
    the same numbers, which is the truth — they ARE the same device."""
    path = Path(path) if path is not None else Path(store.root) / CALIB_FILENAME
    profile = None if force else _load_cached(path, max_age_s)
    roots = {}
    for tier in store.tiers:
        if is_peer_tier(tier):
            continue
        roots.setdefault(str(store.tier_roots.get(tier, store.root)), tier)
    if profile is None or set(profile["roots"]) != set(roots):
        measured = {root: _measure_root(Path(root), file_bytes=file_bytes,
                                        range_bytes=range_bytes,
                                        ranges=ranges)
                    for root in roots}
        profile = {"version": CALIB_VERSION, "t": time.time(),
                   "roots": measured}
        try:
            atomic_write_json(path, profile)
        except OSError:
            pass            # cache is an optimization; the numbers still apply
    apply_profile(store, profile)
    return profile
