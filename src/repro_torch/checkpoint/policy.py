"""CheckpointPolicy — the typed policy surface of ``CheckpointManager``.

Successive changes grew ``CheckpointManager.__init__`` into keyword soup: storage
placement (``tier``/``replicas``/``prefix``), write pipeline (``mode``/
``shard_format``), the delta/chunk plane (``delta``/``chunk_bytes``/
``rebase_every``/``fingerprint``/``hash_workers``), retention
(``keep_last``), restore sizing (``restore_workers``) and cache promotion
(``promote``/``promote_tier``).  Those are POLICY — how checkpoints are
written, kept and restored — as opposed to the manager's IDENTITY kwargs
(``worker_id``/``num_workers``/``node``/``peer_roots``/``registry``), which
say who this manager is inside the cluster.

This dataclass is the policy half, validated once at construction so an
invalid combination fails where it is written, not mid-save on a pool
thread.  ``CheckpointManager(store, CheckpointPolicy(...))`` is the
supported construction; the old flat kwargs still work through a
deprecation shim (see ``CheckpointManager.__init__``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

PROMOTE_POLICIES = ("off", "on_restore", "eager")

# fixed-size chunking default lives in serialization.DELTA_CHUNK_BYTES;
# ``chunk_bytes=None`` means "use that default", resolved by the manager so
# the policy stays a pure value object with no import cycle
_MODES = ("sync", "async")
_SHARD_FORMATS = (1, 2)


@dataclasses.dataclass(frozen=True)
class CheckpointPolicy:
    """How checkpoints are written, retained, promoted and restored.

    Field groups (the old ``CheckpointManager.__init__`` keyword soup,
    now typed and validated together):

    * placement: ``tier``, ``replicas``, ``prefix``
    * write pipeline: ``mode`` ("sync"/"async"), ``shard_format``,
      ``incremental``
    * delta/chunk plane: ``delta``, ``chunk_bytes``, ``rebase_every``,
      ``fingerprint``, ``hash_workers`` (pre-dump rides on these — see
      ``CheckpointManager.precommit``), ``compress`` (per-chunk frame
      level: 0 = frameless raw, >=1 = zstd/zlib at that level; hashes stay
      over uncompressed content so dedup and fingerprints are unaffected)
    * retention: ``keep_last``
    * restore: ``restore_workers`` (0 = auto, 1 = serial), ``io_batch``
      (ranges per batched read submission: 0 = $REPRO_IO_BATCH / default,
      1 = per-range reads)
    * promotion: ``promote`` ("off"/"on_restore"/"eager"), ``promote_tier``
    """

    # -- placement ------------------------------------------------------
    tier: str = "shared"
    replicas: int = 2
    prefix: str = "ckpt"
    # -- write pipeline -------------------------------------------------
    mode: str = "sync"
    shard_format: int = 2          # 1 = legacy writer (compat tests)
    incremental: bool = False
    # -- delta / chunk plane --------------------------------------------
    delta: bool = False
    chunk_bytes: Optional[int] = None      # None -> DELTA_CHUNK_BYTES
    rebase_every: int = 8
    fingerprint: bool = False
    device_fp: bool = False        # dirty detection on device (delta only)
    hash_workers: int = 0
    compress: int = 0              # per-chunk frame level; 0 = frameless raw
    # -- retention ------------------------------------------------------
    keep_last: int = 3
    # -- restore --------------------------------------------------------
    restore_workers: int = 0
    io_batch: int = 0              # ranges per submission; 0 = env/default
    # -- promotion ------------------------------------------------------
    promote: str = "off"
    promote_tier: str = "local"

    def __post_init__(self) -> None:
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got {self.mode!r}")
        if self.shard_format not in _SHARD_FORMATS:
            raise ValueError(
                f"shard_format must be one of {_SHARD_FORMATS}, "
                f"got {self.shard_format!r}")
        if self.promote not in PROMOTE_POLICIES:
            raise ValueError(
                f"promote must be one of {PROMOTE_POLICIES}, "
                f"got {self.promote!r}")
        # delta (v3 chunk plane) and incremental (v1/v2 leaf reuse) are two
        # answers to the same question; combining them would mix chunked and
        # file-based leaves inside one manifest for no gain
        if self.delta and self.incremental:
            raise ValueError("delta and incremental are exclusive")
        if self.rebase_every < 1:
            raise ValueError(
                f"rebase_every must be >= 1, got {self.rebase_every}")
        # the promote tier is a CACHE whose invalidation deletes files —
        # pointing it at the primary tier would let a stale-cache cleanup
        # destroy the committed checkpoints themselves
        if self.promote != "off" and self.promote_tier == self.tier:
            raise ValueError(
                "promote_tier must differ from the primary checkpoint tier")
        # fingerprints (fingerprint=True and every precommit) view a chunk
        # as a padded <u4 word stream, so an unaligned chunk size must fail
        # HERE — not mid-save, and not on a pre-dump pool thread where the
        # ValueError would only surface at the next wait()
        if (self.delta and self.chunk_bytes is not None
                and (self.chunk_bytes < 4 or self.chunk_bytes % 4)):
            raise ValueError(
                "delta chunk_bytes must be a positive multiple of 4 "
                f"(fingerprint word stream), got {self.chunk_bytes}")
        # device_fp runs the fingerprint kernel on live device residents and
        # gathers only fp-dirty chunks host-side — it IS a delta-plane mode
        if self.device_fp and not self.delta:
            raise ValueError("device_fp requires delta mode")
        # the Pallas fingerprint kernel folds its XOR reduction with a
        # reshape-halving tree, so the per-chunk word count must be a power
        # of two; fail at construction, not inside a jitted save
        if (self.device_fp and self.chunk_bytes is not None
                and (self.chunk_bytes // 4) & (self.chunk_bytes // 4 - 1)):
            raise ValueError(
                "device_fp chunk_bytes must be 4 * a power of two "
                f"(Pallas fold), got {self.chunk_bytes}")
        # 22 is zstd's max standard level; zlib callers are clamped to 9 at
        # frame time.  compress only shapes the chunk plane's on-disk frame,
        # so it is legal (and a no-op) without delta — but a negative level
        # is always a typo.
        if not 0 <= self.compress <= 22:
            raise ValueError(
                f"compress must be in [0, 22], got {self.compress}")
        if self.io_batch < 0:
            raise ValueError(
                f"io_batch must be >= 0 (0 = auto), got {self.io_batch}")

    # field-name set for the __init__ shim (and the shim-equivalence test)
    @classmethod
    def field_names(cls) -> tuple[str, ...]:
        return tuple(f.name for f in dataclasses.fields(cls))
