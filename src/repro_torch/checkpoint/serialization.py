"""Checkpoint shard serialization: pytree <-> binary shard files.

Three on-disk formats (see EXPERIMENTS.md for the byte-level spec):

v1 (legacy, read-compatible, header-first):
  [8B magic 'RPRCKPT1'][4B header_len][header JSON][raw tensor bytes...]
  Header: {"tensors": [{"path","dtype","shape","offset","nbytes","crc32"}...],
           "meta": {...}}; tensor offsets are relative to the end of the header.

v2 (footer-last, written in a single streaming pass):
  [8B magic 'RPRCKPT2'][raw tensor bytes...][footer JSON]
  [8B footer_len (<Q)][8B magic 'RPRCKPT2']
  Footer: same schema as the v1 header but tensor offsets are ABSOLUTE file
  offsets, so a reader can fetch any single leaf with one ranged read after
  parsing the footer (found from the fixed-size 16-byte trailer).

v3 (content-addressed chunk index; the delta-checkpoint plane):
  [8B magic 'RPRCKPT3'][index JSON][8B index_len (<Q)][8B magic 'RPRCKPT3']
  The index maps each leaf to a LIST OF FIXED-SIZE CHUNKS:
  {"tensors": [{"path","dtype","shape","nbytes","crc32",
                "chunks": [{"hash","nbytes","crc32"}...]}...],
   "meta": {...}, "format": 3, "chunk_bytes": N}
  A v3 file carries NO payload: chunk bytes live in the store's dedup chunk
  plane (``chunks/<hash-prefix>/<hash>``, see store.py), named by content
  hash, so a chunk shared by two steps — or two leaves — exists on disk
  exactly once and a delta save writes only the chunks whose hash changed
  since the parent step.  ``crc32`` on the tensor entry is the WHOLE-LEAF
  crc (the same value v1/v2 store), so a chunk-assembled leaf is verified
  byte-identical to what a full shard restore would produce.

The v2 writer is zero-copy: each leaf's bytes are exposed as a ``memoryview``
(no ``tobytes()`` materialization), its CRC32 is computed once from that view
(or taken from a precomputed map so the save path CRCs each leaf exactly once),
and the view is handed straight to the sink file object.  Peak extra host
memory is therefore one OS write buffer, not one full shard.

CRC32 per tensor (the DMTCP paper stores redundant images; we store checksummed
shards + k replicas — integrity is checked on read and the store falls back to
another replica on mismatch).  Pure numpy/zlib; no pickle for tensor data.
"""
from __future__ import annotations

import functools
import hashlib
import io
import json
import logging
import os
import struct
import zlib
from pathlib import Path
from typing import BinaryIO, Callable, Optional

import numpy as np
import torch

from repro_torch.utils.env import env_positive_int
from repro_torch.utils.tree import flatten_with_names, unflatten_like

log = logging.getLogger(__name__)

MAGIC = b"RPRCKPT1"      # v1: header-first
MAGIC2 = b"RPRCKPT2"     # v2: footer-last, absolute offsets, streamable
MAGIC3 = b"RPRCKPT3"     # v3: payload-free content-addressed chunk index
TRAILER_LEN = 16         # <Q footer_len> + trailing magic (v2 and v3)
# Streaming granularity: CRC/write are chunked so a corrupted mmap'd page or a
# slow sink never pins more than this much per step; views are zero-copy so
# chunking costs no extra memory either way.
CHUNK_BYTES = 4 << 20
# Content-addressing granularity (v3): the unit of dedup and of delta
# transfer.  Smaller chunks shrink the delta for scattered updates but grow
# per-chunk metadata and per-file overhead; 1 MiB keeps the index ~0.01% of
# the payload while an optimizer-only step still collapses to a few chunks.
DELTA_CHUNK_BYTES = 1 << 20


class ChecksumError(RuntimeError):
    pass


# -- per-chunk compression frame (the dedup store's on-disk unit) -----------
#
# A chunk FILE may carry a 4-byte frame header in front of its payload:
#
#   [3B magic b'RCK'][1B codec]  codec 0 = raw, 1 = zlib, 2 = zstd
#
# Hashes, per-chunk CRCs and fingerprints are always over the UNCOMPRESSED
# content — the frame changes only what sits on disk, so dedup, the
# fingerprint pre-filter and the pre-dump pipeline are untouched, and two
# stores at different compression levels still agree on every chunk name.
# Frameless files (every chunk written before compression existed, and all
# writes at ``compress=0``) stay readable: ``unframe_chunk`` disambiguates
# by the known raw size, with the caller's CRC as the final arbiter for the
# pathological raw-bytes-that-look-framed case.

CHUNK_FRAME_MAGIC = b"RCK"
CHUNK_FRAME_LEN = 4
CODEC_RAW = 0
CODEC_ZLIB = 1
CODEC_ZSTD = 2

try:                                    # optional: not in every environment
    import zstandard as _zstd           # pragma: no cover - env-dependent
except ImportError:
    _zstd = None


def zstd_available() -> bool:
    return _zstd is not None


def preferred_codec() -> int:
    """zstd when the binding is importable, else stdlib zlib — compression
    must degrade, never become an install requirement."""
    return CODEC_ZSTD if _zstd is not None else CODEC_ZLIB


def frame_chunk(data, level: int, codec: Optional[int] = None) -> bytes:
    """Compress + frame one chunk payload for the dedup store.

    ``level`` is the policy's ``compress`` level (>= 1; level 0 means "no
    framing at all" and must be handled by the caller — existing stores stay
    byte-identical by default).  A chunk that compresses to no gain is
    framed with ``CODEC_RAW`` instead, so the reader never pays an inflate
    for incompressible float noise and ``cbytes`` stays honest (raw + 4)."""
    if level < 1:
        raise ValueError(f"frame_chunk wants level >= 1, got {level}")
    raw = bytes(data)
    codec = preferred_codec() if codec is None else codec
    if codec == CODEC_ZSTD and _zstd is not None:
        comp = _zstd.ZstdCompressor(level=level).compress(raw)
    elif codec in (CODEC_ZSTD, CODEC_ZLIB):
        codec = CODEC_ZLIB
        comp = zlib.compress(raw, min(level, 9))
    elif codec == CODEC_RAW:
        comp = raw
    else:
        raise ValueError(f"unknown chunk codec {codec}")
    if len(comp) >= len(raw):
        codec, comp = CODEC_RAW, raw
    return CHUNK_FRAME_MAGIC + bytes([codec]) + comp


def _inflate_chunk(codec: int, payload: bytes, raw_nbytes: int) -> bytes:
    if codec == CODEC_RAW:
        return payload
    if codec == CODEC_ZLIB:
        return zlib.decompress(payload)
    if codec == CODEC_ZSTD:
        if _zstd is None:
            raise ChecksumError(
                "chunk framed with zstd but no zstd binding is available")
        return _zstd.ZstdDecompressor().decompress(
            payload, max_output_size=raw_nbytes)
    raise ChecksumError(f"unknown chunk codec {codec}")


def unframe_chunk(blob: bytes, raw_nbytes: int,
                  crc32: Optional[int] = None) -> bytes:
    """Recover the raw chunk content from an on-disk chunk file.

    Speaks both generations: framed files (4-byte header) and legacy
    frameless files (payload only).  Disambiguation: a frameless chunk's
    file length equals its raw ``nbytes`` exactly, a framed one's almost
    never does — and in the one ambiguous corner (raw content that happens
    to start with the frame magic AND a framed file whose length equals the
    raw size) the caller-pinned ``crc32`` decides.  Raises ``ChecksumError``
    when no interpretation yields ``raw_nbytes`` verified bytes."""
    framed = (len(blob) >= CHUNK_FRAME_LEN
              and blob[:len(CHUNK_FRAME_MAGIC)] == CHUNK_FRAME_MAGIC)
    legacy_sized = len(blob) == raw_nbytes
    if framed:
        try:
            raw = _inflate_chunk(blob[3], blob[CHUNK_FRAME_LEN:], raw_nbytes)
        except (zlib.error, ValueError, ChecksumError):
            raw = None
        if (raw is not None and len(raw) == raw_nbytes
                and (crc32 is None or zlib.crc32(raw) == crc32)):
            return raw
        # framed parse failed (or mismatched the pinned CRC): raw content
        # starting with the magic bytes is still a legal legacy file
    if legacy_sized and (crc32 is None or zlib.crc32(blob) == crc32):
        return blob
    raise ChecksumError(
        f"chunk file unreadable as framed or raw ({len(blob)} bytes, "
        f"want {raw_nbytes} raw)")


# ---------------------------------------------------------------------------
# zero-copy leaf byte views
# ---------------------------------------------------------------------------

def as_byte_view(arr: np.ndarray) -> memoryview:
    """Flat uint8 ``memoryview`` over ``arr``'s payload without copying.

    Copies only if the array is non-contiguous (``ascontiguousarray``) — the
    device_get snapshot path always produces contiguous arrays, so the hot
    path is copy-free.  0-d arrays are promoted to shape (1,) views (their
    logical shape is recorded separately by the caller).
    """
    arr = np.ascontiguousarray(arr)
    return memoryview(arr.view(np.uint8).reshape(-1))


def leaf_checksum(arr: np.ndarray) -> int:
    """CRC32 of a leaf's raw bytes, computed from a zero-copy view.

    This is the single per-leaf CRC entry point for the save path: the
    streaming writer accepts the values it returns via ``crcs=`` and never
    recomputes them.
    """
    return zlib.crc32(as_byte_view(arr))


# ---------------------------------------------------------------------------
# v2: single-pass streaming writer
# ---------------------------------------------------------------------------

def write_shard_stream(fp: BinaryIO,
                       records: list[tuple[str, np.ndarray]],
                       meta: Optional[dict] = None,
                       *,
                       crcs: Optional[dict[str, int]] = None,
                       chunk_bytes: int = CHUNK_BYTES) -> dict:
    """Stream a v2 shard into ``fp`` in one pass; returns the footer dict.

    Each leaf is written directly from a ``memoryview`` — no per-leaf
    ``tobytes()`` copy and no whole-shard buffer.  If ``crcs`` maps a leaf
    path to a precomputed CRC32 it is trusted verbatim (the manager computes
    it once during the incremental diff); otherwise the CRC is folded in
    chunk-by-chunk as the bytes stream out, still a single pass.
    """
    fp.write(MAGIC2)
    offset = len(MAGIC2)
    tensors = []
    for name, arr in records:
        arr = np.asarray(arr)
        shape = list(arr.shape)          # before as_byte_view 0-d promotion
        view = as_byte_view(arr)
        nbytes = view.nbytes
        crc = None if crcs is None else crcs.get(name)
        if crc is None:
            crc = 0
            for start in range(0, nbytes, chunk_bytes):
                chunk = view[start:start + chunk_bytes]
                crc = zlib.crc32(chunk, crc)
                fp.write(chunk)
        else:
            for start in range(0, nbytes, chunk_bytes):
                fp.write(view[start:start + chunk_bytes])
        tensors.append({
            "path": name,
            "dtype": dtype_name(arr.dtype),
            "shape": shape,
            "offset": offset,            # ABSOLUTE file offset (v2)
            "nbytes": nbytes,
            "crc32": crc,
        })
        offset += nbytes
    footer = {"tensors": tensors, "meta": meta or {}, "format": 2}
    raw = json.dumps(footer).encode()
    fp.write(raw)
    fp.write(struct.pack("<Q", len(raw)))
    fp.write(MAGIC2)
    return footer


def write_shard_bytes_v2(records, meta=None, *, crcs=None) -> bytes:
    """v2 shard as one bytes object (tests/tools; the hot path streams)."""
    buf = io.BytesIO()
    write_shard_stream(buf, records, meta, crcs=crcs)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# v3: content-addressed chunking (the delta-checkpoint plane)
# ---------------------------------------------------------------------------

def chunk_hash(view) -> str:
    """Content hash naming one chunk in the dedup store.  blake2b at 16
    bytes: keyless, stdlib, ~3x faster than sha256 on large buffers, and 128
    bits is far past birthday-collision range for any real checkpoint volume
    (integrity is separately guaranteed by CRCs pinned in the manifest)."""
    return hashlib.blake2b(view, digest_size=16).hexdigest()


# -- CRC32 combining (GF(2) matrix shift, zlib's crc32_combine) ------------
#
# crc32(A+B) == apply(OP(len(B)), crc32(A)) ^ crc32(B) where OP(n) is the
# linear operator advancing a CRC register past n zero bytes.  zlib composes
# OP from log2(n) squarings PER CALL (~20k Python ops here) — slower than
# just re-CRCing a small chunk.  The delta plane folds per-chunk CRCs into a
# leaf CRC over a handful of DISTINCT lengths (chunk_bytes plus one tail per
# leaf), so the composed operator is cached per length and each fold costs
# one 32x32 GF(2) apply (~32 int ops), making the leaf CRC free of any
# second byte traversal.

_CRC32_POLY = 0xEDB88320


def _gf2_times_vec(mat: tuple, vec: int) -> int:
    out = 0
    i = 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _gf2_square(mat: tuple) -> tuple:
    return tuple(_gf2_times_vec(mat, mat[n]) for n in range(32))


@functools.lru_cache(maxsize=1024)
def _crc32_shift_operator(nbytes: int) -> tuple:
    """32x32 GF(2) matrix (columns as ints) advancing a CRC32 register past
    ``nbytes`` zero bytes.  Cached: chunked leaves fold over very few
    distinct lengths."""
    odd = (_CRC32_POLY,) + tuple(1 << (n - 1) for n in range(1, 32))  # 1 bit
    odd = _gf2_square(_gf2_square(odd))                               # 4 bits
    op = tuple(1 << n for n in range(32))                             # identity
    n = nbytes
    while n:
        odd = _gf2_square(odd)            # 8, 16, 32, ... zero bits
        if n & 1:
            op = tuple(_gf2_times_vec(odd, op[i]) for i in range(32))
        n >>= 1
    return op


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """``crc32(A+B)`` from ``crc32(A)``, ``crc32(B)`` and ``len(B)`` without
    touching any bytes (zlib's crc32_combine, with the shift operator cached
    per length)."""
    if len2 <= 0:
        return crc1
    return _gf2_times_vec(_crc32_shift_operator(len2), crc1) ^ crc2


def chunk_leaf(arr: np.ndarray, chunk_bytes: int = DELTA_CHUNK_BYTES):
    """Split one leaf into fixed-size content-addressed chunks.

    Returns ``(entries, views, leaf_crc32)``: per-chunk dicts
    ``{"hash","nbytes","crc32"}``, the matching zero-copy ``memoryview``s
    (aligned with ``entries``; valid while ``arr`` lives), and the whole-leaf
    CRC32 folded from the per-chunk CRCs via ``crc32_combine`` — so a delta
    save hashes, CRCs and diffs every leaf in ONE traversal of its bytes and
    the leaf CRC costs zero additional byte passes.
    """
    view = as_byte_view(np.asarray(arr))
    entries, views = [], []
    leaf_crc = 0
    for start in range(0, view.nbytes, chunk_bytes):
        part = view[start:start + chunk_bytes]
        crc = zlib.crc32(part)
        leaf_crc = crc32_combine(leaf_crc, crc, part.nbytes)
        entries.append({"hash": chunk_hash(part), "nbytes": part.nbytes,
                        "crc32": crc})
        views.append(part)
    return entries, views, leaf_crc


# -- per-chunk fingerprints (the dirty-chunk pre-filter) -------------------
#
# A 32-bit FNV-style mix per chunk, bit-identical across three impls: this
# vectorized numpy path (host bytes), kernels/ref.py::chunk_fingerprints
# (jnp oracle) and kernels/checksum.py::chunk_fingerprints_pallas (on-device,
# HBM bandwidth).  The fingerprint is a cheap PRE-FILTER in the CRIU
# soft-dirty sense: a chunk whose fingerprint matches the parent step's is
# treated as clean and skips blake2b; chunks it flags dirty are still named
# by their full content hash.  Correctness therefore never depends on the 32
# bits — a colliding dirty chunk (p ~ 2^-32 per chunk) is silently treated
# as clean, which is why fingerprint filtering is opt-in on the manager.

FP_PRIME = 16777619          # matches kernels PRIME (FNV-1 32-bit prime)


def fingerprint_chunks(data, chunk_bytes: int = DELTA_CHUNK_BYTES) -> np.ndarray:
    """uint32 fingerprint per fixed-size chunk of ``data`` (bytes-like or a
    byte view); the tail chunk is zero-padded so the value agrees with the
    device kernels on padded word streams.  Index mixing is chunk-LOCAL so a
    chunk's fingerprint is position-independent within the leaf."""
    if chunk_bytes < 4 or chunk_bytes % 4:
        raise ValueError(f"chunk_bytes must be a multiple of 4, got {chunk_bytes}")
    buf = np.frombuffer(data, dtype=np.uint8)
    n = buf.nbytes
    if n == 0:
        return np.zeros(0, np.uint32)
    nchunks = -(-n // chunk_bytes)
    if nchunks * chunk_bytes != n:
        padded = np.zeros(nchunks * chunk_bytes, np.uint8)
        padded[:n] = buf
        buf = padded
    words = buf.view("<u4").reshape(nchunks, chunk_bytes // 4)
    idx = np.arange(chunk_bytes // 4, dtype=np.uint32)
    mixed = (words ^ (idx * np.uint32(FP_PRIME))) * (idx | np.uint32(1))
    return np.bitwise_xor.reduce(mixed, axis=1) + mixed.sum(
        axis=1, dtype=np.uint32)


# -- parallel chunk hash/CRC engine ----------------------------------------

ENV_HASH_WORKERS = "REPRO_HASH_WORKERS"

# below this size the WorkPool handoff costs more than the digest itself
# (and neither blake2b nor crc32 releases the GIL for tiny buffers), so
# sub-threshold chunks are digested inline on the producer thread
INLINE_HASH_BYTES = 1 << 15


def auto_hash_workers(cap: Optional[int] = None) -> int:
    """Hash-engine pool sizing, mirroring restore_engine.auto_workers:
    ``REPRO_HASH_WORKERS`` wins outright when set to a positive integer;
    otherwise the CPU count (min 2, optionally capped).  A mangled override
    degrades to auto sizing with a logged warning — an operator typo must
    never kill a save (the parse contract lives in ``utils.env``)."""
    n = env_positive_int(ENV_HASH_WORKERS, logger=log)
    if n is not None:
        return n
    n = max(2, os.cpu_count() or 2)
    if cap:
        n = min(n, max(1, cap))
    return n


class ChunkHashEngine:
    """Multi-threaded chunk hash/CRC engine behind the ``chunk_leaf``
    contract.

    blake2b releases the GIL for updates past ~2 KB and zlib.crc32 past
    ~5 KB, so digesting many chunks on a small ``WorkPool`` (the same
    primitive the async writer and the promotion tee run on) scales with
    memory bandwidth instead of single-core hash speed.  Results are written
    into per-chunk slots, so entry order, hashes, per-chunk CRCs and the
    folded leaf CRC are byte-identical to the serial ``chunk_leaf`` path.

    The pool is created lazily on first use and only when ``workers > 1`` —
    a serial engine costs nothing beyond the function calls.
    """

    def __init__(self, workers: int = 0):
        self.workers = int(workers) if workers and int(workers) >= 1 \
            else auto_hash_workers()
        self._pool = None

    def _ensure_pool(self):
        if self.workers <= 1:
            return None
        if self._pool is None:
            from repro_torch.checkpoint.async_writer import WorkPool
            self._pool = WorkPool(max_inflight=4 * self.workers,
                                  workers=self.workers, name="ckpt-hash")
        return self._pool

    @staticmethod
    def _digest(part) -> tuple[str, int]:
        return chunk_hash(part), zlib.crc32(part)

    def chunk_leaf(self, arr: np.ndarray,
                   chunk_bytes: int = DELTA_CHUNK_BYTES):
        """Parallel drop-in for module-level ``chunk_leaf`` — identical
        ``(entries, views, leaf_crc32)``."""
        out, _ = self.chunk_records([("", np.asarray(arr))], chunk_bytes)
        return out[""]

    def digest_views(self, views) -> list[tuple[str, int]]:
        """``(blake2b hash, crc32)`` per byte view, all in flight at once on
        the pool (sub-threshold views digested inline, same policy as
        ``chunk_records``).  The device-resident delta path uses this for
        the DIRTY chunks it gathered — it has no per-leaf arrays to hand
        to ``chunk_records``, just the fetched slices."""
        slots: list = [None] * len(views)
        pool = self._ensure_pool()
        if pool is None:
            for i, v in enumerate(views):
                slots[i] = self._digest(v)
            return slots

        def task(i, part):
            slots[i] = self._digest(part)
        for i, v in enumerate(views):
            if v.nbytes < INLINE_HASH_BYTES:
                slots[i] = self._digest(v)
            else:
                pool.submit(functools.partial(task, i, v))
        pool.wait()
        return slots

    def chunk_records(self, items, chunk_bytes: int = DELTA_CHUNK_BYTES, *,
                      known: Optional[dict] = None,
                      fps: Optional[dict] = None):
        """Hash/CRC every chunk of every leaf with ALL chunks in flight at
        once (one ``wait()`` at the end — no per-leaf barrier).

        ``items``: [(name, np.ndarray)].  ``known`` optionally maps
        ``name -> {chunk_index: entry}`` of already-trusted entries (the
        fingerprint pre-filter / pre-dump state); a known entry is reused
        verbatim — no blake2b, no crc — after its ``nbytes`` is checked
        against the live chunk layout.  ``fps`` optionally maps ``name`` to
        a per-chunk uint32 array stamped into the entries as ``"fp"``.

        Returns ``({name: (entries, views, leaf_crc)}, stats)`` with stats
        counting ``chunks_hashed`` vs ``chunks_known``.
        """
        known = known or {}
        fps = fps or {}
        plans = []
        for name, arr in items:
            view = as_byte_view(np.asarray(arr))
            parts = [view[s:s + chunk_bytes]
                     for s in range(0, view.nbytes, chunk_bytes)]
            slots: list = [None] * len(parts)
            kmap = known.get(name) or {}
            todo = []
            for i, part in enumerate(parts):
                e = kmap.get(i)
                if e is not None and e.get("nbytes") == part.nbytes:
                    slots[i] = (e["hash"], e["crc32"])
                else:
                    todo.append(i)
            plans.append((name, parts, slots, todo))

        pool = self._ensure_pool()
        if pool is None:
            for _, parts, slots, todo in plans:
                for i in todo:
                    slots[i] = self._digest(parts[i])
        else:
            # distinct list indices per task: no lock needed on the slots
            def task(slots, i, part):
                slots[i] = self._digest(part)
            for _, parts, slots, todo in plans:
                for i in todo:
                    if parts[i].nbytes < INLINE_HASH_BYTES:
                        slots[i] = self._digest(parts[i])
                    else:
                        pool.submit(functools.partial(task, slots, i,
                                                      parts[i]))
            pool.wait()

        out = {}
        hashed = reused = 0
        for name, parts, slots, todo in plans:
            fp = fps.get(name)
            entries = []
            leaf_crc = 0
            for i, (part, (h, crc)) in enumerate(zip(parts, slots)):
                e = {"hash": h, "nbytes": part.nbytes, "crc32": crc}
                if fp is not None and i < len(fp):
                    e["fp"] = int(fp[i])
                entries.append(e)
                leaf_crc = crc32_combine(leaf_crc, crc, part.nbytes)
            hashed += len(todo)
            reused += len(parts) - len(todo)
            out[name] = (entries, parts, leaf_crc)
        stats = {"chunks_hashed": hashed, "chunks_known": reused,
                 "hash_workers": self.workers if pool is not None else 1}
        return out, stats

    def close(self) -> None:
        if self._pool is not None:
            self._pool.close()
            self._pool = None


def write_chunk_index(fp: BinaryIO, tensors: list[dict],
                      meta: Optional[dict] = None, *,
                      chunk_bytes: int = DELTA_CHUNK_BYTES) -> dict:
    """Write a payload-free v3 chunk-index file: trailer-delimited JSON
    mapping leaves -> chunk lists.  ``tensors`` entries must carry
    ``path/dtype/shape/nbytes/crc32/chunks``.  Parses back through
    ``read_shard_header`` (``format == 3``) like any other shard."""
    index = {"tensors": tensors, "meta": meta or {}, "format": 3,
             "chunk_bytes": chunk_bytes}
    raw = json.dumps(index).encode()
    fp.write(MAGIC3)
    fp.write(raw)
    fp.write(struct.pack("<Q", len(raw)))
    fp.write(MAGIC3)
    return index


def write_chunk_index_bytes(tensors, meta=None, *,
                            chunk_bytes: int = DELTA_CHUNK_BYTES) -> bytes:
    buf = io.BytesIO()
    write_chunk_index(buf, tensors, meta, chunk_bytes=chunk_bytes)
    return buf.getvalue()


def assemble_leaf(t: dict, chunk_bytes_list: list[bytes], *,
                  verify: bool = True) -> np.ndarray:
    """Materialize one chunked tensor entry from its chunk payloads (in
    chunk-list order).  Verifies each chunk's CRC and the whole-leaf CRC, so
    the result is byte-identical to a full-shard restore or the read fails."""
    buf = np.empty(t["nbytes"], dtype=np.uint8)
    out = memoryview(buf)
    off = 0
    leaf_crc = 0
    for c, raw in zip(t["chunks"], chunk_bytes_list):
        if verify and zlib.crc32(raw) != c["crc32"]:
            raise ChecksumError(
                f"crc mismatch for chunk {c['hash']} of {t['path']}")
        out[off:off + c["nbytes"]] = raw
        leaf_crc = zlib.crc32(raw, leaf_crc)
        off += c["nbytes"]
    if off != t["nbytes"]:
        raise ChecksumError(f"chunk bytes {off}/{t['nbytes']} for {t['path']}")
    if verify and t.get("crc32") is not None and leaf_crc != t["crc32"]:
        raise ChecksumError(f"leaf crc mismatch for {t['path']}")
    return buf.view(np_dtype(t["dtype"])).reshape(t["shape"])


def read_chunked_leaves(header: dict, fetch_chunk, *,
                        paths: Optional[list[str]] = None,
                        verify: bool = True):
    """Materialize leaves of a v3 index given ``fetch_chunk(chunk_entry) ->
    bytes`` (the store/engine resolves a hash to whichever tier holds it).
    Returns ({path: np.ndarray}, meta) like ``read_shard_leaves``."""
    index = {t["path"]: t for t in header["tensors"]}
    want = list(index) if paths is None else paths
    missing = [p for p in want if p not in index]
    if missing:
        raise KeyError(f"leaves not in chunk index: {missing}")
    out = {}
    for p in want:
        t = index[p]
        out[p] = assemble_leaf(t, [fetch_chunk(c) for c in t["chunks"]],
                               verify=verify)
    return out, header["meta"]


# ---------------------------------------------------------------------------
# v1: legacy writer (kept verbatim so read-compat fixtures and the benchmark
# baseline exercise the true seed byte layout)
# ---------------------------------------------------------------------------

def write_shard_bytes(records: list[tuple[str, np.ndarray]],
                      meta: Optional[dict] = None) -> bytes:
    tensors = []
    blobs = []
    offset = 0
    for name, arr in records:
        arr = np.asarray(arr)
        shape = list(arr.shape)          # before ascontiguousarray (it is >=1-d)
        arr = np.ascontiguousarray(arr)
        raw = arr.tobytes()
        tensors.append({
            "path": name,
            "dtype": dtype_name(arr.dtype),
            "shape": shape,
            "offset": offset,
            "nbytes": len(raw),
            "crc32": zlib.crc32(raw),
        })
        blobs.append(raw)
        offset += len(raw)
    header = json.dumps({"tensors": tensors, "meta": meta or {}}).encode()
    buf = io.BytesIO()
    buf.write(MAGIC)
    buf.write(struct.pack("<I", len(header)))
    buf.write(header)
    for raw in blobs:
        buf.write(raw)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# readers: ranged (header + per-leaf) and whole-buffer, both formats
# ---------------------------------------------------------------------------

ReadAt = Callable[[int, int], bytes]     # (offset, nbytes) -> bytes

# One tail read this large usually captures trailer + footer together, so a
# v2 header costs ONE ranged read instead of three (magic, trailer, footer).
# Per-op latency dominates header fetches on the shared tier and the peer
# fabric, so the restore planner's per-shard cost drops ~3x with this hint.
HEADER_TAIL_HINT = 4096


def read_shard_header(read_at: ReadAt, size: int, *,
                      tail_hint: int = HEADER_TAIL_HINT) -> dict:
    """Parse the tensor index of a shard using only ranged reads.

    ``read_at(offset, nbytes)`` is any positioned-read primitive (pread/mmap
    slice/HTTP range).  Returns the header dict with every tensor ``offset``
    normalized to an ABSOLUTE file offset regardless of format, so callers can
    ranged-read leaves uniformly.

    v2 fast path: one ``tail_hint``-byte read from the end of the file grabs
    the trailer and (almost always) the whole footer; only a footer larger
    than the hint costs a second read.  v1 keeps the magic-first probe.
    """
    if size >= 8 + TRAILER_LEN:
        tail_n = min(size, max(tail_hint, TRAILER_LEN))
        tail = bytes(read_at(size - tail_n, tail_n))
        if tail[-8:] in (MAGIC2, MAGIC3):
            try:
                (flen,) = struct.unpack("<Q", tail[-TRAILER_LEN:-8])
                if flen > size - 8 - TRAILER_LEN:
                    raise ValueError("bad checkpoint footer length")
                if flen + TRAILER_LEN <= tail_n:
                    raw = tail[tail_n - TRAILER_LEN - flen:
                               tail_n - TRAILER_LEN]
                else:
                    raw = bytes(read_at(size - TRAILER_LEN - flen, flen))
                return json.loads(raw.decode())
            except (ValueError, UnicodeDecodeError, struct.error):
                # a v1 shard whose last payload bytes collide with MAGIC2/3
                # must still parse — the leading magic below disambiguates
                # (and a genuinely damaged v2/v3 still errors there)
                pass
    magic = bytes(read_at(0, 8))
    if magic in (MAGIC2, MAGIC3):
        if size < 8 + TRAILER_LEN:
            raise ValueError("truncated checkpoint shard")
        raise ValueError("bad checkpoint shard trailer")
    if magic == MAGIC:
        (hlen,) = struct.unpack("<I", bytes(read_at(8, 4)))
        header = json.loads(bytes(read_at(12, hlen)).decode())
        base = 12 + hlen                 # v1 offsets are data-relative
        for t in header["tensors"]:
            t["offset"] += base
        header["format"] = 1
        return header
    raise ValueError("bad checkpoint shard magic")


def leaf_from_bytes(t: dict, raw, *, verify: bool = True) -> np.ndarray:
    """Materialize one tensor from its header entry + raw payload bytes."""
    if verify and zlib.crc32(raw) != t["crc32"]:
        raise ChecksumError(f"crc mismatch for tensor {t['path']}")
    return np.frombuffer(raw, dtype=np_dtype(t["dtype"])).reshape(t["shape"])


def select_leaves(header: dict, paths: Optional[list[str]]) -> list[dict]:
    """Header entries for the requested ``paths`` (all when ``None``), sorted
    by file offset.  Raises ``KeyError`` on a leaf the shard doesn't hold —
    a stale replica must fall back like any damaged one."""
    want = header["tensors"]
    if paths is None:
        return sorted(want, key=lambda t: t["offset"])
    index = {t["path"]: t for t in want}
    missing = [p for p in paths if p not in index]
    if missing:
        raise KeyError(f"leaves not in shard: {missing}")
    return sorted((index[p] for p in set(paths)), key=lambda t: t["offset"])


def coalesce_runs(want: list[dict], *,
                  max_run_bytes: Optional[int] = None) -> list[list[dict]]:
    """Group offset-sorted leaf entries into contiguous runs, each servable
    by ONE ranged read.  ``max_run_bytes`` additionally splits a run at leaf
    boundaries once it grows past the cap — how the parallel restore engine
    turns one large shard into several same-sized range tasks (a single
    oversized leaf still stays whole: CRC verification needs its full bytes).
    """
    runs: list[list[dict]] = []
    cur: list[dict] = []
    cur_bytes = 0
    for t in want:
        contiguous = cur and t["offset"] == cur[-1]["offset"] + cur[-1]["nbytes"]
        fits = max_run_bytes is None or not cur or cur_bytes + t["nbytes"] <= max_run_bytes
        if not (contiguous and fits):
            if cur:
                runs.append(cur)
            cur, cur_bytes = [], 0
        cur.append(t)
        cur_bytes += t["nbytes"]
    if cur:
        runs.append(cur)
    return runs


def read_run(read_at: ReadAt, run: list[dict], out: dict, *,
             verify: bool = True) -> int:
    """Fetch one coalesced run with a single ranged read and materialize its
    leaves into ``out`` (zero-copy: leaves alias the run buffer, read-only).
    Returns the number of bytes read."""
    start = run[0]["offset"]
    nbytes = run[-1]["offset"] + run[-1]["nbytes"] - start
    buf = memoryview(read_at(start, nbytes))
    for t in run:
        raw = buf[t["offset"] - start : t["offset"] - start + t["nbytes"]]
        out[t["path"]] = leaf_from_bytes(t, raw, verify=verify)
    return nbytes


def read_shard_leaves(read_at: ReadAt, size: int,
                      paths: Optional[list[str]] = None, *,
                      verify: bool = True,
                      header: Optional[dict] = None):
    """Ranged read of selected leaves.  Returns ({path: np.ndarray}, meta).

    ``paths=None`` reads every leaf.  Requested leaves that are adjacent in
    the file are fetched with one coalesced read.  Works on both formats
    (``read_shard_header`` normalizes offsets).
    """
    header = header or read_shard_header(read_at, size)
    if header.get("format") == 3:
        # a v3 index has no payload to range-read; its chunks resolve through
        # the store's chunk plane (read_chunked_leaves / restore_chunked)
        raise ValueError("v3 chunk index holds no payload; use the chunk plane")
    want = select_leaves(header, paths)
    out: dict = {}
    for run in coalesce_runs(want):
        read_run(read_at, run, out, verify=verify)
    return out, header["meta"]


def read_shard_bytes(data: bytes, *, verify: bool = True):
    """Whole-buffer parse (v1 or v2).  Returns ({path: np.ndarray}, meta)."""
    def read_at(off: int, n: int) -> bytes:
        if off + n > len(data):
            raise ValueError("truncated checkpoint shard")
        return data[off : off + n]
    return read_shard_leaves(read_at, len(data), None, verify=verify)


# ---------------------------------------------------------------------------
# pytree + file conveniences
# ---------------------------------------------------------------------------

# bfloat16 has no numpy dtype unless ml_dtypes is loaded, and the machines
# this package runs on need not have it.  Host-side, a bfloat16 leaf is its
# raw 2-byte payload in BF16, a one-field structured dtype; on disk its dtype
# string is "bfloat16", the name numpy gives the type where ml_dtypes is
# loaded, so shards and manifests match the reference package byte for byte.
BF16 = np.dtype([("bfloat16", "<u2")])


def dtype_name(dt) -> str:
    """The dtype string written into headers and manifests: numpy's name of
    the type, for a numpy dtype or a torch one ("float32", "bfloat16",
    "bool", "int32"), as the reference package writes it."""
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    return "bfloat16" if dt == BF16 else str(dt)


def np_dtype(name: str) -> np.dtype:
    """The host dtype a header's dtype string reads back as."""
    return BF16 if name == "bfloat16" else np.dtype(name)


def host_array(leaf) -> np.ndarray:
    """A tree leaf as a host numpy array: a torch tensor is copied off its
    device (bfloat16 as BF16); anything else goes through ``np.asarray``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(BF16)
        return t.numpy()
    return np.asarray(leaf)


def to_torch(arr, device="cpu") -> torch.Tensor:
    """A host array (as ``host_array`` or a restore gives it) as a torch
    tensor on ``device``; BF16 and numpy's own bfloat16 become
    torch.bfloat16 through a 16-bit view of the same bytes."""
    arr = np.asarray(arr)
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = arr.copy()
    if arr.dtype == BF16 or str(arr.dtype) == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def tree_to_records(tree) -> list[tuple[str, np.ndarray]]:
    return [(name, host_array(leaf)) for name, leaf in flatten_with_names(tree)]


def write_shard(path: Path, records, meta=None) -> dict:
    """Stream a v2 shard to ``path`` atomically (tmp + rename)."""
    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as fp:
        footer = write_shard_stream(fp, records, meta)
        nbytes = fp.tell()
    tmp.rename(path)
    return {"nbytes": nbytes, "tensors": footer["tensors"]}


def read_shard(path: Path, *, verify: bool = True):
    return read_shard_bytes(Path(path).read_bytes(), verify=verify)


def restore_tree(template, named: dict[str, np.ndarray]):
    """Rebuild a pytree shaped like ``template`` from {path: array}."""
    return unflatten_like(template, named)
