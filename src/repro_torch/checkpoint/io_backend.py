"""Batched ranged-read backend: vectored submission, direct I/O, capability
probes.

The restore engine plans whole checkpoints as lists of ``(path, offset,
nbytes)`` descriptors; this module drains such a batch with as few syscalls
and as little kernel-side copying as the host allows:

* **preadv** — per-file descriptor groups are submitted as ONE vectored
  positional read (``os.preadv``), so a plan's coalesced runs against one
  shard cost one syscall instead of one per range.
* **O_DIRECT** — for tiers backed by a real (cold/shared) filesystem the
  reader can bypass the page cache: offsets/lengths are aligned down/up to
  the probed alignment and the destination buffers are page-aligned
  ``mmap`` allocations, as O_DIRECT requires.  Fixed-size chunks mean the
  alignment waste is a few hundred bytes per range, not a re-read.  The
  probe is per-directory and cached: filesystems that reject O_DIRECT
  (older tmpfs, some overlayfs) degrade to buffered reads, never error.
* **io_uring** — probed, not required: when a liburing shared object is
  present AND ``REPRO_IO_URING=1`` opts in, the submission loop could ride
  a real ring; this container has no liburing, so the probe reports
  unavailable and the preadv path serves.  The probe exists so the backend
  choice is a measured capability, not a build flag.
* **thread fallback** — hosts without ``os.preadv`` (non-POSIX) drain the
  batch with per-range ``pread``-style reads; same results, more syscalls.

Results are positional: ``read_ranges`` returns one ``bytes`` per request,
with failures returned as ``Exception`` instances (not raised), so a caller
holding a multi-source fallback chain can retry exactly the ranges that
failed instead of resubmitting the batch.
"""
from __future__ import annotations

import ctypes.util
import dataclasses
import logging
import mmap
import os
import threading
from pathlib import Path
from typing import Optional

log = logging.getLogger(__name__)

ENV_IO_URING = "REPRO_IO_URING"

HAVE_PREADV = hasattr(os, "preadv")
# Linux caps a single readv/preadv submission at IOV_MAX iovecs
IOV_MAX = 1024
_PAGE = mmap.PAGESIZE


@dataclasses.dataclass(frozen=True)
class IOCapabilities:
    """What the probed filesystem/host actually supports."""
    preadv: bool
    direct_io: bool
    alignment: int          # O_DIRECT offset/length/buffer alignment (bytes)
    io_uring: bool


def io_uring_available() -> bool:
    """True only when a liburing shared object is loadable AND the operator
    opted in via ``REPRO_IO_URING=1``.  Opt-in because the binding is the
    least-traveled path; the preadv backend is the default everywhere."""
    if os.environ.get(ENV_IO_URING, "").strip() != "1":
        return False
    return ctypes.util.find_library("uring") is not None


# -- O_DIRECT probe ---------------------------------------------------------

_DIRECT_CACHE: dict[str, Optional[int]] = {}
_DIRECT_LOCK = threading.Lock()


def probe_direct_io(directory) -> Optional[int]:
    """O_DIRECT alignment for files under ``directory``, or ``None`` when
    the filesystem rejects direct I/O (tmpfs on older kernels, overlayfs).

    Probed once per directory with a scratch file and cached — the probe is
    a filesystem property, not a file property.  The returned alignment is
    the logical block size when discoverable, else one page (always a legal
    O_DIRECT alignment on Linux)."""
    if not hasattr(os, "O_DIRECT") or not HAVE_PREADV:
        return None
    key = str(Path(directory))
    with _DIRECT_LOCK:
        if key in _DIRECT_CACHE:
            return _DIRECT_CACHE[key]
    align: Optional[int] = None
    probe = Path(directory) / f".directio_probe.{os.getpid()}"
    try:
        with open(probe, "wb") as f:
            f.write(b"\0" * _PAGE)
        fd = os.open(probe, os.O_RDONLY | os.O_DIRECT)
        try:
            buf = mmap.mmap(-1, _PAGE)
            try:
                if os.preadv(fd, [buf], 0) == _PAGE:
                    try:
                        align = os.statvfs(probe).f_bsize or _PAGE
                    except OSError:
                        align = _PAGE
                    align = max(512, min(int(align), _PAGE * 16))
            finally:
                buf.close()
        finally:
            os.close(fd)
    except OSError:
        align = None
    finally:
        try:
            probe.unlink()
        except OSError:
            pass
    with _DIRECT_LOCK:
        _DIRECT_CACHE[key] = align
    return align


def reset_direct_io_cache() -> None:
    """Test hook: forget probe results (e.g. after monkeypatching os.open)."""
    with _DIRECT_LOCK:
        _DIRECT_CACHE.clear()


def capabilities(directory) -> IOCapabilities:
    align = probe_direct_io(directory)
    return IOCapabilities(preadv=HAVE_PREADV,
                          direct_io=align is not None,
                          alignment=align or 0,
                          io_uring=io_uring_available())


# -- batched submission -----------------------------------------------------

def _group_by_file(requests):
    """Coalesce a batch per file, preserving request order inside each group.
    Returns ``[(path, [(orig_index, offset, nbytes)...])...]``."""
    groups: dict[str, list] = {}
    paths: dict[str, Path] = {}
    for i, (path, offset, nbytes) in enumerate(requests):
        key = str(path)
        paths.setdefault(key, Path(path))
        groups.setdefault(key, []).append((i, offset, nbytes))
    return [(paths[k], v) for k, v in groups.items()]


def _drain_preadv(fd: int, reqs: list, results: list) -> None:
    """One (or a few, IOV_MAX-capped) vectored submissions for all ranges of
    one file.  Short reads surface as OSError in that range's slot only."""
    for start in range(0, len(reqs), IOV_MAX):
        window = reqs[start:start + IOV_MAX]
        bufs = [bytearray(n) for _, _, n in window]
        # one submission per contiguous offset run; ranges at arbitrary
        # offsets each need their own preadv position, so split the window
        # wherever the file offset jumps
        j = 0
        while j < len(window):
            k = j
            pos = window[j][1]
            end = pos
            while (k < len(window) and window[k][1] == end):
                end += window[k][2]
                k += 1
            got = os.preadv(fd, bufs[j:k], pos)
            want = end - pos
            if got != want:
                # a short vectored read torn across ranges: mark each range
                # in this submission by how many of its bytes arrived
                seen = got
                for idx in range(j, k):
                    i, _, n = window[idx]
                    if seen >= n:
                        results[i] = bytes(bufs[idx])
                        seen -= n
                    else:
                        results[i] = OSError(
                            f"short read {max(seen, 0)}/{n} at "
                            f"offset {window[idx][1]}")
                        seen = 0
            else:
                for idx in range(j, k):
                    results[window[idx][0]] = bytes(bufs[idx])
            j = k


def _drain_direct(path: Path, reqs: list, results: list,
                  align: int) -> None:
    """O_DIRECT drain for one file: offsets aligned down, lengths aligned
    up, destination buffers page-aligned (anonymous mmap satisfies any
    sub-page alignment).  Reads past EOF are clamped by the kernel; the
    caller's short-read check stays with the caller."""
    fd = os.open(path, os.O_RDONLY | os.O_DIRECT)
    try:
        size = os.fstat(fd).st_size
        for i, offset, nbytes in reqs:
            lo = (offset // align) * align
            hi = -(-(offset + nbytes) // align) * align
            span = hi - lo
            # mmap length must be page-rounded; the extra tail is unused
            buf = mmap.mmap(-1, -(-span // _PAGE) * _PAGE)
            try:
                view = memoryview(buf)[:span]
                got = os.preadv(fd, [view], lo)
                # bytes of the REQUESTED range that actually arrived: the
                # aligned read starts at lo, so the first (offset - lo)
                # bytes are alignment padding, and EOF clamps the tail
                avail = max(0, min(got, size - lo) - (offset - lo))
                take = min(nbytes, avail)
                results[i] = bytes(view[offset - lo:offset - lo + take])
                del view
            finally:
                buf.close()
    finally:
        os.close(fd)


def _drain_seek_read(path: Path, reqs: list, results: list) -> None:
    """Portable fallback: one buffered handle, seek+read per range."""
    with open(path, "rb") as fp:
        for i, offset, nbytes in reqs:
            fp.seek(offset)
            results[i] = fp.read(nbytes)


def read_ranges(requests, *, direct_align: Optional[int] = None,
                open_fd=None, close_fd=None):
    """Drain one batch of ``(path, offset, nbytes)`` requests.

    Returns a list aligned with ``requests``: ``bytes`` per success (short
    reads included — length checking is the caller's contract, matching
    ``TieredStore._pread``), or the ``Exception`` per failed range.

    ``direct_align``: when set, files are read O_DIRECT at that alignment
    (the caller probed it for this batch's tier root); an O_DIRECT open
    failing mid-batch degrades to buffered for that file.  ``open_fd`` /
    ``close_fd``: optional hooks to source buffered descriptors from a
    cache (the store lends its refcounted fd cache) instead of open/close
    per file."""
    requests = list(requests)
    results: list = [None] * len(requests)
    for path, reqs in _group_by_file(requests):
        try:
            if direct_align:
                try:
                    _drain_direct(path, reqs, results, direct_align)
                    continue
                except OSError as e:
                    log.debug("O_DIRECT read of %s failed (%s); "
                              "falling back to buffered", path, e)
            if HAVE_PREADV:
                if open_fd is not None:
                    handle = open_fd(path)
                    try:
                        _drain_preadv(handle[0], reqs, results)
                    finally:
                        if close_fd is not None:
                            close_fd(path, handle)
                else:
                    fd = os.open(path, os.O_RDONLY)
                    try:
                        _drain_preadv(fd, reqs, results)
                    finally:
                        os.close(fd)
            else:                       # pragma: no cover - non-POSIX hosts
                _drain_seek_read(path, reqs, results)
        except OSError as e:
            for i, _, _ in reqs:
                if results[i] is None:
                    results[i] = e
    return results
