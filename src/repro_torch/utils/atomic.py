"""Atomic single-file publish helpers (mkstemp + ``os.replace``).

One hardened implementation of the write-tmp-then-rename idiom, shared by
every small-record publisher in the tree: the cache registry's inventory
entries, the requeue accounting file, and the I/O calibration cache.  The
tmp name is UNIQUE (``mkstemp`` in the target's own directory): a fixed
``<name>.tmp`` path would let two concurrent writers of the same key
interleave write/rename — one renames the other's half-written tmp,
publishing a file that parses but mixes two records.  ``mkstemp`` keeps
the rename same-filesystem (hence atomic), and each writer renames only
bytes it wrote in full.  The tmp is unlinked on any failure, so aborted
writes leave no litter behind.
"""
from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path


def atomic_write_bytes(path, data: bytes) -> None:
    """Atomically publish ``data`` at ``path`` (unique tmp + ``os.replace``)."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=p.name + ".", suffix=".tmp",
                               dir=p.parent)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, p)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_json(path, obj) -> None:
    """Atomically publish ``obj`` as JSON at ``path``."""
    atomic_write_bytes(path, json.dumps(obj).encode())
