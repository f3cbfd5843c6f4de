"""Shared env-knob parsing.

Three runtime knobs follow the same contract — ``REPRO_RESTORE_WORKERS``,
``REPRO_HASH_WORKERS`` and ``REPRO_IO_BATCH``: a positive-integer value wins
outright; anything mangled (non-integer, zero, negative) degrades to the
caller's auto sizing with a logged warning.  An operator typo in a job
script must never turn into a ``ValueError`` at restore time, which is
exactly when the job can least afford to die.  This helper is the single
implementation of that parse; the knobs themselves live next to the code
they size.
"""
from __future__ import annotations

import logging
import os
from typing import Optional

log = logging.getLogger(__name__)


def env_positive_int(name: str, *,
                     logger: Optional[logging.Logger] = None) -> Optional[int]:
    """Parse ``$name`` as a positive integer.  Returns the value when valid,
    ``None`` when unset/empty, and ``None`` WITH a logged warning when set
    but mangled — the caller falls back to its auto sizing either way."""
    env = os.environ.get(name, "").strip()
    if not env:
        return None
    try:
        n = int(env)
    except ValueError:
        n = None
    if n is not None and n >= 1:
        return n
    (logger or log).warning(
        "ignoring invalid %s=%r (want a positive integer); "
        "falling back to auto sizing", name, env)
    return None
