"""Signal trapping — the paper's ``func_trap`` / Slurm ``--signal`` handling.

Slurm sends SIGTERM (or a user-chosen USR1) ahead of the walltime limit; the
paper's script traps it, checkpoints, and requeues.  ``SignalTrap`` installs
handlers that only set flags — the training loop reads them at step boundaries
(async-signal-safe by construction: no device calls in handler context).

A job script traps from its first lines (``record_early``, before it imports
torch): a warning that lands during start-up is recorded, and the
``SignalTrap`` installed later takes it over, so it becomes a checkpoint at
the first step boundary instead of the default action, which kills the
process.  This module imports only the standard library for that reason.
"""
from __future__ import annotations

import signal
import sys
import threading
from typing import Iterable, Optional

SIGNALS = (signal.SIGTERM, signal.SIGUSR1)


class SignalRecorder:
    """A handler that only records the last signal it got (and whether torch
    had finished importing by then); it takes no other action, so a signal
    it handles neither kills nor interrupts the process."""

    def __init__(self):
        self.received: Optional[int] = None
        self.before_torch: Optional[bool] = None

    def __call__(self, signum, frame) -> None:
        self.received = signum
        torch = sys.modules.get("torch")      # there from the start of its import
        self.before_torch = torch is None or bool(
            getattr(getattr(torch, "__spec__", None), "_initializing", False))


def record_early(signals: Iterable[int] = SIGNALS) -> SignalRecorder:
    """Install one ``SignalRecorder`` for ``signals`` and return it."""
    rec = SignalRecorder()
    for s in signals:
        signal.signal(s, rec)
    return rec


class SignalTrap:
    def __init__(self, signals: Iterable[int] = SIGNALS):
        self.signals = tuple(signals)
        self._event = threading.Event()
        self.received: Optional[int] = None
        # a signal a ``SignalRecorder`` got before this trap was installed
        # (``received`` and ``triggered`` say so too): (signum, before_torch)
        self.early: Optional[tuple] = None
        self._prev: dict[int, object] = {}

    def __enter__(self) -> "SignalTrap":
        for s in self.signals:
            prev = self._prev[s] = signal.signal(s, self._handler)
            if isinstance(prev, SignalRecorder) and prev.received is not None:
                self.early = (prev.received, prev.before_torch)
                self._handler(prev.received, None)
                prev.received = prev.before_torch = None
        return self

    def __exit__(self, *exc) -> None:
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()

    def _handler(self, signum, frame) -> None:
        self.received = signum
        self._event.set()

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def reset(self) -> None:
        self._event.clear()
        self.received = None
