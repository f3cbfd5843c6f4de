"""Signal trapping — the paper's ``func_trap`` / Slurm ``--signal`` handling.

Slurm sends SIGTERM (or a user-chosen USR1) ahead of the walltime limit; the
paper's script traps it, checkpoints, and requeues.  ``SignalTrap`` installs
handlers that only set flags — the training loop reads them at step boundaries
(async-signal-safe by construction: no device calls in handler context).
"""
from __future__ import annotations

import signal
import threading
from typing import Iterable, Optional


class SignalTrap:
    def __init__(self, signals: Iterable[int] = (signal.SIGTERM, signal.SIGUSR1)):
        self.signals = tuple(signals)
        self._event = threading.Event()
        self.received: Optional[int] = None
        self._prev: dict[int, object] = {}

    def __enter__(self) -> "SignalTrap":
        for s in self.signals:
            self._prev[s] = signal.signal(s, self._handler)
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
