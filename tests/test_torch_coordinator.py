"""The port's checkpoint coordinator: two-phase commit, straggler timeout,
worker-death abort, EXIT_REQ propagation and the interval trigger, with
workers as real threads over real TCP sockets (the reference's scenarios).
Both packages speak the same length-prefixed JSON, so a round also passes
with the reference's workers under the port's coordinator, and the reverse."""
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.checkpoint.manager import CheckpointManager as RefManager
from repro.checkpoint.store import TieredStore as RefStore
from repro.core.coordinator import CheckpointCoordinator as RefCoordinator
from repro.core.worker import CkptClient as RefClient
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.checkpoint.store import TieredStore
from repro_torch.core.coordinator import CheckpointCoordinator
from repro_torch.core.worker import CkptClient

PORT = (CheckpointCoordinator, CkptClient, CheckpointManager, TieredStore)
REF = (RefCoordinator, RefClient, RefManager, RefStore)


class WorkerThread(threading.Thread):
    """Tiny 'training loop': counts steps, services checkpoint rounds."""

    def __init__(self, host, port, wid, root, num_workers, *, save_delay=0.0,
                 die_during_save=False, steps=400, package=PORT):
        super().__init__(daemon=True)
        _, client_cls, mgr_cls, store_cls = package
        self.client = client_cls(host, port, wid)
        self.mgr = mgr_cls(store_cls(root), worker_id=wid, num_workers=num_workers)
        self.save_delay = save_delay
        self.die_during_save = die_during_save
        self.steps = steps
        self.state = {"w": np.arange(10, dtype=np.float32) * (wid + 1)}
        self.serviced = []
        self.error = None

    def run(self):
        try:
            for step in range(self.steps):
                time.sleep(0.003)  # "train"
                if self.client.exit_requested:
                    return

                def save(label):
                    if self.die_during_save:
                        self.client.close()          # simulated node death
                        raise RuntimeError("node died")
                    time.sleep(self.save_delay)
                    return self.mgr.save(label, self.state)

                out = self.client.service(step, save)
                if out is not None:
                    self.serviced.append(out)
        except Exception as e:  # noqa: BLE001
            self.error = e


def _mk(root, n, straggler_timeout=15.0, package=PORT, **kw):
    coord_cls, _, mgr_cls, store_cls = package
    mgr0 = mgr_cls(store_cls(root), worker_id=0, num_workers=n)
    return coord_cls(expected_workers=n, straggler_timeout=straggler_timeout,
                     commit_fn=mgr0.commit, **kw)


def _steps(root, n):
    return CheckpointManager(TieredStore(root), num_workers=n).steps()


def test_two_phase_commit_happy_path(tmp_path):
    n = 3
    coord = _mk(tmp_path, n)
    workers = [WorkerThread(coord.host, coord.port, w, tmp_path, n) for w in range(n)]
    for w in workers:
        w.start()
    coord.wait_for_workers(n)
    rec = coord.trigger_checkpoint(step=7, reason="test")
    assert rec["ok"], rec
    time.sleep(0.2)
    mgr = CheckpointManager(TieredStore(tmp_path), num_workers=n)
    out, man = mgr.restore({"w": np.zeros(10, np.float32)})
    assert man["step"] == 7 and man["num_workers"] == n
    np.testing.assert_array_equal(out["w"], np.arange(10, dtype=np.float32))
    coord.request_exit("done")
    for w in workers:
        w.join(timeout=10)
        assert w.error is None
        assert [o["type"] for o in w.serviced] == ["COMMIT"]
    coord.close()


def test_straggler_timeout_aborts(tmp_path):
    n = 2
    coord = _mk(tmp_path, n, straggler_timeout=0.5)
    w0 = WorkerThread(coord.host, coord.port, 0, tmp_path, n)
    w1 = WorkerThread(coord.host, coord.port, 1, tmp_path, n, save_delay=5.0)
    w0.start(); w1.start()
    coord.wait_for_workers(n)
    rec = coord.trigger_checkpoint(step=3)
    assert not rec["ok"] and "barrier failed" in rec["error"]
    # no manifest may exist: an abort leaves the previous checkpoint authoritative
    assert _steps(tmp_path, n) == []
    coord.request_exit("done")
    w0.join(timeout=10); w1.join(timeout=10)
    coord.close()


def test_worker_death_aborts_round(tmp_path):
    n = 2
    coord = _mk(tmp_path, n)
    w0 = WorkerThread(coord.host, coord.port, 0, tmp_path, n)
    w1 = WorkerThread(coord.host, coord.port, 1, tmp_path, n, die_during_save=True)
    w0.start(); w1.start()
    coord.wait_for_workers(n)
    rec = coord.trigger_checkpoint(step=4)
    assert not rec["ok"]
    assert _steps(tmp_path, n) == []
    coord.request_exit("done")
    w0.join(timeout=10)
    coord.close()


def test_exit_request_propagates(tmp_path):
    n = 2
    coord = _mk(tmp_path, n)
    workers = [WorkerThread(coord.host, coord.port, w, tmp_path, n, steps=10_000)
               for w in range(n)]
    for w in workers:
        w.start()
    coord.wait_for_workers(n)
    coord.request_exit("preemption")
    for w in workers:
        w.join(timeout=10)
        assert not w.is_alive()
        assert w.client.exit_reason == "preemption"
    coord.close()


def test_interval_trigger(tmp_path):
    n = 1
    coord = _mk(tmp_path, n, straggler_timeout=10, interval_s=0.4)
    w = WorkerThread(coord.host, coord.port, 0, tmp_path, n, steps=10_000)
    w.start()
    coord.wait_for_workers(1)
    time.sleep(1.5)
    coord.request_exit("done")
    w.join(timeout=10)
    ok_rounds = [h for h in coord.history if h.get("ok")]
    assert len(ok_rounds) >= 2, coord.history
    assert _steps(tmp_path, n)[-1] == ok_rounds[-1]["step"]
    coord.close()


@pytest.mark.parametrize("coordinator,workers", [(PORT, REF), (REF, PORT)],
                         ids=["port-coordinator-reference-workers",
                              "reference-coordinator-port-workers"])
def test_round_across_packages(tmp_path, coordinator, workers):
    """One package's coordinator commits a round of the other's workers; the
    checkpoint restores in both packages."""
    n = 2
    coord = _mk(tmp_path, n, package=coordinator)
    threads = [WorkerThread(coord.host, coord.port, w, tmp_path, n, package=workers)
               for w in range(n)]
    for t in threads:
        t.start()
    coord.wait_for_workers(n)
    rec = coord.trigger_checkpoint(step=5, reason="cross")
    assert rec["ok"], rec
    coord.request_exit("done")
    for t in threads:
        t.join(timeout=10)
        assert t.error is None
        assert t.client.exit_reason == "done"
        assert [o["type"] for o in t.serviced] == ["COMMIT"]
    coord.close()
    for mgr in (CheckpointManager(TieredStore(tmp_path), num_workers=n),
                RefManager(RefStore(tmp_path), num_workers=n)):
        out, man = mgr.restore({"w": np.zeros(10, np.float32)})
        assert man["step"] == 5 and man["num_workers"] == n
        np.testing.assert_array_equal(out["w"], np.arange(10, dtype=np.float32))
