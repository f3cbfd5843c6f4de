"""The port's four examples (``repro_torch.examples``) run on the CPU at a
reduced size, each as its own process, as a user starts it."""
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = str(Path(__file__).resolve().parents[1] / "src")


def _run(name, *args, timeout=300):
    env = {**os.environ, "PYTHONPATH": SRC}
    r = subprocess.run([sys.executable, "-m", f"repro_torch.examples.{name}", *args], env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout


def test_quickstart_restores_after_the_crash_and_continues():
    out = _run("quickstart", "--device", "cpu", "--steps", "4")
    assert "restored checkpoint step=1 -> resuming at 2" in out
    assert "done. final loss" in out


def test_serve_migration_continuation_is_token_identical():
    out = _run("serve_migration", "--device", "cpu")
    assert "migrated continuation is token-identical" in out


def test_preemptible_training_completes_under_the_scheduler():
    out = _run("preemptible_training", "--device", "cpu", "--steps", "2")
    assert "job state: COMPLETED" in out
    assert "final step 1" in out


def test_elastic_restart_resumes_on_four_topologies():
    out = _run("elastic_restart", timeout=500)
    losses = [line.split("step 4 loss ")[1].split()[0] for line in out.splitlines()
              if "step 4 loss" in line]
    assert len(losses) == 4
    # the reference's elastic limit: resharding may reassociate reductions
    assert max(map(float, losses)) - min(map(float, losses)) <= 5e-4
    assert "OK — one checkpoint, 4 topologies" in out


def test_trainer_keeps_its_exit_code_when_a_warning_lands_after_the_run(tmp_path):
    """``preemptible_training`` on the card: the scheduler's warning signal
    can land after the trainer's last step, once its trap is gone; the
    process must still exit with the run's code (0), not die of the signal."""
    env = {**os.environ, "PYTHONPATH": SRC}
    p = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
                          "--reduced", "--steps", "2", "--batch", "2", "--seq", "16",
                          "--ckpt-dir", str(tmp_path)],
                         env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        for line in p.stdout:
            if "[train] completed" in line:
                break
        while p.poll() is None:              # the warning, again and again, to the end
            try:
                p.send_signal(signal.SIGUSR1)
            except ProcessLookupError:
                break
            time.sleep(0.0005)
        p.stdout.read()
        assert p.wait(timeout=120) == 0
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
