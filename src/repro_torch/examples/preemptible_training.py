"""Preemptible training under a batch scheduler — the paper's Fig. 3 end-to-end.

    PYTHONPATH=src python -m repro_torch.examples.preemptible_training \
        [--preset demo|100m] [--device cpu] [--steps N]

Submits a training job (``repro_torch.launch.train``) to the Slurm simulator
with a walltime far shorter than the job needs.  The scheduler delivers
SIGUSR1 before each limit; the job checkpoints, exits 85, is requeued
(output appended), restores, and repeats until the run completes.  The
final summary shows every attempt, the steps it covered, and that total
progress equals a single uninterrupted run.  On the card by default.

Presets:
  demo  ~6M-param model, 120 steps  (finishes in a few minutes on 1 CPU core)
  100m  ~100M-param model, 300 steps (the full-scale deliverable; needs real
        compute — identical code path, just bigger numbers)
``--steps`` replaces the preset's step count.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
import tempfile
from pathlib import Path

from repro_torch.sched.slurmsim import JobSpec, SlurmSim

SRC = Path(__file__).resolve().parents[2]

PRESETS = {
    # (extra train args, steps, per-attempt walltime seconds)
    "demo": (["--reduced", "--batch", "4", "--seq", "64", "--step-sleep", "0.1"], 120, 25.0),
    "100m": (["--batch", "8", "--seq", "512", "--microbatches", "2"], 300, 1800.0),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.preemptible_training")
    ap.add_argument("--preset", default="demo", choices=sorted(PRESETS))
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=None)
    args = ap.parse_args(argv)
    extra, steps, walltime = PRESETS[args.preset]
    steps = args.steps or steps
    if args.device.startswith("cuda"):
        # the attempts' walltime is for training: the kernels compile once,
        # here, not in every attempt that the limit cuts short
        from repro_torch.kernels import _build

        _build.build()

    with tempfile.TemporaryDirectory() as d:
        ckpt = Path(d) / "ckpt"
        metrics = Path(d) / "metrics.json"
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", args.arch,
               "--device", args.device, "--steps", str(steps),
               "--ckpt-dir", str(ckpt), "--metrics-out", str(metrics),
               "--walltime", "86400", "--margin", "2", *extra]
        sim = SlurmSim(Path(d) / "slurm")
        jid = sim.submit(JobSpec(
            name="pretrain", cmd=cmd, walltime_s=walltime, signal_margin_s=4.0,
            env={"PYTHONPATH": str(SRC)}, max_requeues=50))
        print(f"submitted job {jid} (walltime {walltime}s/attempt) — running...")
        sim.run(timeout_s=86400)
        rec = sim.job(jid)
        print(f"\njob state: {rec.state}   attempts: {rec.requeues + 1}   "
              f"exit codes: {rec.exit_codes}")
        out = (Path(d) / "slurm" / "pretrain.out").read_text()
        attempts = re.findall(r"=== launch attempt (\d+) on \S+ ===", out)
        resumes = re.findall(r"restored checkpoint step=(\d+)", out)
        print(f"scheduler launches: {attempts}")
        print(f"restore points:      {resumes}")
        steps_run = json.loads(metrics.read_text())["steps"] if metrics.exists() else []
        if steps_run:       # the last attempt's steps
            print(f"final step {steps_run[-1]['step']}  final loss {steps_run[-1]['loss']:.4f}")
        if rec.state != "COMPLETED":
            print(out[-4000:])
            raise SystemExit(f"the job ended {rec.state}, not COMPLETED")
        print("OK — preempted training completed via checkpoint-requeue cycles")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
