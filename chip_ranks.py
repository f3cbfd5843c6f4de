"""Ranks on the card: how the port's CLIs start under a launcher on one GPU.

    python3 chip_ranks.py        # on a machine with a CUDA card; ~3 min, kernels built

Runs, each as a subprocess with a deadline, and prints one JSON line per run
and a summary line last:

1. ``torchrun --nproc-per-node 1 -m repro_torch.launch.train`` (reduced
   qwen2-0.5b, ``--ckpt-delta --ckpt-device-fp``) with ``--walltime 0.5
   --margin 100``: the worker checkpoints after step 0 and exits 85; the line
   gives the exit code that ``torchrun`` itself returns.  Then the same
   command without the walltime, on the same directory: it resumes at step 1.
2. ``torchrun --nproc-per-node 2`` of the same trainer: the second rank has
   no GPU of its own and must be refused with a message (NCCL puts no two
   ranks on one GPU); the line gives ``torchrun``'s exit code and the message.
3. ``launch.serve --snapshot-at 4`` as a job of one rank (the launcher's
   variables set by hand, an NCCL group of one), reduced qwen2-0.5b and
   reduced deepseek-v3: "continuation MATCHES" and ``world 1, backend
   nccl`` in its report.

Fails (exit 1) if a run does not behave as described; the card's name and
power limit are printed first.  Writes each run's output under
``results/chip_ranks/`` (gitignored).
"""
from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "results" / "chip_ranks"
DEADLINE_S = 600
TRAIN = ["-m", "repro_torch.launch.train", "--arch", "qwen2-0.5b", "--reduced", "--steps", "4",
         "--batch", "8", "--seq", "128", "--ckpt-delta", "--ckpt-device-fp",
         "--dist-timeout", "120"]
RANK_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def env(**extra) -> dict:
    e = {k: v for k, v in os.environ.items() if k not in RANK_VARS}
    e["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src")] + (
        [os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else []))
    e["PYTHONUNBUFFERED"] = "1"
    e.update(extra)
    return e


def run(tag: str, cmd: list, **extra) -> tuple[int, str, float]:
    t0 = time.perf_counter()
    try:
        r = subprocess.run(cmd, env=env(**extra), capture_output=True, text=True,
                           timeout=DEADLINE_S, cwd=ROOT)
        rc, out = r.returncode, r.stdout + r.stderr
    except subprocess.TimeoutExpired as e:
        rc, out = None, f"{e.stdout or ''}{e.stderr or ''}\npassed its deadline"
    wall = time.perf_counter() - t0
    (OUT / f"{tag}.log").write_text(out if isinstance(out, str) else out.decode())
    return rc, out if isinstance(out, str) else out.decode(errors="replace"), wall


def torchrun(nproc: int) -> list:
    return [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(nproc),
            "--master-addr", "127.0.0.1", "--master-port", str(free_port())]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_ranks.py runs on a machine with a card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0], flush=True)
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    work = OUT / "work"
    ok = True

    def report(tag: str, good: bool, **fields) -> None:
        nonlocal ok
        ok &= good
        print(json.dumps({"run": tag, "ok": good, **fields}), flush=True)

    # 1. torchrun, one worker, cut by its walltime, then requeued
    ck, m = work / "t1", work / "t1.json"
    rc, out, wall = run("torchrun-cut", torchrun(1) + TRAIN + [
        "--ckpt-dir", str(ck), "--metrics-out", str(m), "--walltime", "0.5", "--margin", "100"])
    cut = json.loads(m.read_text()) if m.exists() else {}
    report("torchrun 1 worker, walltime exit", [s["step"] for s in cut.get("steps", [])] == [0]
           and cut.get("ranks") == {"world": 1, "backend": "nccl"},
           torchrun_exit=rc, seconds=wall, steps=[s["step"] for s in cut.get("steps", [])],
           ranks=cut.get("ranks"), ranks_start_s=cut.get("ranks_start_s"),
           worker_says="[train] interrupted at step 0 -> requeue" in out)
    m.unlink(missing_ok=True)
    rc, out, wall = run("torchrun-requeued", torchrun(1) + TRAIN + [
        "--ckpt-dir", str(ck), "--metrics-out", str(m)])
    rest = json.loads(m.read_text()) if m.exists() else {}
    report("torchrun 1 worker, requeued", rc == 0 and rest.get("start_step") == 1,
           torchrun_exit=rc, seconds=wall, start_step=rest.get("start_step"),
           losses=[s["loss"] for s in cut.get("steps", []) + rest.get("steps", [])],
           launches=rest.get("launches"))

    # 2. torchrun, two workers on one GPU: refused
    rc, out, wall = run("torchrun-two", torchrun(2) + TRAIN + [
        "--ckpt-dir", str(work / "t2"), "--steps", "2"])
    said = "LOCAL_RANK 1 has no GPU of its own" in out
    report("torchrun 2 workers on one GPU", rc not in (0, None) and said, torchrun_exit=rc,
           seconds=wall, refused_with_message=said)

    # 3. serve as a job of one rank
    for arch in ("qwen2-0.5b", "deepseek-v3-671b"):
        rep = work / f"serve-{arch}.json"
        rc, out, wall = run(f"serve-{arch}", [
            sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch, "--reduced",
            "--snapshot-at", "4", "--ckpt-dir", str(work / f"s-{arch}"),
            "--report-out", str(rep)], RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
            MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
        got = json.loads(rep.read_text()) if rep.exists() else {}
        report(f"serve {arch}, one rank", rc == 0 and "continuation MATCHES" in out
               and got.get("ranks") == {"world": 1, "backend": "nccl"}, exit=rc,
               seconds=wall, ranks=got.get("ranks"), match=got.get("match"))
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
