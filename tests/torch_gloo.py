"""Runs a program in a group of fresh processes joined by ``torch.distributed``
over gloo on the CPU (tests/test_torch_{parallel,ring_attention,elastic}.py).

The group meets through a ``FileStore`` under the test's ``tmp_path`` (no TCP
port, so the suite's workers do not collide) with a 60 s collective timeout,
and the whole launch has a deadline: a rank that dies or hangs fails the
test with every rank's output, it does not hang the suite.  Each rank runs
one thread of torch, so a group of 8 takes 8 cores at most.
"""
import os
import subprocess
import sys
import time
import uuid
from pathlib import Path

SRC = str(Path(__file__).resolve().parents[1] / "src")

PRELUDE = """
import datetime, json, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD, STORE = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
ARGS = sys.argv[4:]
dist.init_process_group("gloo", store=dist.FileStore(STORE, WORLD), rank=RANK,
                        world_size=WORLD, timeout=datetime.timedelta(seconds=60))
"""

EPILOGUE = """
dist.barrier()
dist.destroy_process_group()
"""


def launch(code: str, world: int, tmp_path, *args, timeout: float = 240.0) -> list[str]:
    """Run ``code`` (after ``PRELUDE``: ``RANK``, ``WORLD``, ``ARGS`` and the
    process group are set up) in ``world`` processes; returns each rank's
    standard output, in rank order."""
    tmp = Path(tmp_path)
    tag = uuid.uuid4().hex
    store = tmp / f"gloo-store-{tag}"
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1",
           "MKL_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    # each rank's output goes to files: a pipe that nobody drains while
    # another rank is waited on would stall its writer, and with it the group
    logs = [(tmp / f"gloo-{tag}-{r}.out", tmp / f"gloo-{tag}-{r}.err") for r in range(world)]
    procs = []
    for rank, (out, err) in enumerate(logs):
        with open(out, "w") as fo, open(err, "w") as fe:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", PRELUDE + code + EPILOGUE, str(rank), str(world),
                 str(store), *map(str, args)], env=env, stdout=fo, stderr=fe, text=True))
    deadline = time.monotonic() + timeout
    timed_out = False
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            timed_out = True
            break
    if timed_out:
        for p in procs:
            p.kill()
            p.wait()
    outs = [(o.read_text(), e.read_text()) for o, e in logs]
    if timed_out:
        raise AssertionError(f"gloo group of {world} passed its {timeout} s deadline:\n"
                             + "\n".join(e[-2000:] for _, e in outs))
    failed = [r for r, p in enumerate(procs) if p.returncode]
    if failed:
        detail = "\n".join(f"--- rank {r} rc {procs[r].returncode}\n{outs[r][0][-2000:]}"
                           f"\n{outs[r][1][-4000:]}" for r in failed)
        raise AssertionError(f"ranks {failed} failed:\n{detail}")
    return [o for o, _ in outs]


def last_json(out: str):
    """The last line of a rank's output that is a JSON object."""
    import json

    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    return json.loads(lines[-1])
