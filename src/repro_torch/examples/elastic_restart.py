"""Elastic (MxN) restart: checkpoint under one mesh, resume under another.

    PYTHONPATH=src python -m repro_torch.examples.elastic_restart

DMTCP's process virtualization lets a checkpoint restart on different nodes;
the framework's topology virtualization lets one restart on a different *rank
topology*.  This example trains on a (4 data x 2 model) mesh, checkpoints,
then resumes on (4, 2), (2 data x 4 model), (8 data x 1 model) and (2, 2, 2)
— same bits, new sharding, training continues.  The card is one GPU, so the
mesh's 8 ranks are CPU processes joined over gloo (a ``FileStore`` in a
temporary directory), which this script starts itself; each restore reads
the checkpoint from disk into a state placed for its mesh.
"""
from __future__ import annotations

import argparse
import datetime
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

WORLD = 8
SAVE_MESH = (4, 2)
RESTORE_MESHES = [(4, 2), (2, 4), (8, 1), (2, 2, 2)]
DEADLINE_S = 600


def rank_main(rank: int, store: str, out: str) -> None:
    """One rank: train 4 steps at SAVE_MESH and save; then restore onto each
    of RESTORE_MESHES and take step 4.  Rank 0 prints."""
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.checkpoint.store import TieredStore
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.core.virtualization import fetch_tree, place_tree
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adamw
    from repro_torch.parallel.mesh_rules import Rules
    from repro_torch.train import step as TS
    from repro_torch.utils.tree import flatten_with_names

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD), rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    cfg = reduced(get_config("llama3.2-1b"))
    oc = adamw.OptConfig(warmup_steps=2, decay_steps=20)
    axes = TS.state_logical_axes(cfg)
    pipe = SyntheticTokens(cfg, 8, 32, seed=1)

    def batch(b):
        return {k: torch.from_numpy(v) for k, v in b.items()}

    rules = Rules(make_mesh(SAVE_MESH))
    step_fn = TS.make_train_step(cfg, oc, rules=rules)
    state = place_tree(fetch_tree(TS.init_train_state(cfg, oc, 0, "cpu")), axes, rules, "cpu")
    for _ in range(4):
        state, m = step_fn(state, batch(next(pipe)))
    host = fetch_tree(state)                     # a collective: every rank gathers
    if rank == 0:
        mgr = CheckpointManager(TieredStore(Path(out)))
        mgr.save(3, host)
        mgr.commit(3)
        mgr.close()
        print(f"  saved at step 3 on mesh {SAVE_MESH}, loss {float(m['loss']):.5f}", flush=True)
    dist.barrier()
    if rank == 0:
        print("elastic restores:", flush=True)
    for shape in RESTORE_MESHES:
        rules = Rules(make_mesh(shape))
        mgr = CheckpointManager(TieredStore(Path(out)))
        host, _ = mgr.restore(TS.abstract_train_state(cfg, oc), promote=False)
        mgr.close()
        state = place_tree(host, axes, rules, "cpu")
        name, leaf = next((n, x) for n, x in flatten_with_names(state)
                          if hasattr(x, "placements"))
        state, m = TS.make_train_step(cfg, oc, rules=rules)(state, batch(pipe.batch_at(4)))
        if rank == 0:
            print(f"  resumed on mesh {shape}: step 4 loss {float(m['loss']):.5f} "
                  f"(example param {name}: {tuple(leaf.placements)})", flush=True)
    dist.barrier()
    dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.elastic_restart")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        rank_main(args.rank, args.store, args.out)
        return 0
    src = str(Path(__file__).resolve().parents[2])
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([src, os.environ.get("PYTHONPATH", "")]),
           "OMP_NUM_THREADS": "1"}
    with tempfile.TemporaryDirectory() as d:
        print(f"checkpoint on {SAVE_MESH} ({WORLD} gloo CPU ranks):", flush=True)
        # each rank's output goes to a file: a pipe nobody drains while
        # another rank is waited on would stall its writer, and the group
        logs = [Path(d) / f"rank{r}.log" for r in range(WORLD)]
        procs = []
        for r, log in enumerate(logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.examples.elastic_restart",
                     "--rank", str(r), "--store", str(Path(d) / "store"),
                     "--out", str(Path(d) / "ckpt")],
                    env=env, stdout=f, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + DEADLINE_S
        try:
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        print(logs[0].read_text(), end="")
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            for r in failed:
                print(f"--- rank {r} exit {procs[r].returncode}\n{logs[r].read_text()[-3000:]}")
            return 1
    print(f"OK — one checkpoint, {len(RESTORE_MESHES)} topologies")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
