"""Serving with pause/migrate/resume — C/R applied to inference state.

    PYTHONPATH=src python -m repro_torch.examples.serve_migration [--device cpu]

The paper highlights DMTCP's ability to "pause, migrate, or resume computations
across different machines".  For an LM server the live state is the KV cache +
generation cursor.  This example serves a batch of requests, snapshots the
engine mid-generation through the checkpoint substrate, tears the engine down,
"migrates" to a fresh engine (new object, could be a new host), restores, and
verifies the continuation is token-identical to an unmigrated run.  On the
card by default.
"""
from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint import serialization as SER
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.checkpoint.store import TieredStore
from repro_torch.configs.base import get_config, reduced
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import resolve_device
from repro_torch.models import model as M
from repro_torch.parallel.mesh_rules import Rules
from repro_torch.serve.engine import Engine
from repro_torch.utils.tree import tree_map

ARCH = "llama3.2-1b"
BATCH, PROMPT, MAX_SEQ = 4, 12, 64


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.serve_migration")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = resolve_device(ap.parse_args(argv).device)
    cfg = reduced(get_config(ARCH))
    rules = Rules(make_host_mesh(device))
    params = M.init_params(cfg, 0, device)
    rng = np.random.default_rng(0)
    prompts = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)).to(device)}

    # ---- reference: uninterrupted generation --------------------------------
    ref = Engine(cfg, params, batch=BATCH, max_seq=MAX_SEQ, rules=rules)
    ref.prefill(prompts)
    ref_tokens = np.concatenate([ref.generate(10), ref.generate(10)], axis=1)

    # ---- serve 10 tokens, snapshot, migrate, resume -------------------------
    eng = Engine(cfg, params, batch=BATCH, max_seq=MAX_SEQ, rules=rules)
    eng.prefill(prompts)
    first = eng.generate(10)

    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(TieredStore(Path(d)))
        snap = eng.snapshot()
        mgr.save(0, snap)
        mgr.commit(0)
        del eng                                     # old server gone
        print("engine checkpointed; migrating to a fresh engine...")

        eng2 = Engine(cfg, params, batch=BATCH, max_seq=MAX_SEQ, rules=rules)
        restored, _ = mgr.restore(snap)             # the tree gives the structure only
        mgr.close()
        eng2.restore(tree_map(lambda a: SER.to_torch(a, device), restored))
        second = eng2.generate(10)

    got = np.concatenate([first, second], axis=1)
    if not np.array_equal(got, ref_tokens):
        raise SystemExit("migrated continuation diverged!")
    print(f"OK — {BATCH} requests x 20 tokens; migrated continuation is "
          f"token-identical to the unmigrated run")
    print("sample continuation (request 0):", got[0].ravel()[:10], "...")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
