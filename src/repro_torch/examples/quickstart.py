"""Quickstart: train a small LM with transparent checkpoint-restart.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu] [--steps 60]

Trains a reduced qwen2 with interval checkpoints (every 10 steps) to half
of ``--steps``; then *simulates a crash* by rebuilding everything from
scratch and restoring the latest committed checkpoint — training continues
exactly where it left off, to ``--steps``.  On the card by default.
"""
from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.checkpoint.store import TieredStore
from repro_torch.configs.base import get_config, reduced
from repro_torch.core.cr_manager import CRManager
from repro_torch.data.pipeline import PipelineState, SyntheticTokens
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import resolve_device
from repro_torch.optim import adamw
from repro_torch.parallel.mesh_rules import Rules
from repro_torch.train import step as TS


def make_session(ckpt_dir, device, total_steps):
    cfg = reduced(get_config("qwen2-0.5b"))
    oc = adamw.OptConfig(lr=1e-3, warmup_steps=5, decay_steps=total_steps)
    rules = Rules(make_host_mesh(device))
    step_fn = TS.make_train_step(cfg, oc, rules=rules)
    ckpt = CheckpointManager(TieredStore(Path(ckpt_dir)))
    crm = CRManager(ckpt, interval_steps=10, cfg=cfg, rules=rules, device=device)
    pipe = SyntheticTokens(cfg, batch_size=4, seq_len=64, seed=0)
    templates = {"state": TS.abstract_train_state(cfg, oc)}
    axes = {"state": TS.state_logical_axes(cfg)}

    def init():
        return TS.init_train_state(cfg, oc, 0, device)

    return step_fn, crm, pipe, templates, axes, init


def train(ckpt_dir, until_step, device, total_steps):
    step_fn, crm, pipe, templates, axes, init = make_session(ckpt_dir, device, total_steps)
    state, meta, start = crm.restore_or_init(init, templates, axes)
    if meta and "data_state" in meta:
        pipe.restore(PipelineState.from_dict(meta["data_state"]))
    for step in range(start, until_step):
        batch = {k: torch.from_numpy(v).to(device) for k, v in next(pipe).items()}
        state, metrics = step_fn(state, batch)
        if step % 10 == 0:
            print(f"  step {step:3d}  loss {float(metrics['loss']):.4f}")
        crm.step_boundary(step, lambda: state,
                          extra_meta={"data_state": pipe.state().to_dict()})
    crm.checkpoint_now(until_step - 1, lambda: state,
                       extra_meta={"data_state": pipe.state().to_dict()})
    crm.close()
    return float(metrics["loss"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    half = args.steps // 2
    with tempfile.TemporaryDirectory() as d:
        print(f"phase 1: train to step {half}, checkpointing every 10 steps")
        train(d, half, device, args.steps)
        print(f"phase 2: 'crash' — fresh process state; restore and continue to {args.steps}")
        loss = train(d, args.steps, device, args.steps)
        print(f"done. final loss {loss:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
