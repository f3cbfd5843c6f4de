"""Serving entry point: pause/migrate/resume (the paper's C/R applied to inference
state).

  python -m repro_torch.launch.serve --arch qwen2-0.5b --batch 4 \\
      --prompt-len 512 --gen 32 --max-seq 1024 --snapshot-at 16 --ckpt-dir /tmp/serve

Prefills a batch of synthetic prompts and generates greedily; if
--snapshot-at is set, checkpoints the engine (KV caches + cursors) at that
token through ``CheckpointManager``, rebuilds a fresh engine, restores, and
finishes, printing whether the continuation matched an unmigrated reference
(it must, bit for bit).  Runs on the GPU unless ``--device cpu`` is given;
with no GPU and no ``--device cpu`` it fails.  float32 matrix products run in
full float32 (TF32 off), as on the CPU.

Fleet mode (``--follow``) is not ported yet: it needs the scheduler's cache
registry.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint import serialization as SER
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.checkpoint.store import TieredStore
from repro_torch.configs.base import get_config, reduced as reduce_cfg
from repro_torch.models import model as M
from repro_torch.serve.engine import Engine
from repro_torch.utils.tree import tree_bytes, tree_map


def resolve_device(name: str) -> torch.device:
    """``name`` as a device; a CUDA device must exist (no silent CPU run)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass --device cpu to run on the CPU")
    return dev


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--snapshot-at", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_serve")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; the kernels run only on cuda")
    ap.add_argument("--follow", action="store_true",
                    help="serve as a weight-sync follower (not ported yet)")
    return ap.parse_args(argv)


def _synced() -> float:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return time.perf_counter()


def run(args: argparse.Namespace) -> dict:
    """Serve once as ``args`` say.  Returns the tokens, whether the migrated
    continuation matched (None without --snapshot-at) and the timings."""
    if args.snapshot_at and not 0 < args.snapshot_at < args.gen:
        raise ValueError("--snapshot-at must lie strictly inside --gen")
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    model = M.init_params(cfg, args.seed, device)
    rng = np.random.default_rng(args.seed)
    prompts = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)),
        dtype=torch.int32, device=device)}

    def fresh():
        return Engine(cfg, model, batch=args.batch, max_seq=args.max_seq)

    report: dict = {"device": str(device), "match": None}
    # reference (no migration)
    ref = fresh()
    t0 = _synced()
    ref.prefill(prompts)
    t1 = _synced()
    ref_tokens = ref.generate(args.gen)
    t2 = _synced()
    report["prefill_ms"] = (t1 - t0) * 1e3
    report["decode_ms_per_token"] = (t2 - t1) * 1e3 / args.gen
    report["tokens"] = ref_tokens
    report["logits_finite"] = bool(torch.isfinite(ref.last_logits).all())
    del ref
    if not args.snapshot_at:
        return report

    eng = fresh()
    t0 = _synced()
    eng.prefill(prompts)
    report["prefill_warm_ms"] = (_synced() - t0) * 1e3
    first = eng.generate(args.snapshot_at)
    mgr = CheckpointManager(TieredStore(Path(args.ckpt_dir)))
    try:
        snap = eng.snapshot()
        t0 = _synced()
        mgr.save(0, snap)
        mgr.commit(0)
        report["save_s"] = time.perf_counter() - t0
        report["snapshot_bytes"] = tree_bytes(snap)
        del eng
        eng2 = fresh()
        t0 = time.perf_counter()
        restored, _ = mgr.restore(snap)     # the tree gives the structure only
        eng2.restore(tree_map(lambda a: SER.to_torch(a, device), restored))
        report["restore_s"] = _synced() - t0
    finally:
        mgr.close()
    rest = eng2.generate(args.gen - args.snapshot_at)
    got = np.concatenate([first, rest], axis=1)
    report["match"] = bool(np.array_equal(got, ref_tokens))
    return report


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.follow:
        print("--follow is not yet ported to repro_torch (it needs the scheduler's "
              "cache registry); see ROADMAP.md", file=sys.stderr)
        return 2
    rep = run(args)
    print(f"device {rep['device']}: prefill {rep['prefill_ms']:.1f} ms, "
          f"decode {rep['decode_ms_per_token']:.2f} ms/token")
    if rep["match"] is None:
        print(f"generated {args.gen} tokens x {args.batch} requests")
        print("request 0:", rep["tokens"][0].ravel()[:16], "...")
        return 0
    print(f"second prefill {rep['prefill_warm_ms']:.1f} ms; snapshotted at token "
          f"{args.snapshot_at}: {rep['snapshot_bytes']} bytes, "
          f"save {rep['save_s']:.3f} s, restore {rep['restore_s']:.3f} s")
    print(f"continuation {'MATCHES' if rep['match'] else 'DIVERGED FROM'} the "
          f"unmigrated reference")
    return 0 if rep["match"] else 1


if __name__ == "__main__":
    sys.exit(main())
