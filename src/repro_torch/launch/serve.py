"""Serving entry point: pause/migrate/resume (the paper's C/R applied to
inference state), plus serving-fleet weight-follow (the chunk fabric applied
to weight distribution).

  python -m repro_torch.launch.serve --arch qwen2-0.5b --batch 4 \\
      --prompt-len 512 --gen 32 --max-seq 1024 --snapshot-at 16 --ckpt-dir /tmp/serve

Prefills a batch of synthetic prompts and generates greedily; if
--snapshot-at is set, checkpoints the engine (KV caches + cursors) at that
token through ``CheckpointManager``, rebuilds a fresh engine, restores, and
finishes, printing whether the continuation matched an unmigrated reference
(it must, bit for bit).  Runs on the GPU unless ``--device cpu`` is given;
with no GPU and no ``--device cpu`` it fails.  float32 matrix products run in
full float32 (TF32 off), as on the CPU.
``--num-layers N`` serves the arch at its width with its depth cut to N
layers (deepseek-v3-671b at 2 layers fits one card).

Ranks: launched as the ranks of a job (the launcher's ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``; one process
per GPU, or gloo ranks with ``--device cpu``), it joins their group
(``launch.mesh.start_ranks``) and each rank serves its rows of the batch on
the (world, 1) mesh.  The tokens are gathered whole on every rank; rank 0
saves the (mesh-free) snapshot and prints the report, and every rank
restores it and continues its rows.  ``--follow`` runs on one process only.

Fleet mode (``--follow``): the checkpoint prefix holds PARAMETER checkpoints
pushed by a trainer (``CheckpointManager`` + ``registry.announce_push``).
This replica restores the latest push read-only, serves batches, and between
batches polls the push plane, fetches newer weights through the chunk
fabric, and swaps them in at generation boundaries (never mid-decode) with
staleness bounded by ``--max-lag-steps``:

  python -m repro_torch.launch.serve --arch qwen2-0.5b --follow \\
      --ckpt-dir /tmp/weights --replica r0 --max-lag-steps 2 --batches 4
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import serialization as SER
from repro_torch.checkpoint.manager import CheckpointManager, CheckpointPolicy
from repro_torch.checkpoint.store import TieredStore, node_local_tier_roots
from repro_torch.configs.base import ModelConfig, cut_depth, get_config, reduced as reduce_cfg
from repro_torch.kernels import decode_attention, flash_attention
from repro_torch.launch.mesh import make_host_mesh, start_ranks, stop_ranks
from repro_torch.models import model as M
from repro_torch.parallel.mesh_rules import Rules
from repro_torch.sched.cache_registry import REGISTRY_DIRNAME, CacheRegistry
from repro_torch.serve.engine import Engine
from repro_torch.serve.weight_sync import ParamHandle, WeightSyncClient
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
    ap.add_argument("--num-layers", type=int, default=None,
                    help="serve the arch at its width with its depth cut to N layers "
                         "(configs.base.cut_depth)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--snapshot-at", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_serve")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; the kernels run only on cuda")
    ap.add_argument("--report-out", default=None,
                    help="write the report (the tokens as lists) here as JSON")
    ap.add_argument("--dist-timeout", type=float, default=600.0,
                    help="ranks: seconds a collective waits before it fails")
    # fleet follower mode
    ap.add_argument("--follow", action="store_true",
                    help="serve as a weight-sync follower of --ckpt-dir")
    ap.add_argument("--replica", default="r0",
                    help="this replica's name in the registry fleet view")
    ap.add_argument("--max-lag-steps", type=int, default=None,
                    help="staleness bound: force a swap (then drain or "
                         "fail) past this many steps behind the push")
    ap.add_argument("--on-stale", choices=("drain", "raise"),
                    default="drain",
                    help="--follow: past --max-lag-steps, drain and "
                         "re-admit (default) or fail out of rotation")
    ap.add_argument("--drain-timeout-s", type=float, default=60.0,
                    help="--follow: give up on a drain that never "
                         "re-admits after this long")
    ap.add_argument("--poll-s", type=float, default=0.1,
                    help="--follow: push-plane poll interval while "
                         "draining")
    ap.add_argument("--pipeline-uploads", action="store_true",
                    help="--follow: overlap device upload of push N with "
                         "the fetch of push N+1")
    ap.add_argument("--local-root", default=None,
                    help="--follow: private node-local tier root for this "
                         "replica (isolates + peer-exposes its cache)")
    ap.add_argument("--batches", type=int, default=4,
                    help="--follow: request batches to serve before exit")
    ap.add_argument("--delta", action="store_true", default=True,
                    help="--follow: expect delta (chunked) weight pushes")
    ap.add_argument("--restore-workers", type=int, default=0)
    return ap.parse_args(argv)


def _synced() -> float:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return time.perf_counter()


def _full_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def served_config(args: argparse.Namespace) -> ModelConfig:
    """The config that ``--arch``, ``--reduced`` and ``--num-layers`` name."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    if args.num_layers:
        cfg = cut_depth(cfg, args.num_layers)
    return cfg


def synthetic_prompts(cfg: ModelConfig, rng: np.random.Generator, batch: int,
                      prompt_len: int, device: torch.device) -> dict:
    """A batch of random prompts, as the engine takes them: (B,S) tokens, or
    (B,S,K) with K codebooks."""
    shape = ((batch, prompt_len, cfg.num_codebooks) if cfg.num_codebooks
             else (batch, prompt_len))
    return {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, shape),
                                      dtype=torch.int32, device=device)}


def model_uploader(cfg: ModelConfig, device: torch.device):
    """``to_native`` for a follower: a restored host tree -> the ``LM`` on
    ``device``.  The model is on the card in full before it is returned: with
    --pipeline-uploads this runs on the upload thread, and the engine may
    swap the model in as soon as it is staged."""
    def to_native(tree) -> M.LM:
        model = M.params_from_numpy(cfg, tree, device)
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
        return model
    return to_native


@dataclasses.dataclass
class Follower:
    """A follower replica's wiring: the read-only manager, the sync client,
    and the engine serving the client's ``ParamHandle``."""

    cfg: ModelConfig
    device: torch.device
    mgr: CheckpointManager
    client: WeightSyncClient
    engine: Engine
    manifest: dict
    restore_s: float

    def close(self) -> None:
        try:
            self.client.close()
        finally:
            self.mgr.close()


def open_follower(args: argparse.Namespace) -> Optional[Follower]:
    """Restore the latest pushed weights read-only and wire the sync client
    and the engine as ``--follow`` serves them; None when nothing is
    committed yet.  The restore template is the param specs on the meta
    device, so no second model is built on the card."""
    device = resolve_device(args.device)
    _full_fp32()
    cfg = served_config(args)
    tier_roots = (node_local_tier_roots(Path(args.local_root))
                  if args.local_root else None)
    store = TieredStore(Path(args.ckpt_dir), tier_roots=tier_roots)
    registry = CacheRegistry(Path(args.ckpt_dir) / REGISTRY_DIRNAME)
    mgr = CheckpointManager(
        store,
        CheckpointPolicy(delta=args.delta, restore_workers=args.restore_workers),
        node=args.replica, registry=registry)
    if not mgr.steps():
        mgr.close()
        return None
    template = M.abstract_params(cfg)
    to_native = model_uploader(cfg, device)
    t0 = time.perf_counter()
    host, manifest = mgr.restore(template, promote=False, follower_cache=True)
    handle = ParamHandle(to_native(host), step=manifest["step"])
    restore_s = time.perf_counter() - t0
    client = WeightSyncClient(mgr, handle, template, registry=registry,
                              replica=args.replica,
                              max_lag_steps=args.max_lag_steps,
                              to_native=to_native, on_stale=args.on_stale,
                              pipeline_uploads=args.pipeline_uploads)
    eng = Engine(cfg, handle, batch=args.batch, max_seq=args.max_seq,
                 sync_client=client, rules=Rules(make_host_mesh(device)))
    return Follower(cfg, device, mgr, client, eng, manifest, restore_s)


def follow(args: argparse.Namespace) -> int:
    """Serving-fleet follower: restore the latest pushed weights read-only,
    then serve batches while tracking the push plane.

    Fleet citizenship: the follower advertises its fetched chunk inventory
    to the registry (follower cache), so the next replica pulls the delta
    from THIS process instead of the shared tier; a replica past
    ``--max-lag-steps`` DRAINS (refuses new batches, keeps polling, shows
    ``draining`` fleet-wide) and re-admits once it catches up, unless
    ``--on-stale raise`` asks for the fail-out-of-rotation behavior.
    ``--local-root`` mounts the node-local tiers under a private directory
    so many replicas of one host stay isolated (and peer-fetchable);
    ``--pipeline-uploads`` overlaps the device upload of push N with the
    fetch of push N+1."""
    fol = open_follower(args)
    if fol is None:
        print("no committed weight push found; start the publisher first",
              file=sys.stderr)
        return 1
    client, eng, handle = fol.client, fol.engine, fol.client.handle
    rng = np.random.default_rng(args.seed)
    print(f"replica {args.replica}: restored step {fol.manifest['step']} in "
          f"{fol.restore_s:.3f} s on {fol.device}")
    print(f"replica {args.replica}: serving step {fol.manifest['step']}")
    try:
        for b in range(args.batches):
            client.sync_once()                   # fetch off the request path
            if not eng.admit():                  # staleness gate: DRAIN, not die
                print(f"replica {args.replica}: draining at lag {client.lag()}",
                      file=sys.stderr)
                deadline = time.monotonic() + args.drain_timeout_s
                while not eng.admit():
                    if time.monotonic() >= deadline:
                        print(f"replica {args.replica}: drain timed out after "
                              f"{args.drain_timeout_s:.0f}s at lag "
                              f"{client.lag()}", file=sys.stderr)
                        return 1
                    time.sleep(args.poll_s)
                    client.sync_once()
                print(f"replica {args.replica}: re-admitted at step "
                      f"{handle.step}")
            # boundary: a staged push swaps in
            eng.prefill(synthetic_prompts(fol.cfg, rng, args.batch, args.prompt_len,
                                          fol.device))
            eng.generate(args.gen)
            print(f"batch {b}: served step {handle.step}, "
                  f"lag {client.lag()}, swaps {handle.swap_count}, "
                  f"swap_stall {handle.last_swap_s * 1e6:.0f}us")
        # the attention kernels' launches in this process (0 where the
        # tensors lie on the CPU and the plain versions run)
        print(f"replica {args.replica}: launches flash {flash_attention.launches} "
              f"flash_decode {decode_attention.launches}", file=sys.stderr)
    finally:
        fol.close()
    return 0


def run(args: argparse.Namespace, model: Optional[M.LM] = None) -> dict:
    """Serve once as ``args`` say.  Returns the tokens, whether the migrated
    continuation matched (None without --snapshot-at) and the timings.
    ``model``: parameters already on the device, of exactly the config that
    the argv names, for a caller that serves and then profiles one large
    model and draws it once; by default they are drawn from ``--seed``."""
    if args.snapshot_at and not 0 < args.snapshot_at < args.gen:
        raise ValueError("--snapshot-at must lie strictly inside --gen")
    device = resolve_device(args.device)
    _full_fp32()
    cfg = served_config(args)
    if model is None:
        model = M.init_params(cfg, args.seed, device)
    elif model.cfg != cfg:
        raise ValueError(f"the model given is not the config that --arch, --reduced and "
                         f"--num-layers name ({cfg.name}, {cfg.num_layers} layers)")
    rng = np.random.default_rng(args.seed)
    prompts = synthetic_prompts(cfg, rng, args.batch, args.prompt_len, device)
    rules = Rules(make_host_mesh(device))

    def fresh():
        return Engine(cfg, model, batch=args.batch, max_seq=args.max_seq, rules=rules)

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
    lead = rules.mesh.device_mesh is None or dist.get_rank() == 0
    try:
        snap = eng.snapshot()               # whole: every rank gathers
        t0 = _synced()
        if lead:
            mgr.save(0, snap)
            mgr.commit(0)
        if rules.mesh.device_mesh is not None:
            dist.barrier()                  # the snapshot is committed
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
    ranks = start_ranks(resolve_device(args.device), args.dist_timeout)
    try:
        if args.follow:
            if ranks is not None:
                sys.exit("--follow serves on one process; it does not run as ranks")
            return follow(args)
        rep = run(args)
        if args.report_out and (ranks is None or ranks.rank == 0):
            Path(args.report_out).write_text(json.dumps({
                **{k: v for k, v in rep.items() if k != "tokens"},
                "tokens": rep["tokens"].tolist(),
                "ranks": {"world": ranks.world if ranks else 1,
                          "backend": ranks.backend if ranks else None}}))
        if ranks is not None and ranks.rank != 0:
            return 0 if rep["match"] is not False else 1
        return _print_report(args, rep)
    finally:
        stop_ranks()


def _print_report(args: argparse.Namespace, rep: dict) -> int:
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
