"""End-to-end training driver with first-class checkpoint-restart.

This is the job script of the paper's Fig. 3, as a framework CLI, with the
flags of ``repro/launch/train.py``:

  python -m repro_torch.launch.train --arch qwen2-0.5b --steps 200 \\
      --batch 8 --seq 128 --ckpt-dir /tmp/run1 --interval-steps 25 \\
      --ckpt-delta --ckpt-device-fp --walltime 300 --margin 10

Behaviour:
  * restores the latest committed checkpoint if one exists (else cold start);
  * checkpoints every --interval-steps, on trapped SIGTERM/SIGUSR1, and when
    the walltime margin is reached; with --ckpt-device-fp the dirty chunks
    are found on the card (the chunk-fingerprint kernel) and only they are
    copied to the host;
  * exits with code 85 (REQUEUE_EXIT) when interrupted mid-run so the batch
    scheduler requeues it; the requeued run finishes bit-identical to one
    that was never interrupted;
  * optionally attaches to an external checkpoint coordinator
    (--coordinator host:port --worker-id N) for multi-worker rounds.

Runs on the GPU unless ``--device cpu`` is given; with no GPU and no
``--device cpu`` it fails.  Bit-identical resume on the card needs
deterministic kernels: ``CUBLAS_WORKSPACE_CONFIG`` is set before torch is
imported, ``torch.use_deterministic_algorithms(True)`` and TF32 off while
``main`` runs.  ``--metrics-out`` writes ``{"steps": [{step, loss, t, ms}],
"saves": [per-save delta stats], "launches": {kernel: count},
"restore_s": ..., "restore_stats": {tier, bytes_by_tier, promoted, ...},
"start_step": ...}``.
"""
from __future__ import annotations

import os

# before torch is imported: cuBLAS picks its workspace (and with it the
# reduction order of its products) when it first starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

import torch  # noqa: E402

from repro_torch.checkpoint.manager import CheckpointManager, CheckpointPolicy  # noqa: E402
from repro_torch.checkpoint.store import TieredStore, node_local_tier_roots  # noqa: E402
from repro_torch.configs.base import get_config, reduced as reduce_cfg  # noqa: E402
from repro_torch.core.cr_manager import CRManager  # noqa: E402
from repro_torch.core.requeue import RequeueFile, WalltimeTracker, detect_node  # noqa: E402
from repro_torch.core.signals import SignalTrap  # noqa: E402
from repro_torch.core.worker import CkptClient, InlineCoordinator  # noqa: E402
from repro_torch.data.pipeline import PipelineState, SyntheticTokens  # noqa: E402
from repro_torch.kernels import checksum as CK  # noqa: E402
from repro_torch.kernels import flash_attention  # noqa: E402
from repro_torch.launch.serve import resolve_device  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.sched.cache_registry import (ENV_PEER_ROOTS, REGISTRY_DIRNAME,  # noqa: E402
                                              CacheRegistry, parse_peer_roots)
from repro_torch.train import step as TS  # noqa: E402

REQUEUE_EXIT = 85


def build_argparser():
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--ckpt-mode", default="sync", choices=["sync", "async"])
    ap.add_argument("--ckpt-incremental", action="store_true")
    ap.add_argument("--ckpt-delta", action="store_true",
                    help="content-addressed delta checkpoints (shard v3): "
                         "each save writes only the chunks whose hash "
                         "changed since the parent step, and restores "
                         "fetch only chunks the node is missing")
    ap.add_argument("--ckpt-rebase-every", type=int, default=8,
                    help="delta-chain length bound: after this many chained "
                         "delta commits the manifest re-baselines (chunk "
                         "dedup makes the rebaseline itself free)")
    ap.add_argument("--ckpt-replicas", type=int, default=1)
    ap.add_argument("--ckpt-promote", default="off",
                    choices=["off", "on_restore", "eager"],
                    help="tee restored/committed checkpoints into the "
                         "node-local tier so the next restart on this node "
                         "skips the shared filesystem")
    ap.add_argument("--ckpt-promote-tier", default="local",
                    choices=["ram", "local"])
    ap.add_argument("--local-root", default=None,
                    help="node-local tier root: mounts the local/ram tiers "
                         "under this path instead of --ckpt-dir, so promoted "
                         "caches are per-node (defaults to $REPRO_LOCAL_ROOT "
                         "as set by a scheduler's placements)")
    ap.add_argument("--peer-roots", default=None,
                    help="warm-peer cache roots as 'name=path,name=path': "
                         "a cold-node restore sources checkpoint ranges from "
                         "these peers' local tiers instead of the shared "
                         "filesystem (defaults to $REPRO_PEER_ROOTS as set "
                         "by the scheduler, then to the last requeue "
                         "record's peer_roots)")
    ap.add_argument("--restore-workers", type=int, default=0,
                    help="parallel restore read pool size (0=auto, 1=serial)")
    ap.add_argument("--hash-workers", type=int, default=0,
                    help="parallel chunk hash/CRC pool size for delta saves "
                         "(0=auto / $REPRO_HASH_WORKERS, 1=serial)")
    ap.add_argument("--ckpt-compress", type=int, default=0,
                    help="per-chunk compression level for delta chunk files "
                         "(0=off; >=1 frames each stored chunk with zstd "
                         "when available, else zlib — hashes stay over the "
                         "raw bytes, so dedup and fingerprints are "
                         "unaffected)")
    ap.add_argument("--io-batch", type=int, default=0,
                    help="ranges per batched restore-read submission "
                         "(0=auto / $REPRO_IO_BATCH, 1=per-range reads)")
    ap.add_argument("--ckpt-fingerprint", action="store_true",
                    help="delta saves stamp per-chunk 32-bit fingerprints "
                         "and use the parent step's as a dirty-chunk "
                         "pre-filter: fingerprint-equal chunks skip blake2b "
                         "(opt-in: a dirty chunk colliding on 32 bits would "
                         "be treated as clean)")
    ap.add_argument("--ckpt-predump", action="store_true",
                    help="CRIU-style pre-dump: before each interval "
                         "checkpoint, snapshot + hash + pre-write chunks in "
                         "the background so the save stall covers only "
                         "bytes dirtied in the last --ckpt-predump-lead "
                         "steps (requires --ckpt-delta)")
    ap.add_argument("--ckpt-predump-lead", type=int, default=1,
                    help="pre-dump window: a pre-dump fires at EVERY step "
                         "in the last N steps before the interval boundary "
                         "(iterative pre-copy — each lead re-hashes only "
                         "what dirtied since the lead before)")
    ap.add_argument("--ckpt-device-fp", action="store_true",
                    help="device-resident dirty detection: run the "
                         "fingerprint kernel on the live params on the card "
                         "and copy only fp-dirty chunks host-side — clean "
                         "chunks cost zero device->host bytes (requires "
                         "--ckpt-delta; set REPRO_DEVICE_FP_IMPL to pick "
                         "the kernel impl)")
    ap.add_argument("--ckpt-calibrate", action="store_true",
                    help="measure per-tier store bandwidth/latency at "
                         "startup (cached in tier_profile.json) and apply "
                         "the profile to tier routing")
    ap.add_argument("--interval-steps", type=int, default=0)
    ap.add_argument("--walltime", type=float, default=0.0)
    ap.add_argument("--margin", type=float, default=5.0)
    ap.add_argument("--coordinator", default=None, help="host:port")
    ap.add_argument("--worker-id", type=int, default=0)
    ap.add_argument("--num-workers", type=int, default=1)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--step-sleep", type=float, default=0.0,
                    help="artificial per-step delay (benchmark pacing)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; the kernels run only on cuda")
    return ap


def _synced(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.ckpt_delta and args.ckpt_incremental:
        sys.exit("--ckpt-delta and --ckpt-incremental are mutually exclusive")
    if ((args.ckpt_predump or args.ckpt_fingerprint or args.ckpt_device_fp)
            and not args.ckpt_delta):
        sys.exit("--ckpt-predump/--ckpt-fingerprint/--ckpt-device-fp "
                 "require --ckpt-delta")
    device = resolve_device(args.device)
    # trap preemption signals from the very start: a USR1 during start-up /
    # restore must checkpoint-and-requeue, not kill the process (default USR1
    # action is terminate) — the paper's startup-time lesson (Fig. 2) applies
    # to the C/R loop itself.
    trap = SignalTrap()
    trap.__enter__()
    numerics = (torch.are_deterministic_algorithms_enabled(),
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _run(args, device, trap)
    finally:
        torch.use_deterministic_algorithms(numerics[0])
        torch.backends.cuda.matmul.allow_tf32 = numerics[1]
        torch.backends.cudnn.allow_tf32 = numerics[2]
        trap.__exit__(None, None, None)


def _run(args, device: torch.device, trap: SignalTrap) -> int:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    oc = adamw.OptConfig(lr=args.lr, warmup_steps=10, decay_steps=max(args.steps, 2))
    train_step = TS.make_train_step(cfg, oc, microbatches=args.microbatches)

    # multi-node placement: the shared tier lives under --ckpt-dir for every
    # node; the node-LOCAL tiers mount under the root the scheduler handed us,
    # so a shared->local promotion warms exactly this node's cache and the
    # restore-aware scheduler can route the next requeue back here.
    local_root = args.local_root or os.environ.get("REPRO_LOCAL_ROOT")
    tier_roots = node_local_tier_roots(local_root) if local_root else None
    store = TieredStore(Path(args.ckpt_dir), tier_roots=tier_roots)
    if args.ckpt_calibrate:
        # measured tier profile (cached in tier_profile.json under the store
        # root) replaces the static tier table — restore sizing and promote
        # routing then reflect THIS machine's actual I/O planes
        from repro_torch.checkpoint.calibrate import calibrate_tiers
        calibrate_tiers(store)
    requeue_file = RequeueFile(Path(args.ckpt_dir) / "requeue.json")
    prior = requeue_file.load()
    # peer fabric: scheduler hint first, then whatever the last attempt
    # recorded; the registry adds decentralized discovery on top
    node = detect_node()
    peers = parse_peer_roots(args.peer_roots
                             or os.environ.get(ENV_PEER_ROOTS))
    if not peers:
        peers = {n: Path(r)
                 for n, r in (prior.get("peer_roots") or {}).items()}
    registry = CacheRegistry(
        Path(args.ckpt_dir) / REGISTRY_DIRNAME)
    policy = CheckpointPolicy(replicas=args.ckpt_replicas,
                              mode=args.ckpt_mode,
                              incremental=args.ckpt_incremental,
                              delta=args.ckpt_delta,
                              rebase_every=args.ckpt_rebase_every,
                              restore_workers=args.restore_workers,
                              fingerprint=args.ckpt_fingerprint,
                              device_fp=args.ckpt_device_fp,
                              hash_workers=args.hash_workers,
                              compress=args.ckpt_compress,
                              io_batch=args.io_batch,
                              promote=args.ckpt_promote,
                              promote_tier=args.ckpt_promote_tier)
    ckpt = CheckpointManager(store, policy, worker_id=args.worker_id,
                             num_workers=args.num_workers, peer_roots=peers,
                             node=node, registry=registry)

    if args.coordinator:
        host, port = args.coordinator.rsplit(":", 1)
        client = CkptClient(host, int(port), args.worker_id)
    else:
        client = InlineCoordinator(commit_fn=ckpt.commit)

    walltime = None
    if args.walltime:
        walltime = WalltimeTracker(args.walltime, args.margin,
                                   consumed_s=prior.get("consumed_s", 0.0))

    pipe = SyntheticTokens(cfg, args.batch, args.seq, seed=args.seed)
    launches0 = (flash_attention.launches, CK.fingerprint_launches)

    crm = CRManager(ckpt, client=client, signal_trap=trap, walltime=walltime,
                    requeue_file=requeue_file,
                    interval_steps=args.interval_steps or None,
                    predump=args.ckpt_predump,
                    predump_lead=args.ckpt_predump_lead,
                    cfg=cfg, device=device, node=node,
                    peers=peers or None)

    def init_fn():
        return TS.init_train_state(cfg, oc, args.seed, device)

    # template for restore: the state's tree as meta tensors
    templates = {"state": TS.abstract_train_state(cfg, oc)}
    t0 = _synced(device)
    state, meta, start_step = crm.restore_or_init(init_fn, templates)
    restore_s = _synced(device) - t0
    if meta is not None and "data_state" in meta:
        pipe.restore(PipelineState.from_dict(meta["data_state"]))

    metrics_log = []
    exit_code = 0
    step = start_step
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in next(pipe).items()}
        t1 = _synced(device)
        state, metrics = train_step(state, batch)
        loss = float(metrics["loss"])
        step_ms = (_synced(device) - t1) * 1e3
        if args.step_sleep:
            time.sleep(args.step_sleep)
        metrics_log.append({"step": step, "loss": loss, "t": time.time(),
                            "ms": step_ms})
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step} loss {loss:.4f}", flush=True)

        extra = {"data_state": pipe.state().to_dict()}
        action = crm.step_boundary(step, lambda: state, extra_meta=extra)
        if action == "exit":
            crm.request_requeue(step, reason=crm.exit_reason() or "")
            print(f"[train] interrupted at step {step} -> requeue", flush=True)
            exit_code = REQUEUE_EXIT
            break
    else:
        # run completed: final checkpoint so eval/serving can pick it up
        crm.checkpoint_now(args.steps - 1, lambda: state, reason="final",
                           extra_meta={"data_state": pipe.state().to_dict(),
                                       "completed": True})
        print(f"[train] completed {args.steps} steps", flush=True)

    if args.metrics_out:
        Path(args.metrics_out).write_text(json.dumps({
            "steps": metrics_log, "saves": crm.saves,
            "launches": {"flash": flash_attention.launches - launches0[0],
                         "chunk_fingerprints": CK.fingerprint_launches - launches0[1]},
            "restore_s": restore_s if meta is not None else None,
            "restore_stats": ckpt.last_restore_stats if meta is not None else None,
            "start_step": start_step, "device": str(device)}))
    crm.close()
    return exit_code


if __name__ == "__main__":
    sys.exit(main())
