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

Ranks: launched as the ranks of a job (``torchrun``, or ``srun`` with
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``
exported; one process per GPU, NCCL, or gloo ranks with ``--device cpu``),
it joins their group (``launch.mesh.start_ranks``) and trains on the
(world, 1) mesh of ``make_host_mesh()`` with ``Rules(mesh)``, as the
reference's one process does over every local device; with none of those
variables it starts no group and the mesh is (1, 1).  Rank ``r`` is worker
``r`` of ``world`` in the checkpoint (leaf ``i`` belongs to worker
``i % world``): it writes the leaves it owns, each gathered to it alone, and
rank 0 commits the manifest once every rank's part is written.  Every step
boundary agrees on one exit reason over the ranks (one all-reduce), so a
signal that reaches one rank checkpoints all of them at the same step, and
every rank exits with the same code.  Only rank 0 writes ``--metrics-out``,
the requeue record and the node-local promotion.

Preemption signals are recorded from the module's first lines, before torch
is imported (``core.signals.record_early``): a warning during start-up
becomes a checkpoint at the first step boundary and exit 85, not the
default action, which kills the process.

Runs on the GPU unless ``--device cpu`` is given; with no GPU and no
``--device cpu`` it fails.  Bit-identical resume on the card needs
deterministic kernels: ``CUBLAS_WORKSPACE_CONFIG`` is set before torch is
imported, deterministic algorithms on (``_deterministic``) and TF32 off while
``main`` runs.  ``--metrics-out`` writes ``{"steps": [{step, loss, t, ms}],
"saves": [per-save delta stats], "launches": {kernel: count},
"restore_s": ..., "restore_stats": {tier, bytes_by_tier, promoted, ...},
"start_step": ..., "ranks": {"world": W, "backend": "nccl" | "gloo" | null},
"ranks_start_s": seconds to join the group | null}``.
"""
from __future__ import annotations

if __name__ == "__main__":
    # first: record SIGTERM / SIGUSR1 while the imports below run (seconds;
    # tens of seconds on a loaded node), for main's trap to take over
    from repro_torch.core.signals import record_early

    record_early()

import os  # noqa: E402

# before torch is imported: cuBLAS picks its workspace (and with it the
# reduction order of its products) when it first starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
# and OpenMP its wait policy: a CPU run's threads sleep between parallel
# regions instead of spinning, which on a loaded node stalls them on one
# another (reduced qwen2, 8 cores shared with 48 busy processes: 20 s a step
# spinning, 0.8 s sleeping); the same threads, so the same results
os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")

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
from repro_torch.core.virtualization import fetch_tree, place_tree  # noqa: E402
from repro_torch.core.worker import CkptClient, GroupCoordinator, InlineCoordinator  # noqa: E402
from repro_torch.data.pipeline import PipelineState, SyntheticTokens  # noqa: E402
from repro_torch.kernels import checksum as CK  # noqa: E402
from repro_torch.kernels import flash_attention  # noqa: E402
from repro_torch.kernels import ssd as SSD  # noqa: E402
from repro_torch.kernels import wkv6 as WKV  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, start_ranks, stop_ranks  # noqa: E402
from repro_torch.launch.serve import resolve_device  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel.mesh_rules import Rules  # noqa: E402
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
    ap.add_argument("--worker-id", type=int, default=None,
                    help="this worker's id (default 0; a rank's is its RANK)")
    ap.add_argument("--num-workers", type=int, default=None,
                    help="workers writing each checkpoint (default 1; ranks: WORLD_SIZE)")
    ap.add_argument("--dist-timeout", type=float, default=600.0,
                    help="ranks: seconds a collective waits before it fails")
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--step-sleep", type=float, default=0.0,
                    help="artificial per-step delay (benchmark pacing)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; the kernels run only on cuda")
    return ap


def _deterministic(mode: bool) -> None:
    """``torch.use_deterministic_algorithms(mode)`` for eager code: the same
    flag, without the public call's import of ``torch._inductor`` to set the
    compiler's copy of it (nothing here is compiled).  That import pulls in
    dynamo, FSDP and sympy: 5-8 s of every started or requeued job's
    start-up on the H100 machine, before its restore begins."""
    torch._C._set_deterministic_algorithms(mode)


def _launch_counts() -> dict:
    """Launches so far of each kernel a train run can make."""
    return {"flash": flash_attention.launches, "ssd": SSD.launches, "wkv6": WKV.launches,
            "chunk_fingerprints": CK.fingerprint_launches}


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
    # the trap takes over a signal recorded since the module's first line
    # and traps from here on: a USR1 during start-up / restore must
    # checkpoint-and-requeue, not kill the process — the paper's startup-time
    # lesson (Fig. 2) applies to the C/R loop itself.
    trap = SignalTrap()
    trap.__enter__()
    if trap.early is not None:
        print(f"[train] signal {trap.early[0]} arrived during start-up ("
              f"{'before' if trap.early[1] else 'after'} torch finished importing): "
              "checkpoint at the first step boundary", flush=True)
    numerics = (torch.are_deterministic_algorithms_enabled(),
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    _deterministic(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        ranks = start_ranks(device, args.dist_timeout)
        start_s = time.perf_counter() - t0 if ranks is not None else None
        if ranks is not None:
            if args.coordinator:
                sys.exit("--coordinator with ranks: the ranks' process group "
                         "coordinates their checkpoints")
            given = (args.worker_id, args.num_workers)
            if given != (None, None) and given != (ranks.rank, ranks.world):
                sys.exit(f"--worker-id/--num-workers {given} contradict rank "
                         f"{ranks.rank} of {ranks.world}")
            device = ranks.device
        return _run(args, device, trap, ranks, start_s)
    finally:
        stop_ranks()
        _deterministic(numerics[0])
        torch.backends.cuda.matmul.allow_tf32 = numerics[1]
        torch.backends.cudnn.allow_tf32 = numerics[2]
        trap.__exit__(None, None, None)


def _run(args, device: torch.device, trap: SignalTrap, ranks, start_s) -> int:
    rank, world = ((ranks.rank, ranks.world) if ranks is not None
                   else (args.worker_id or 0, args.num_workers or 1))
    lead = ranks is None or rank == 0           # writes the run's records
    say = print if lead else (lambda *a, **k: None)
    prefix = f"[rank {rank}] " if ranks is not None and world > 1 else ""

    def log(msg: str) -> None:
        print(prefix + msg, flush=True)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    oc = adamw.OptConfig(lr=args.lr, warmup_steps=10, decay_steps=max(args.steps, 2))

    rules = Rules(make_host_mesh(device))
    train_step = TS.make_train_step(cfg, oc, rules=rules, microbatches=args.microbatches)

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
                              promote=args.ckpt_promote if lead else "off",
                              promote_tier=args.ckpt_promote_tier)
    ckpt = CheckpointManager(store, policy, worker_id=rank,
                             num_workers=world, peer_roots=peers,
                             node=node, registry=registry)

    if args.coordinator:
        host, port = args.coordinator.rsplit(":", 1)
        client = CkptClient(host, int(port), rank)
    elif ranks is not None:
        client = GroupCoordinator(ckpt.commit, rank=rank, world=world,
                                  written_fn=ckpt.wait_writes)
    else:
        client = InlineCoordinator(commit_fn=ckpt.commit)

    walltime = None
    if args.walltime:
        walltime = WalltimeTracker(args.walltime, args.margin,
                                   consumed_s=prior.get("consumed_s", 0.0))

    pipe = SyntheticTokens(cfg, args.batch, args.seq, seed=args.seed)
    launches0 = _launch_counts()

    crm = CRManager(ckpt, client=client, signal_trap=trap, walltime=walltime,
                    requeue_file=requeue_file,
                    interval_steps=args.interval_steps or None,
                    predump=args.ckpt_predump,
                    predump_lead=args.ckpt_predump_lead,
                    cfg=cfg, rules=rules, device=device, node=node,
                    peers=peers or None, ranks=ranks, log=log)

    # template for restore: the state's tree as meta tensors (host arrays are
    # laid out for the mesh by their logical axes)
    templates = {"state": TS.abstract_train_state(cfg, oc)}
    axes = {"state": TS.state_logical_axes(cfg)}

    def init_fn():
        if rules.mesh.size == 1:
            return TS.init_train_state(cfg, oc, args.seed, device)
        # every rank draws the same state (per-leaf generators) and keeps its blocks
        return place_tree(fetch_tree(TS.init_train_state(cfg, oc, args.seed, "cpu")),
                          axes["state"], rules, device)

    t0 = _synced(device)
    state, meta, start_step = crm.restore_or_init(init_fn, templates, axes)
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
            say(f"step {step} loss {loss:.4f}", flush=True)

        extra = {"data_state": pipe.state().to_dict()}
        action = crm.step_boundary(step, lambda: state, extra_meta=extra)
        if action == "exit":
            crm.request_requeue(step, reason=crm.exit_cause or "")
            log(f"[train] interrupted at step {step} -> requeue")
            exit_code = REQUEUE_EXIT
            break
    else:
        # run completed: final checkpoint so eval/serving can pick it up
        crm.checkpoint_now(args.steps - 1, lambda: state, reason="final",
                           extra_meta={"data_state": pipe.state().to_dict(),
                                       "completed": True})
        say(f"[train] completed {args.steps} steps", flush=True)

    if args.metrics_out and lead:
        Path(args.metrics_out).write_text(json.dumps({
            "steps": metrics_log, "saves": crm.saves,
            "launches": {k: n - launches0[k] for k, n in _launch_counts().items()},
            "restore_s": restore_s if meta is not None else None,
            "restore_stats": ckpt.last_restore_stats if meta is not None else None,
            "start_step": start_step, "device": str(device),
            "ranks": {"world": world if ranks is not None else 1,
                      "backend": ranks.backend if ranks is not None else None},
            "ranks_start_s": start_s}))
    crm.close()
    return exit_code


if __name__ == "__main__":
    code = main()
    # leave without tearing the interpreter down (seconds on a loaded node,
    # which a scheduler's hard limit may cut): the run's checkpoint is
    # committed and its group left; a signal that lands now is only recorded
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
