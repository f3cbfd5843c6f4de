"""Dry run: walk the port's own step of every (arch x shape x mesh) cell on meta tensors.

Each cell runs in a process of its own.  It starts a ``"fake"`` process
group of the mesh's size (this process is rank 0 of it; no device, no
communication: a collective returns at once) unless the mesh is one rank,
builds ``launch/mesh.py::make_mesh`` over it, places the abstract state
and batch (``launch/specs.py``) on this rank with ``Rules`` through
``core/virtualization.place_tree``, and runs the step on ``meta`` tensors
under ``launch/hlo_costs.py``'s walk.  The group is destroyed when the cell
ends.

The step is the port's own: ``train/step.py``'s train step (the batch's
rows per rank, the tensor-parallel modules on this rank's "model" blocks,
the MoE experts on their expert blocks moved to by all-to-alls, every other
leaf gathered whole, gradients reduce-scattered over the batch
ranks, the plain recompute as the kernels' backward), or, for serving,
``serve/engine.py``'s ``prefill_step`` / ``decode_step`` on this rank's rows,
on the parameters the engine computes on (``serving_params``: the same
blocks) and, for decode, the cache as the engine holds it (its
``serving_blocks`` as the rules' "model" blocks, every other leaf rows
only).  Where that differs from the reference's compiled step, the numbers
show it; nothing is scaled to match.

For each cell this writes results/dryrun_torch/<arch>__<shape>__<mesh>.json:
  - memory: ``argument_size`` (this rank's bytes of its arguments),
    ``output_size``, ``temp_size`` (the peak of the bytes the step
    allocated and still held, over the meta storages);
  - hlo_costs: the walk's FLOPs, bytes, collectives by kind (per rank);
  - trace_s, and ok / error / traceback.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all [--mesh pod|multipod|both]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config, shapes_for

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
MESHES = {"pod": (16, 16), "multipod": (2, 16, 16)}
# cells of --all run this many at a time, each in its own process
PARALLEL_CELLS = 4


def build_step(cfg, shape, rules, *, impl=None, microbatches=None, moment_dtype=None):
    """Returns (step function, its arguments placed on this rank of
    ``rules``' mesh, on the meta device)."""
    import torch

    from repro_torch.core.virtualization import cut_tree, place_tree
    from repro_torch.launch import specs as SP
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.parallel.mesh_rules import batch_logical_axes
    from repro_torch.serve import engine as E
    from repro_torch.train import step as TS
    from repro_torch.utils.tree import tree_map

    oc = adamw.OptConfig(moment_dtype=moment_dtype or (
        "bfloat16" if cfg.param_dtype == "bfloat16" else "float32"))
    kind, args = SP.input_specs(cfg, shape, oc)

    def place(tree, axes):
        return place_tree(tree, axes, rules, "meta")

    if kind == "train":
        state, batch = args
        step = TS.make_train_step(cfg, oc, rules=rules, impl=impl,
                                  microbatches=microbatches or SP.train_microbatches(cfg))
        return step, (place(state, TS.state_logical_axes(cfg)),
                      place(batch, batch_logical_axes(batch)))
    pax = M.param_logical_axes(cfg)

    def serving(params):
        return E.serving_params(cfg, params, rules, impl)

    if kind == "prefill":
        params, batch = args

        def prefill_step(params, batch):
            return E.prefill_step(cfg, rules, serving(params), batch, shape.seq_len, impl=impl)

        return prefill_step, (place(params, pax), place(batch, batch_logical_axes(batch)))
    params, cache, tokens = args
    cax = M.cache_logical_axes(cfg, shape.global_batch, shape.seq_len)
    blocks = M.serving_blocks(cfg) if E.computes_on_blocks(cfg, rules, impl) else set()

    def own(x):             # a meta leaf of its own (the walk tracks storages)
        return torch.empty(x.shape, dtype=x.dtype, device="meta")

    def decode_step(params, cache, tokens):
        return E.decode_step(cfg, rules, serving(params), tokens, cache, shape.seq_len,
                             shape.global_batch, impl=impl)

    tokens = cut_tree({"t": tokens}, {"t": ("batch",) + (None,) * (tokens.ndim - 1)},
                      rules)["t"]
    return decode_step, (place(params, pax), tree_map(own, cut_tree(cache, cax, rules, blocks)),
                         own(tokens))


def walk_cell(cfg, shape, mesh_shape, *, impl=None, microbatches=None, moment_dtype=None):
    """(the walk, its wall seconds) of one step of ``cfg`` at ``shape`` on
    rank 0 of a mesh of ``mesh_shape``: a fake process group of the mesh's
    size for its duration, none for a mesh of one rank."""
    import torch.distributed as dist

    from repro_torch.launch.hlo_costs import Walk
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.mesh_rules import Rules

    size = math.prod(mesh_shape)
    if size > 1:
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        rules = Rules(make_mesh(mesh_shape))
        step, args = build_step(cfg, shape, rules, impl=impl, microbatches=microbatches,
                                moment_dtype=moment_dtype)
        t0 = time.perf_counter()
        with Walk(args) as walk:
            out = step(*args)
        walk.finish(out)
        return walk, time.perf_counter() - t0
    finally:
        if size > 1:
            dist.destroy_process_group()


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, save: bool = True,
             ops_dir=None, tag: str = "", impl=None, microbatches=None,
             moment_dtype=None, cfg_overrides=None) -> dict:
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    mesh_shape = MESHES[mesh_kind]
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                 "mesh_shape": list(mesh_shape), "tag": tag,
                 "variant": {"impl": impl, "microbatches": microbatches,
                             "moment_dtype": moment_dtype,
                             "cfg_overrides": cfg_overrides}}
    suffix = f"__{tag}" if tag else ""
    t0 = time.time()
    try:
        walk, trace_s = walk_cell(cfg, SHAPES[shape_name], mesh_shape, impl=impl,
                                  microbatches=microbatches, moment_dtype=moment_dtype)
        rec["memory"] = walk.memory
        rec["hlo_costs"] = walk.costs()
        rec["hlo_costs"].pop("memory")
        if ops_dir:
            Path(ops_dir).mkdir(parents=True, exist_ok=True)
            (Path(ops_dir) / f"{arch}__{shape_name}__{mesh_kind}{suffix}.ops.json"
             ).write_text(json.dumps(walk.table))
        rec["trace_s"] = round(trace_s, 2)
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — record the failure, don't die
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 2)
    if save:
        out_dir = RESULTS if not tag else RESULTS.parent / "perf_torch"
        out_dir.mkdir(parents=True, exist_ok=True)
        out = out_dir / f"{arch}__{shape_name}__{mesh_kind}{suffix}.json"
        out.write_text(json.dumps(rec, indent=1))
    return rec


def all_cells(mesh_kinds=("pod", "multipod")):
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in shapes_for(cfg):
            for mk in mesh_kinds:
                yield arch, shape.name, mk


def _cell_process(arch, shape, mk, flags, tag) -> dict:
    """One cell in a process of its own; its record (the child saves it)."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(Path(__file__).resolve().parents[2]), os.environ.get("PYTHONPATH", "")])}
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                        "--shape", shape, "--mesh", mk, *flags], env=env,
                       capture_output=True, text=True)
    out = (RESULTS.parent / "perf_torch" / f"{arch}__{shape}__{mk}__{tag}.json" if tag
           else RESULTS / f"{arch}__{shape}__{mk}.json")
    if r.returncode not in (0, 1) or not out.exists():
        return {"ok": False,
                "error": f"the cell's process exited {r.returncode}: {r.stderr[-2000:]}"}
    return json.loads(out.read_text())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--ops-dir", default=None,
                    help="save each cell's per-op table here (roofline --reanalyze-ops)")
    # perf-variant knobs (results land in results/perf_torch/<...>__<tag>.json)
    ap.add_argument("--tag", default="")
    ap.add_argument("--attn-impl", default=None)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--moment-dtype", default=None)
    ap.add_argument("--cfg-override", action="append", default=[],
                    help="key=value (value eval'd), e.g. num_layers=8")
    args = ap.parse_args(argv)
    cfg_overrides = {}
    for kv in args.cfg_override:
        k, v = kv.split("=", 1)
        try:
            cfg_overrides[k] = eval(v)  # noqa: S307 — operator-supplied
        except Exception:
            cfg_overrides[k] = v
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    cells = (
        list(all_cells(meshes)) if args.all
        else [(args.arch, args.shape, mk) for mk in meshes]
    )
    todo = []
    n_ok = 0
    for arch, shape, mk in cells:
        out = RESULTS / f"{arch}__{shape}__{mk}.json"
        if args.skip_done and out.exists() and json.loads(out.read_text()).get("ok"):
            n_ok += 1
            print(f"SKIP {arch} {shape} {mk} (done)")
        else:
            todo.append((arch, shape, mk))

    def report(cell, rec):
        arch, shape, mk = cell
        status = "OK " if rec["ok"] else "FAIL"
        print(f"{status} {arch:24s} {shape:12s} {mk:8s} "
              f"trace={rec.get('trace_s', '-')}s {rec.get('error', '')}", flush=True)
        return int(rec["ok"])

    if len(todo) == 1:
        arch, shape, mk = todo[0]
        n_ok += report(todo[0], run_cell(
            arch, shape, mk, ops_dir=args.ops_dir, tag=args.tag, impl=args.attn_impl,
            microbatches=args.microbatches, moment_dtype=args.moment_dtype,
            cfg_overrides=cfg_overrides or None))
    elif todo:
        # each cell's process gets the variant's flags and its own cell
        flags = [f"--{k.replace('_', '-')}={v}" for k, v in vars(args).items()
                 if k in ("ops_dir", "tag", "attn_impl", "microbatches", "moment_dtype") and v]
        flags += [f"--cfg-override={kv}" for kv in args.cfg_override]
        with ThreadPoolExecutor(PARALLEL_CELLS) as pool:
            futures = [(c, pool.submit(_cell_process, *c, flags, args.tag)) for c in todo]
            for cell, fut in futures:
                n_ok += report(cell, fut.result())
    print(f"{n_ok}/{len(cells)} cells ok")
    return 0 if n_ok == len(cells) else 1


if __name__ == "__main__":
    sys.exit(main())
