"""Roofline analysis over the dry-run records, for one NVIDIA H100 SXM.

Reads results/dryrun_torch/<arch>__<shape>__<mesh>.json (written by
``launch/dryrun.py``) and derives, per cell and per rank:

    compute term    = FLOPs / PEAK_FLOPS[compute dtype]        [s]
    memory term     = HBM bytes / HBM_BYTES_PER_S              [s]
    collective term = collective bytes / LINK_BYTES_PER_S      [s]

The FLOPs, bytes and collective bytes are the counts of ``launch/
hlo_costs.py``'s walk of the port's own step, so the terms are those counts
over the card's published rates: derived, not measured.  The same
constants are the bounds of ``chip_smoke.py``'s kernel table.

MODEL_FLOPS uses the classic estimator per shape kind (per rank):
    train:   6 * N_active * tokens / chips
    prefill: 2 * N_active * tokens / chips
    decode:  2 * N_active * batch  / chips   (one new token per sequence)

useful_fraction = ideal time / the largest term: the share of the
bottleneck-limited step that would be useful model FLOPs at peak (for
decode, the weights and the live cache read once over HBM).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.configs.base import SHAPES, get_config

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at its 700 W limit:
# bf16 on the tensor cores; fp32 on the CUDA cores, which is also the rate
# taken for the checksum kernels' 32-bit integer operations (none is listed)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "uint32": 67e12}
HBM_BYTES_PER_S = 3.35e12        # HBM3, same data sheet
LINK_BYTES_PER_S = 450e9         # NVLink 4, 900 GB/s per GPU: 450 GB/s each direction

RESULTS = Path(__file__).resolve().parents[3] / "results"


def _dtype_bytes(name: str) -> int:
    return {"bfloat16": 2, "float32": 4, "int32": 4, "uint32": 4, "int64": 8}[name]


def model_flops(cfg, kind: str, global_batch: int, seq_len: int) -> float:
    """6ND (train), 2ND (prefill) or 2N x batch (decode) of one step of the
    whole batch, N the active parameters."""
    from repro_torch.models.model import count_active_params

    n = count_active_params(cfg)
    if kind == "train":
        return 6.0 * n * global_batch * seq_len
    if kind == "prefill":
        return 2.0 * n * global_batch * seq_len
    return 2.0 * n * global_batch      # decode: one token per sequence


def model_flops_per_device(arch: str, shape_name: str, chips: int) -> float:
    shape = SHAPES[shape_name]
    return model_flops(get_config(arch), shape.kind, shape.global_batch,
                       shape.seq_len) / chips


def decode_min_bytes_per_device(arch: str, shape_name: str, chips: int) -> float:
    """Decode ideal: every active-param byte + every live cache byte read once
    per token — the true decode roofline is HBM, not FLOPs."""
    from repro_torch.models.model import cache_specs, count_active_params

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    pbytes = count_active_params(cfg) * (2 if cfg.param_dtype == "bfloat16" else 4)
    return (pbytes + spec_bytes(cache_specs(cfg, shape.global_batch, shape.seq_len))) / chips


def spec_bytes(specs) -> int:
    """Bytes of a ``cache_specs`` tree of (shape, dtype name) leaves."""
    if isinstance(specs, dict):
        return sum(spec_bytes(v) for v in specs.values())
    shape, dt = specs
    n = 1
    for d in shape:
        n *= d
    return n * _dtype_bytes(dt)


def analyze_cell(rec: dict) -> dict:
    chips = 1
    for d in rec["mesh_shape"]:
        chips *= d
    hc = rec["hlo_costs"]
    peak = PEAK_FLOPS[get_config(rec["arch"]).compute_dtype]
    compute_s = hc["flops"] / peak
    memory_s = hc.get("bytes_native", hc["bytes"]) / HBM_BYTES_PER_S
    collective_s = hc.get("collective_bytes_native", hc["collective_bytes"]) / LINK_BYTES_PER_S
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops_per_device(rec["arch"], rec["shape"], chips)
    if SHAPES[rec["shape"]].kind == "decode":
        ideal_s = decode_min_bytes_per_device(rec["arch"], rec["shape"], chips) / HBM_BYTES_PER_S
    else:
        ideal_s = mf / peak
    frac = ideal_s / max(max(terms.values()), 1e-30)
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "chips": chips,
        "compute_s": compute_s, "memory_s": memory_s, "collective_s": collective_s,
        "dominant": dominant,
        "model_flops_per_dev": mf,
        "hlo_flops_per_dev": hc["flops"],
        "useful_ratio": mf / max(hc["flops"], 1e-30),
        "useful_fraction": frac,
        "collectives": hc.get("collectives", {}),
        "temp_bytes": rec.get("memory", {}).get("temp_size"),
        "arg_bytes": rec.get("memory", {}).get("argument_size"),
    }


_SUGGEST = {
    "compute": "cut non-model FLOPs: a backward kernel in place of the plain "
               "recompute, split the products over 'model' (tensor parallel)",
    "memory": "reduce HBM traffic: fewer float32 passes, no S x S scores in the "
              "attention backward, fuse normalizations",
    "collective": "gather each layer's parameters when it runs, not all at "
                  "once; reduce-scatter grads instead of all-reduce",
}


def render_table(cells: list[dict], mesh: str = "pod") -> str:
    rows = [c for c in cells if c["mesh"] == mesh]
    rows.sort(key=lambda c: (c["arch"], c["shape"]))
    out = ["| arch | shape | compute s | memory s | collective s | dominant | "
           "6ND/walk | useful frac | what would move the dominant term |",
           "|---|---|---|---|---|---|---|---|---|"]
    for c in rows:
        out.append(
            f"| {c['arch']} | {c['shape']} | {c['compute_s']:.3e} | "
            f"{c['memory_s']:.3e} | {c['collective_s']:.3e} | {c['dominant']} | "
            f"{c['useful_ratio']:.2f} | {c['useful_fraction']:.3f} | "
            f"{_SUGGEST[c['dominant']][:60]}… |")
    return "\n".join(out)


def load_cells(dryrun_dir: Path) -> list[dict]:
    cells = []
    for f in sorted(Path(dryrun_dir).glob("*.json")):
        rec = json.loads(f.read_text())
        if rec.get("ok") and "hlo_costs" in rec:
            cells.append(analyze_cell(rec))
    return cells


def reanalyze(dryrun_dir: Path, ops_dir: Path) -> int:
    """Re-run the cost model over the per-op tables the dry run saved
    (``--ops-dir``), without walking the steps again."""
    from repro_torch.launch.hlo_costs import costs_from_table

    n = 0
    for f in sorted(Path(dryrun_dir).glob("*.json")):
        rec = json.loads(f.read_text())
        tag = f"__{rec['tag']}" if rec.get("tag") else ""
        ops = Path(ops_dir) / f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{tag}.ops.json"
        if rec.get("ok") and ops.exists():
            rec["hlo_costs"] = costs_from_table(json.loads(ops.read_text()))
            f.write_text(json.dumps(rec, indent=1))
            n += 1
    return n


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun-dir", default=str(RESULTS / "dryrun_torch"))
    ap.add_argument("--mesh", default="pod")
    ap.add_argument("--out", default=str(RESULTS / "roofline_torch.json"))
    ap.add_argument("--reanalyze-ops", default=None,
                    help="re-run the cost model over the per-op tables in this directory")
    args = ap.parse_args(argv)
    if args.reanalyze_ops:
        n = reanalyze(Path(args.dryrun_dir), Path(args.reanalyze_ops))
        print(f"re-analyzed {n} cells from saved per-op tables")
    cells = load_cells(Path(args.dryrun_dir))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(cells, indent=1))
    print(render_table(cells, args.mesh))
    picks = sorted((c for c in cells if c["mesh"] == args.mesh),
                   key=lambda c: c["useful_fraction"])
    if picks:
        print("\nworst useful_fraction:",
              [(c["arch"], c["shape"], round(c["useful_fraction"], 4))
               for c in picks[:3]])
        coll = sorted((c for c in cells if c["mesh"] == args.mesh),
                      key=lambda c: -c["collective_s"] /
                      max(c["compute_s"] + c["memory_s"], 1e-30))
        print("most collective-bound:",
              [(c["arch"], c["shape"]) for c in coll[:3]])


if __name__ == "__main__":
    main()
