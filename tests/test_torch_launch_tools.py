"""The port's analysis tools against the reference's, on the CPU.

1. ``launch/specs.py``: ``input_specs`` gives the reference's leaves, shape
   and dtype, for all ten archs at every one of ``shapes_for``, as meta
   tensors.
2. ``launch/roofline.py``: ``model_flops_per_device`` and
   ``decode_min_bytes_per_device`` equal the reference's for every arch x
   shape x chips in {1, 256, 512}; its constants are the H100's, and no TPU
   constant (197e12, 819e9, 50e9) is anywhere in the port.
3. ``kernels/costs.py``: each formula equals the arithmetic that
   ``chip_smoke.py`` phase 2 used before it, at every shape of PERF.md's
   kernel table, and with the roofline's constants each bound reads as that
   table prints it.
4. Each kernel wrapper's meta route gives its plain version's output shapes
   and dtypes, and launches nothing.
5. ``launch/hlo_costs.py``'s walk counts small programs exactly: a matmul,
   a slice update and a slice read, the peak of temporaries, a kernel's
   charge (its plain version's ops not counted again), and an all-gather
   plus an all-reduce on a fake group of 8 ranks (in a subprocess: a
   process group lives as long as its process).
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs.base import get_config as ref_get_config
from repro.launch import roofline as RR
from repro.launch import specs as RSP
from repro.utils.tree import flatten_with_names as ref_flatten
from repro_torch.configs.base import ARCH_IDS, get_config, shapes_for
from repro_torch.kernels import checksum as CK
from repro_torch.kernels import costs, decode_attention, flash_attention
from repro_torch.kernels import ssd as SSD
from repro_torch.kernels import wkv6 as WKV
from repro_torch.launch import roofline as R
from repro_torch.launch import specs as SP
from repro_torch.launch.hlo_costs import analyze_step
from repro_torch.utils.tree import flatten_with_names

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")

CELLS = [(a, s.name) for a in ARCH_IDS for s in shapes_for(get_config(a))]


# ----------------------------------------------------------------------------------
# 1. specs
# ----------------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_input_specs_equal_the_reference(arch, shape):
    from repro.configs.base import SHAPES as REF_SHAPES
    from repro_torch.configs.base import SHAPES

    kind, args = SP.input_specs(get_config(arch), SHAPES[shape])
    ref_kind, ref_args = RSP.input_specs(ref_get_config(arch), REF_SHAPES[shape])
    assert kind == ref_kind
    got = {n: (tuple(x.shape), str(x.dtype).removeprefix("torch."), x.device.type)
           for n, x in flatten_with_names(list(args))}
    want = {n: (tuple(x.shape), str(x.dtype), "meta") for n, x in ref_flatten(list(ref_args))}
    assert got == want
    assert SP.train_microbatches(get_config(arch)) == RSP.train_microbatches(ref_get_config(arch))


# ----------------------------------------------------------------------------------
# 2. roofline
# ----------------------------------------------------------------------------------


def test_model_flops_and_decode_bytes_equal_the_reference():
    n = 0
    for arch, shape in CELLS:
        for chips in (1, 256, 512):
            assert R.model_flops_per_device(arch, shape, chips) == \
                RR.model_flops_per_device(arch, shape, chips), (arch, shape, chips)
            if shape.startswith(("decode", "long")):
                assert R.decode_min_bytes_per_device(arch, shape, chips) == \
                    RR.decode_min_bytes_per_device(arch, shape, chips), (arch, shape, chips)
                n += 1
    assert n >= 3 * 12          # every decode cell of every arch


def test_roofline_constants_are_the_h100s_and_no_tpu_constant_is_in_the_port():
    assert R.PEAK_FLOPS["bfloat16"] == 989e12 and R.PEAK_FLOPS["float32"] == 67e12
    assert R.HBM_BYTES_PER_S == 3.35e12 and R.LINK_BYTES_PER_S == 450e9
    tpu = {197e12, 819e9, 50e9}
    assert not tpu & {*R.PEAK_FLOPS.values(), R.HBM_BYTES_PER_S, R.LINK_BYTES_PER_S}
    pattern = re.compile(r"(?<![\w.])(197e12|819e9|50e9|197_?000_?000_?000_?000|"
                         r"819_?000_?000_?000|50_?000_?000_?000)(?![\w.])")
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [(str(p.relative_to(ROOT)), m.group(0)) for p in files
            for m in pattern.finditer(p.read_text())]
    assert not hits


def test_analyze_cell_reads_a_record():
    rec = {"arch": "qwen2-0.5b", "shape": "train_4k", "mesh": "pod", "mesh_shape": [16, 16],
           "hlo_costs": {"flops": 989e12, "bytes": 3.35e12, "collective_bytes": 900e9},
           "memory": {"argument_size": 1, "temp_size": 2}}
    c = R.analyze_cell(rec)
    assert (c["compute_s"], c["memory_s"], c["collective_s"]) == (1.0, 1.0, 2.0)
    assert c["dominant"] == "collective" and c["chips"] == 256
    assert c["model_flops_per_dev"] == RR.model_flops_per_device("qwen2-0.5b", "train_4k", 256)
    assert c["useful_fraction"] == pytest.approx(c["model_flops_per_dev"] / 989e12 / 2.0)


# ----------------------------------------------------------------------------------
# 3. the kernels' formulas: the arithmetic chip_smoke.py phase 2 used before
# ----------------------------------------------------------------------------------

# PERF.md's kernel table: (B, S, H, Hkv, Dq, Dv, bound ms as printed)
FLASH_ROWS = [(4, 512, 14, 2, 64, 64, "0.00250"), (4, 512, 32, 32, 64, 64, "0.01002"),
              (8, 128, 14, 2, 64, 64, "0.00125"), (8, 128, 32, 32, 64, 64, "0.00501"),
              (4, 512, 32, 8, 128, 128, "0.01252"), (4, 512, 24, 8, 64, 64, "0.00501"),
              (4, 512, 128, 128, 192, 128, "0.10016"), (2, 24, 4, 4, 48, 32, "0.00002"),
              (8, 128, 24, 8, 64, 64, "0.00250"), (8, 128, 128, 128, 192, 128, "0.05008")]
# (B, S, H, Hkv, Dq, Dv, kv_len, V a view of K's rows, bound ms as printed)
DECODE_ROWS = [(4, 1024, 14, 2, 64, 64, 544, False, "0.00034"),
               (4, 1024, 32, 32, 64, 64, 544, False, "0.00533"),
               (4, 1024, 32, 8, 128, 128, 544, False, "0.00268"),
               (4, 1024, 24, 8, 64, 64, 544, False, "0.00134"),
               (4, 1024, 128, 1, 576, 512, 544, True, "0.00108"),
               (2, 64, 4, 1, 48, 32, 32, True, "0.000002")]
SSD_ROWS = [((4, 512, 64, 64, 64), True, "0.01150"), ((8, 128, 64, 64, 64), False, "0.00513")]
WKV_ROWS = [((4, 512, 32, 64), True, "0.01315"), ((8, 128, 32, 64), False, "0.00626")]
WORDS = 519 * 262144             # the embed table's aligned body, 519 x 1 MiB


def _old_ssd_flops(B, S, H, P, N, Q=64):
    per = 0
    for t0 in range(0, S, Q):
        L = min(Q, S - t0)
        tri = L * (L + 1) // 2
        per += tri * (2 * N + 2) + tri * 2 * P + L * P * (2 * N + 4) + P * N * (3 * L + 2)
    return B * H * per


def _bound(flops, nbytes, dtype, digits):
    ms = max(nbytes / R.HBM_BYTES_PER_S, flops / R.PEAK_FLOPS[dtype]) * 1e3
    return f"{ms:.{digits}f}"


def test_kernel_formulas_equal_the_arithmetic_they_replace():
    elt = 2
    for B, S, H, Hkv, Dq, Dv, shown in FLASH_ROWS:
        old = (2 * B * H * (S * (S + 1) // 2) * (Dq + Dv),
               elt * (B * S * H * (Dq + Dv) + B * S * Hkv * (Dq + Dv)))
        assert costs.flash(B, S, S, H, Hkv, Dq, Dv, elt) == old
        assert _bound(*old, "bfloat16", len(shown) - 2) == shown
    for B, S, H, Hkv, Dq, Dv, kv_len, absorbed, shown in DECODE_ROWS:
        v_bytes = 0 if absorbed else B * kv_len * Hkv * Dv
        old = (2 * B * H * kv_len * (Dq + Dv),
               elt * (B * H * (Dq + Dv) + B * kv_len * Hkv * Dq + v_bytes) + 4)
        assert costs.flash_decode(B, S, H, Hkv, Dq, Dv, kv_len, elt, v_is_k=absorbed) == old
        assert _bound(*old, "bfloat16", len(shown) - 2) == shown
    for (B, S, H, P, N), state_out, shown in SSD_ROWS:
        old = (_old_ssd_flops(B, S, H, P, N),
               elt * (2 * B * S * H * P + B * S * H + 2 * B * S * N) + 8 * H
               + state_out * 4 * B * H * P * N)
        assert costs.ssd(B, S, H, P, N, elt, state_out=state_out) == old
        assert _bound(*old, "bfloat16", 5) == shown
    for (B, S, H, D), state_out, shown in WKV_ROWS:
        old = (B * S * H * (4 * D * D + 5 * D),
               elt * 5 * B * S * H * D + 4 * H * D + state_out * 4 * B * H * D * D)
        assert costs.wkv6(B, S, H, D, elt, state_out=state_out) == old
        assert _bound(*old, "bfloat16", 5) == shown
    assert costs.chunk_fingerprints(WORDS, 262144) == (6 * WORDS, 4 * WORDS + 4 * 519)
    assert costs.checksum(WORDS) == (6 * WORDS, 4 * WORDS + 4)
    for f in (costs.chunk_fingerprints(WORDS, 262144), costs.checksum(WORDS)):
        assert _bound(*f, "uint32", 5) == "0.16245"


def test_call_formulas_read_the_wrappers_arguments():
    q = torch.empty(2, 30, 4, 32, device="meta")
    k = torch.empty(2, 30, 2, 32, device="meta")
    assert costs.flash_call(q, k, k) == costs.flash(2, 30, 30, 4, 2, 32, 32, 4)
    assert costs.flash_call(q, k, k, causal=False) == costs.flash(2, 30, 30, 4, 2, 32, 32, 4,
                                                                  False)
    cache = torch.empty(2, 64, 1, 48, device="meta")
    q1 = torch.empty(2, 1, 4, 48, device="meta")
    absorbed = costs.flash_decode(2, 64, 4, 1, 48, 32, 64, 4, v_is_k=True)
    assert costs.flash_decode_call(q1, cache, cache[..., :32]) == absorbed
    assert costs.flash_decode_call(q1, cache, cache[..., :32].clone(), kv_len=10) == \
        costs.flash_decode(2, 64, 4, 1, 48, 32, 10, 4)
    # a causal prefill longer than its keys: every query past them sees all
    assert costs.flash(1, 5, 3, 1, 1, 1, 1, 1)[0] == 2 * (1 + 2 + 3 + 3 + 3) * 2


# ----------------------------------------------------------------------------------
# 4. the meta routes
# ----------------------------------------------------------------------------------


def _rand(*shape, dtype=torch.float32):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(sum(shape)),
                       dtype=torch.float32).to(dtype)


def _meta(tree):
    return [t.to("meta") if isinstance(t, torch.Tensor) else t for t in tree]


def _cases():
    q, k, v = _rand(2, 17, 4, 32), _rand(2, 17, 2, 32), _rand(2, 17, 2, 64)
    q1, cache = _rand(2, 1, 4, 48), _rand(2, 40, 1, 48)
    x, dt = _rand(2, 20, 3, 8), _rand(2, 20, 3).abs()
    A, Bm, Cm, D = _rand(3), _rand(2, 20, 16), _rand(2, 20, 16), _rand(3)
    r, w, u = _rand(2, 20, 3, 16), _rand(2, 20, 3, 16).sigmoid(), _rand(3, 16)
    words = torch.arange(100, dtype=torch.int32)
    return {
        "flash": (flash_attention.flash, [q, k, v], {}),
        "flash bf16": (flash_attention.flash, [t.bfloat16() for t in (q, k, v)], {}),
        "flash_decode": (decode_attention.flash_decode, [q[:, :1], k, k], {"kv_len": 9}),
        "flash_decode MLA": (decode_attention.flash_decode, [q1, cache, None], {}),
        "ssd": (SSD.ssd, [x, dt, A, Bm, Cm, D], {}),
        "ssd state": (SSD.ssd, [x.bfloat16(), dt.bfloat16(), A, Bm.bfloat16(), Cm.bfloat16(),
                                D], {"init_state": _rand(2, 3, 8, 16), "return_state": True}),
        "wkv6": (WKV.wkv6, [r, r, r, w, u], {"return_state": True}),
        "chunk_fingerprints": (CK.chunk_fingerprints, [words, 8], {}),
        "checksum": (CK.checksum, [words], {}),
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_meta_route_gives_the_plain_versions_shapes_and_dtypes(case):
    fn, args, kw = _cases()[case]
    if case == "flash_decode MLA":                   # V: a view of the cache's rows
        args = [args[0], args[1], args[1][..., :32]]
        margs = [args[0].to("meta"), args[1].to("meta")]
        margs.append(margs[1][..., :32])
    else:
        margs = _meta(args)
    mkw = {k: v.to("meta") if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
    launches = (flash_attention.launches, decode_attention.launches, SSD.launches,
                WKV.launches, CK.fingerprint_launches, CK.checksum_launches)
    want, got = fn(*args, **kw), fn(*margs, **mkw)
    want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
    assert [(tuple(t.shape), t.dtype) for t in got] == [(tuple(t.shape), t.dtype) for t in want]
    assert all(t.is_meta for t in got)
    assert launches == (flash_attention.launches, decode_attention.launches, SSD.launches,
                        WKV.launches, CK.fingerprint_launches, CK.checksum_launches)


def test_meta_route_keeps_the_autograd_path():
    """Under autograd a meta call goes through the kernel's autograd function,
    as on the card: its backward is the plain recompute, on meta tensors."""
    q, k, v = (torch.empty(1, 8, 2, 32, device="meta", requires_grad=True) for _ in range(3))
    out = flash_attention.flash(q, k, v)
    assert type(out.grad_fn).__name__ == "_FlashBackward"
    grads = torch.autograd.grad(out.sum(), (q, k, v))
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]


# ----------------------------------------------------------------------------------
# 5. the walk, on small programs
# ----------------------------------------------------------------------------------


def test_walk_counts_a_matmul_exactly():
    a, b = torch.randn(64, 32), torch.randn(32, 16)
    c = analyze_step(torch.mm, a, b)
    assert c["flops"] == 2 * 64 * 32 * 16
    assert c["bytes"] == c["bytes_native"] == 4 * (64 * 32 + 32 * 16 + 64 * 16)
    assert c["memory"] == {"argument_size": 4 * (64 * 32 + 32 * 16), "output_size": 4 * 64 * 16,
                           "temp_size": 4 * 64 * 16}
    assert c["collectives"] == {} and c["unknown_while"] == 0


def test_walk_charges_a_slice_update_and_a_slice_read_by_the_slice():
    buf, upd = torch.zeros(10, 8), torch.ones(8)

    def step(buf, upd):
        buf[3].copy_(upd)                 # in place, into a view: 2 x the update
        return buf[5:7] * 2               # a view read by its consumer: 2 rows in, 2 out

    c = analyze_step(step, buf, upd)
    assert c["bytes"] == 2 * 8 * 4 + (2 + 2) * 8 * 4
    assert c["flops"] == 0
    assert c["memory"]["temp_size"] == 2 * 8 * 4      # the update wrote into the argument


def test_walk_tracks_the_peak_of_temporaries():
    a = torch.empty(1000, device="meta")
    c = analyze_step(lambda a: ((a * 2) * 3).sum(), a)
    # a*2 lives while (a*2)*3 is made, then goes: the sum finds one of them
    assert c["memory"]["temp_size"] == 2 * 4000
    assert c["memory"]["output_size"] == 4


def test_walk_charges_a_kernel_once_on_the_cpu_and_on_meta():
    q, k = torch.randn(2, 16, 4, 32), torch.randn(2, 16, 2, 32)
    want = costs.flash(2, 16, 16, 4, 2, 32, 32, 4)
    for args in ((q, k), (q.to("meta"), k.to("meta"))):
        c = analyze_step(lambda q, k: flash_attention.flash(q, k, k), *args)
        assert c["kernels"] == {"flash": {"calls": 1, "flops": want[0], "bytes": want[1]}}
        # the plain version's einsums on the CPU are the kernel's charge, not more
        assert (c["flops"], c["bytes"]) == want


_COLLECTIVES = """
import json, torch, torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.hlo_costs import analyze_step
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)

def step(x, y):
    g = funcol.all_gather_tensor(x, 0, dist.group.WORLD)     # the functional form
    out = torch.empty(8 * 64, device="meta")
    dist.all_gather_into_tensor(out, x)                       # the c10d form
    dist.all_reduce(y)
    return g.sum() + out.sum() + y.sum()

c = analyze_step(step, torch.empty(64, device="meta"), torch.empty(3, 5, device="meta"))
dist.destroy_process_group()
print(json.dumps({k: c[k] for k in ("collectives", "collective_counts", "collective_bytes")}))
"""


def test_walk_counts_collectives_on_a_fake_group_of_8():
    env = {**os.environ, "PYTHONPATH": SRC}
    r = subprocess.run([sys.executable, "-c", _COLLECTIVES], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    got = json.loads(r.stdout.strip().splitlines()[-1])
    # an all-gather is charged its operand (the shard), an all-reduce its result
    assert got == {"collectives": {"all-gather": 2 * 64 * 4, "all-reduce": 15 * 4},
                   "collective_counts": {"all-gather": 2, "all-reduce": 1},
                   "collective_bytes": 2 * 64 * 4 + 15 * 4}


def test_roofline_reanalyzes_a_record_from_its_saved_table(tmp_path, capsys):
    """``roofline --reanalyze-ops`` rebuilds a record's costs from the per-op
    table the dry run saved, then prints the cell's row (a mesh of one rank:
    no process group in this process)."""
    from repro_torch.configs.base import ShapeConfig, reduced
    from repro_torch.launch import dryrun

    walk, _ = dryrun.walk_cell(reduced(get_config("qwen2-0.5b")),
                               ShapeConfig("train", "train", 32, 8), (1, 1))
    want = {k: v for k, v in walk.costs().items() if k != "memory"}
    rec = {"arch": "qwen2-0.5b", "shape": "train_4k", "mesh": "pod", "mesh_shape": [1, 1],
           "tag": "", "ok": True, "memory": walk.memory,
           "hlo_costs": {**want, "flops": 0.0, "bytes": 0.0}}
    (tmp_path / "dry").mkdir()
    (tmp_path / "ops").mkdir()
    (tmp_path / "dry" / "qwen2-0.5b__train_4k__pod.json").write_text(json.dumps(rec))
    (tmp_path / "ops" / "qwen2-0.5b__train_4k__pod.ops.json").write_text(json.dumps(walk.table))
    R.main(["--dryrun-dir", str(tmp_path / "dry"), "--reanalyze-ops", str(tmp_path / "ops"),
            "--out", str(tmp_path / "roofline.json")])
    got = json.loads((tmp_path / "dry" / "qwen2-0.5b__train_4k__pod.json").read_text())
    assert got["hlo_costs"] == json.loads(json.dumps(want))
    assert want["flops"] > 0 and want["kernels"]["flash"]["calls"] == 16
    out = capsys.readouterr().out
    assert "re-analyzed 1 cells" in out and "| qwen2-0.5b | train_4k |" in out
    cells = json.loads((tmp_path / "roofline.json").read_text())
    assert [c["hlo_flops_per_dev"] for c in cells] == [want["flops"]]
