"""Smoke run of the PyTorch port (``repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

0. card: name and power limit (nvidia-smi), torch and CUDA versions;
1. build: compile every CUDA kernel of the serving path from ``src/repro_torch/csrc``
   (one nvcc per source, started together);
2. kernels: each kernel against its plain PyTorch version on the card, at the
   main path's shapes and a few others, with the tolerances of the reference
   package's kernel tests (2e-5 float32, 5e-2 bfloat16, against the plain
   version in float32); kernel, plain, library (``scaled_dot_product_attention``,
   timed only) and bound times at the main path's shape;
3. serve: ``repro_torch.launch.serve`` at the full width of qwen2-0.5b with a
   snapshot, migration and restore half way; the continuation must match the
   unmigrated run bit for bit, and the launch counts must show that every
   attention call went through the kernels;
4. reference: reduced qwen2-0.5b in float32, the card's path (kernels) against
   the CPU path (plain versions): equal greedy tokens, close logits;
5. profile: device time by kernel and the device's busy share over one
   prefill and over decode steps at the main path's shapes.

It prints a ``kernels`` JSON line and the card's name and power limit before
the last line, and as the last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense tensor-core bf16; fp32 FMA
TOL = {"float32": 2e-5, "bfloat16": 5e-2}
L2_BYTES = 50 * 2**20

SERVE_ARGV = ["--arch", "qwen2-0.5b", "--batch", "4", "--prompt-len", "512",
              "--gen", "32", "--max-seq", "1024", "--snapshot-at", "16"]
# 2 prefills x 24 layers; (32 + 16 + 16) decode steps x 24 layers
EXPECTED_LAUNCHES = {"flash": 48, "flash_decode": 1536}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, inputs, iters: int = 20) -> float:
    """Mean device time of ``fn(*inputs[i % len(inputs)])`` by CUDA events,
    after a warm-up; ``inputs`` rotates over enough copies to exceed L2."""
    import torch

    for i in range(3):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def copies_past_l2(tensors) -> list:
    """Enough copies of ``tensors`` that rotating through them keeps each
    launch's inputs out of the 50 MB L2, as a caller walking 24 layers finds
    them."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    n = max(1, min(64, math.ceil(2 * L2_BYTES / max(nbytes, 1))))
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


def bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    built = _build.build()
    secs = time.perf_counter() - t0
    for name, info in built.items():
        regs = [ln.strip() for ln in info["log"].splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"  built {name} in {info['seconds']:.1f}s")
        for ln in regs:
            log(f"    {ln}")
    log(f"build: {secs:.1f}s for {len(built)} libraries")


def _randn(shape, dtype, gen):
    import torch

    return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)


def phase_kernels() -> dict:
    """Every kernel against its plain version; timings at the main path's shape."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention, flash_attention, ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    report = {}

    # ---- flash -------------------------------------------------------------
    flash_cases = [  # B, S, H, Hkv, Dq, Dv, dtype, causal
        (4, 512, 14, 2, 64, 64, "bfloat16", True),     # the main path's prefill
        (2, 300, 14, 2, 64, 64, "float32", True),      # ragged length
        (1, 256, 8, 1, 128, 64, "float32", False),     # Dq != Dv, not causal
    ]
    worst = 0.0
    for B, S, H, Hkv, Dq, Dv, dtn, causal in flash_cases:
        q = _randn((B, S, H, Dq), dt[dtn], gen)
        k = _randn((B, S, Hkv, Dq), dt[dtn], gen)
        v = _randn((B, S, Hkv, Dv), dt[dtn], gen)
        got = flash_attention.flash(q, k, v, causal=causal)
        want = ref.attention(q.float(), k.float(), v.float(), causal=causal)
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        ok = err <= TOL[dtn] and bool(torch.isfinite(got).all())
        log(f"  flash B{B} S{S} H{H} Hkv{Hkv} Dq{Dq} Dv{Dv} {dtn} causal={causal}: "
            f"max_abs_err {err:.3g} (tol {TOL[dtn]}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash disagrees with its plain version: {err}")
        worst = max(worst, err)
    B, S, H, Hkv, D, _, dtn, _ = flash_cases[0]
    sets = copies_past_l2([_randn(s, dt[dtn], gen) for s in
                           ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D))])
    ms = timed_ms(lambda q, k, v: flash_attention.flash(q, k, v, causal=True), sets)
    plain_ms = timed_ms(lambda q, k, v: ref.attention(q, k, v, causal=True), sets)
    lib_sets = [tuple(t.transpose(1, 2) for t in s) for s in sets]
    library_ms = timed_ms(lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), lib_sets)
    elt = 2
    nbytes = elt * (2 * B * S * H * D + 2 * B * S * Hkv * D)
    flops = 2 * B * H * (S * (S + 1) // 2) * (D + D)
    b_ms, b_by = bound(nbytes, flops, dtn)
    report["flash"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                           library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
                           shape=f"B{B} S{S} H{H} Hkv{Hkv} D{D} {dtn} causal")
    log(f"  flash timing ({report['flash']['shape']}): kernel_ms {ms:.4f} "
        f"plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} bound_ms {b_ms:.5f} ({b_by})")

    # ---- flash_decode ------------------------------------------------------
    decode_cases = [  # B, S, H, Hkv, D, dtype, kv_lens
        (4, 1024, 14, 2, 64, "bfloat16", (1, 300, 544, 1024)),   # 544: end of the main path
        (2, 512, 8, 2, 64, "float32", (77,)),
    ]
    worst = 0.0
    for B, S, H, Hkv, D, dtn, kv_lens in decode_cases:
        q = _randn((B, 1, H, D), dt[dtn], gen)
        k = _randn((B, S, Hkv, D), dt[dtn], gen)
        v = _randn((B, S, Hkv, D), dt[dtn], gen)
        for kv_len in kv_lens:
            kvl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
            got = decode_attention.flash_decode(q, k, v, kv_len=kvl)
            want = ref.attention(q.float(), k.float(), v.float(), causal=False,
                                 kv_len=kv_len)
            again = decode_attention.flash_decode(q, k, v, kv_len=kvl)
            torch.cuda.synchronize()
            err = (got.float() - want).abs().max().item()
            same = torch.equal(got, again)
            ok = err <= TOL[dtn] and same and bool(torch.isfinite(got).all())
            log(f"  flash_decode B{B} S{S} H{H} Hkv{Hkv} D{D} {dtn} kv_len={kv_len}: "
                f"max_abs_err {err:.3g} (tol {TOL[dtn]}) repeatable={same} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash_decode disagrees with its plain version: {err}")
            worst = max(worst, err)
    B, S, H, Hkv, D, dtn, _ = decode_cases[0]
    kv_len = 544
    kvl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    sets = copies_past_l2([_randn(s, dt[dtn], gen) for s in
                           ((B, 1, H, D), (B, S, Hkv, D), (B, S, Hkv, D))])
    ms = timed_ms(lambda q, k, v: decode_attention.flash_decode(q, k, v, kv_len=kvl), sets)
    plain_ms = timed_ms(lambda q, k, v: ref.attention(q, k, v, causal=False, kv_len=kvl),
                        sets)
    lib_sets = [(q.transpose(1, 2), k[:, :kv_len].transpose(1, 2),
                 v[:, :kv_len].transpose(1, 2)) for q, k, v in sets]
    library_ms = timed_ms(lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, enable_gqa=True), lib_sets)
    nbytes = elt * (2 * B * H * D + 2 * B * kv_len * Hkv * D) + 4
    flops = 2 * B * H * kv_len * (D + D)
    b_ms, b_by = bound(nbytes, flops, dtn)
    report["flash_decode"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                                  library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
                                  shape=f"B{B} S{S} H{H} Hkv{Hkv} D{D} {dtn} kv_len={kv_len}")
    log(f"  flash_decode timing ({report['flash_decode']['shape']}): kernel_ms {ms:.4f} "
        f"plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} bound_ms {b_ms:.6f} ({b_by})")
    return report


def phase_serve(ckpt_dir: str) -> dict:
    """The port's serving path at full width, once, with the launch counts read
    around it."""
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.launch import serve

    args = serve.parse_args(SERVE_ARGV + ["--ckpt-dir", ckpt_dir])
    flash_attention.launches = 0
    decode_attention.launches = 0
    rep = serve.run(args)
    counts = {"flash": flash_attention.launches,
              "flash_decode": decode_attention.launches}
    log(f"  continuation {'MATCHES' if rep['match'] else 'DIVERGED FROM'} the "
        "unmigrated reference")
    log(f"  prefill_ms {rep['prefill_ms']:.3f} (second prefill {rep['prefill_warm_ms']:.3f})"
        f"  decode_ms_per_token "
        f"{rep['decode_ms_per_token']:.3f}  snapshot save_s {rep['save_s']:.4f} "
        f"restore_s {rep['restore_s']:.4f} bytes {rep['snapshot_bytes']}")
    log(f"  launches {counts} (expected {EXPECTED_LAUNCHES})")
    if not rep["match"]:
        raise AssertionError("the migrated continuation diverged")
    if not rep["logits_finite"]:
        raise AssertionError("non-finite logits")
    if counts != EXPECTED_LAUNCHES:
        raise AssertionError(f"launch counts {counts} != {EXPECTED_LAUNCHES}")
    return {"counts": counts, **rep}


def phase_profile(steps: int = 8) -> dict:
    """Where the device time of the serving path goes, at the main path's
    shapes, over one prefill and over ``steps`` decode steps.  Each window is
    run twice: untraced, for its host-clock wall time, then under
    ``torch.profiler`` for the time of every device kernel.  Device busy
    share = summed kernel time over the untraced wall time; the traced
    window's extra wall time is the profiler's own cost."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import get_config
    from repro_torch.serve.engine import Engine
    from repro_torch.models import model as M

    cfg = get_config("qwen2-0.5b")
    model = M.init_params(cfg, 0, "cuda")
    prompts = {"tokens": torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 512)),
        dtype=torch.int32, device="cuda")}
    eng = Engine(cfg, model, batch=4, max_seq=1024)
    eng.prefill(prompts)
    eng.generate(2)                                    # warm

    def timed(name, prof=None):
        if name == "decode":
            eng.prefill(prompts)        # a fresh cache; the window starts after it
        torch.cuda.synchronize()
        with prof or contextlib.nullcontext():
            t0 = time.perf_counter()
            (eng.prefill(prompts) if name == "prefill" else eng.generate(steps))
            torch.cuda.synchronize()
            return time.perf_counter() - t0

    out = {}
    for name, per in (("prefill", 1), ("decode", steps)):
        wall_s = timed(name)
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        traced_s = timed(name, prof)
        rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        busy_s = sum(r[1] for r in rows) / 1e6
        rows.sort(key=lambda r: -r[1])
        log(f"  {name}: wall {wall_s / per * 1e3:.3f} ms per call untraced "
            f"({traced_s / per * 1e3:.3f} traced), device kernels {busy_s / per * 1e3:.3f} ms "
            f"= {100 * busy_s / wall_s:.1f}% busy")
        for key, us, n in rows[:8]:
            log(f"    {100 * us / 1e6 / busy_s:5.1f}%  {us / per / 1e3:8.4f} ms  "
                f"x{n // per:<4d} {key[:90]}")
        out[name] = {"wall_ms": wall_s / per * 1e3, "busy_ms": busy_s / per * 1e3,
                     "busy_share": busy_s / wall_s}
    return out


def phase_reference(steps: int = 8) -> dict:
    """Reduced qwen2-0.5b in float32: the card's path against the CPU path."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models import model as M

    cfg = reduced(get_config("qwen2-0.5b"))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    out = {}
    for device in ("cpu", "cuda"):
        lm = M.init_params(cfg, seed=0, device=device)
        logits, cache = M.prefill(lm, cfg, {"tokens": torch.from_numpy(tokens).to(device)}, 64)
        toks, all_logits = [], [logits.cpu()]
        nxt = logits.argmax(-1).to(torch.int32)
        for _ in range(steps):
            toks.append(nxt.cpu())
            logits, cache = M.decode_step(lm, cfg, nxt, cache)
            all_logits.append(logits.cpu())
            nxt = logits.argmax(-1).to(torch.int32)
        out[device] = (torch.stack(toks, 1), torch.stack(all_logits, 1))
    same = torch.equal(out["cpu"][0], out["cuda"][0])
    err = (out["cpu"][1] - out["cuda"][1]).abs().max().item()
    log(f"  reduced qwen2 f32 cuda vs cpu: tokens equal={same} max logit err {err:.3g}")
    if not same or err > 1e-3 or not math.isfinite(err):
        raise AssertionError("the card's path disagrees with the CPU path")
    return {"tokens_equal": same, "max_logit_err": err}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # float32 products in full float32 on the card, as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"phase 0 card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    log("phase 1 build")
    phase_build()
    log("phase 2 kernels against their plain versions")
    kern = phase_kernels()
    log("phase 3 serve qwen2-0.5b at full width with snapshot/migrate/restore")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        serve_rep = phase_serve(tmp)
    log("phase 4 reduced model: card against CPU")
    phase_reference()
    log("phase 5 where the serving path's device time goes (torch.profiler)")
    phase_profile()

    sources = {"flash": ("src/repro_torch/csrc/flash_attention.cu",
                         "src/repro/kernels/flash_attention.py:75"),
               "flash_decode": ("src/repro_torch/csrc/decode_attention.cu",
                                "src/repro/kernels/decode_attention.py:74")}
    kernels = []
    for name, (src, replaces) in sources.items():
        r = kern[name]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": serve_rep["counts"][name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
