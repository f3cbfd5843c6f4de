"""Smoke run of the PyTorch port (``repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

0. card: name and power limit (nvidia-smi), torch and CUDA versions;
1. build: compile every CUDA kernel from ``src/repro_torch/csrc`` (one nvcc
   per source, started together);
2. kernels: each kernel against its plain PyTorch version on the card, at the
   main paths' shapes and a few others, with the tolerances of the reference
   package's kernel tests (attention 2e-5 float32, 5e-2 bfloat16, against the
   plain version in float32, and in bfloat16 also element by element within
   atol + 1e-2 |plain|, atol 5e-3 for flash and 1e-4 for flash_decode; the SSM scans 5e-5 (SSD) and 1e-4 (WKV6) in
   float32 and 1e-2 in bfloat16, at the main widths relative to each
   output's largest |plain| value, and in bfloat16 also element by element
   within atol + 1e-2 |plain| (SSD y 2e-2, state 4e-3; WKV6 y 7e-2, state
   8e-3); the integer checksum kernels bit for bit), with bit-equal reruns,
   the flash kernel's gradient under autograd, and at every main-path shape
   of each kernel: its device time and the library call's (torch.profiler's
   kernel time per call, median/min/max of 5), its
   call time (back-to-back calls between CUDA events, bounded by the host),
   the plain version's time (events) and the bound;
3. serve: ``repro_torch.launch.serve`` at full width and depth with a
   snapshot, migration and restore half way, for qwen2-0.5b, zamba2-1.2b,
   rwkv6-1.6b and qwen3-4b in turn; each continuation must match the
   unmigrated run bit for bit, the snapshot must be the cache's bytes
   (EXPECTED_SNAPSHOT_BYTES), and the launch counts must show that every
   attention and SSM scan call went through the kernels;
4. reference: reduced qwen2-0.5b, zamba2-1.2b, rwkv6-1.6b, qwen3-4b and
   granite-8b in float32, the card's path (kernels) against the CPU path
   (plain versions): equal greedy tokens, close logits;
5. profile: device time by kernel and the device's busy share over one
   prefill and over decode steps at the serve phases' shapes, per arch;
6. train state: the full-width qwen2-0.5b train state (params, AdamW m and v:
   5.93 GB) after one step, fingerprinted whole on the card and held against
   the plain version and the host's fingerprints, with the tree call timed;
   one profiled train step; the same state saved twice with device
   fingerprints (the second save must copy no byte) and once on the host path;
7. train: the C/R loop through ``repro_torch.launch.train --ckpt-delta
   --ckpt-device-fp`` at full width, as subprocesses: A uninterrupted, B cut
   by its walltime (exit 85), C requeued on B's checkpoint; A and C must end
   on the same loss and the same chunk hashes, and the launch counts must
   show every attention and every save's fingerprinting on the kernels;
8. fleet: a publisher pushes full-width qwen2-0.5b weights (delta
   checkpoints and the registry's push plane); ``repro_torch.launch.serve
   --follow --pipeline-uploads`` as a subprocess must serve the step pushed
   while it runs, with the launches its last line reports, and the same
   follower wiring in this process must give, after its swap, the tokens of
   a fresh engine on the pushed weights;
9. scheduler: ``SlurmSim`` with two nodes runs phase 7's trainer with
   ``--ckpt-promote eager``, preempted (SIGTERM) after its first step: it
   must exit 85, be requeued onto its warm node, exit 0, and end on run A's
   losses and chunk hashes.

It prints a ``kernel_shapes`` JSON line (every timed shape with its launches
on the main paths), a ``kernels`` JSON line (each kernel at its first shape)
and the card's name and power limit before the last line, and as the last
line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
# dense tensor-core bf16; fp32 FMA on the CUDA cores, also the rate taken for
# the checksum kernels' 32-bit integer operations (the guide lists no int32 rate)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "uint32": 67e12}
TOL = {"float32": 2e-5, "bfloat16": 5e-2}
# bfloat16 attention also element by element: |kernel - plain| <= atol + rtol
# |plain|.  rtol covers the output's rounding to bfloat16 (at most 2^-8 of
# |plain|); atol what the arithmetic adds: flash's P rounded to bfloat16
# before P V (a CPU model of it needs 1.8e-3-2.4e-3), decode's fp32 sums.  A
# typical |plain| is 0.03-0.14 at the main shapes, so TOL alone would hide a
# lost split.
ATTN_BF16_TOL = {"flash": (5e-3, 1e-2), "flash_decode": (1e-4, 1e-2)}
L2_BYTES = 50 * 2**20

SERVE_ARGV = ["--batch", "4", "--prompt-len", "512", "--gen", "32", "--max-seq", "1024",
              "--snapshot-at", "16"]
# launches of one serve run: 2 prefills and (32 + 16 + 16) decode steps
EXPECTED_LAUNCHES = {
    # 24 attention layers
    "qwen2-0.5b": {"flash": 48, "flash_decode": 1536, "ssd": 0, "wkv6": 0},
    # 38 mamba2 layers; 6 shared-attention calls
    "zamba2-1.2b": {"flash": 12, "flash_decode": 384, "ssd": 76, "wkv6": 0},
    # 24 rwkv6 layers, no attention
    "rwkv6-1.6b": {"flash": 0, "flash_decode": 0, "ssd": 0, "wkv6": 48},
    # 36 attention layers, head dim 128, 32 query / 8 KV heads
    "qwen3-4b": {"flash": 72, "flash_decode": 2304, "ssd": 0, "wkv6": 0},
}
SERVE_ARCHS = tuple(EXPECTED_LAUNCHES)
# bytes of one serve snapshot at the serve argv (batch 4, cache 1024): the
# cache, ``t`` (4 bytes) and the last tokens (4 x 4 bytes)
EXPECTED_SNAPSHOT_BYTES = {
    # 24 layers x K,V x 4 x 1024 x 2 KV heads x 64 x bfloat16
    "qwen2-0.5b": 50_331_668,
    # 38 mamba2 layers' float32 SSM and bfloat16 conv states, the shared
    # attention block's bfloat16 KV caches
    "zamba2-1.2b": 364_562_452,
    # 24 rwkv6 layers' float32 WKV states and bfloat16 token-shift rows
    "rwkv6-1.6b": 51_118_100,
    # 36 layers x K,V x 4 x 1024 x 8 KV heads x 128 x bfloat16
    "qwen3-4b": 603_979_796,
}
# bfloat16: relative to the largest |plain| value of each output; the kernel
# rounds y to bfloat16, at most 2^-8 of |y|
SCAN_TOL = {"ssd": {"float32": 5e-5, "bfloat16": 1e-2},
            "wkv6": {"float32": 1e-4, "bfloat16": 1e-2}}
# bfloat16 scans also element by element, each output apart: |kernel - plain|
# <= atol + rtol |plain|.  rtol covers y's rounding to bfloat16; atol what the
# tensor-core arithmetic adds (S, w x, r_dec, k_carry, A and the state operand
# rounded to bfloat16): about twice what CPU models of it need
# (tests/test_torch_kernels.py, SCAN_BF16_TOL).
SCAN_BF16_TOL = {"ssd": {"y": (2e-2, 1e-2), "state": (4e-3, 1e-2)},
                 "wkv6": {"y": (7e-2, 1e-2), "state": (8e-3, 1e-2)}}

TRAIN_STEPS = 6
TRAIN_ARGV = ["--arch", "qwen2-0.5b", "--batch", "8", "--seq", "128",
              "--steps", str(TRAIN_STEPS), "--ckpt-delta", "--ckpt-device-fp"]
TRAIN_DISK_BYTES = 25e9     # three runs write ~18 GB of chunks


def log(msg: str) -> None:
    print(msg, flush=True)


T0 = time.perf_counter()


def phase(msg: str) -> None:
    """A phase's heading, with the seconds since the script started."""
    log(f"{msg} [{time.perf_counter() - T0:.1f}s]")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, inputs, iters: int = 20) -> float:
    """Mean time per call of ``fn(*inputs[i % len(inputs)])`` over ``iters``
    back-to-back calls between two CUDA events, after a warm-up; ``inputs``
    rotates over enough copies to exceed L2.  It reads the device only while
    the device is slower than the host issuing the calls, so for a short
    kernel it is the wrapper's cost (reported as ``call_ms``)."""
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


def attn_check(kernel: str, got, want, dtn: str) -> tuple[float, float, bool]:
    """(max |got - want|; the atol that the element-wise comparison needs at
    the kernel's bfloat16 rtol, 0 for float32; whether both are within their
    limits and every value is finite)."""
    import torch

    err = (got.float() - want).abs()
    atol, rtol = ATTN_BF16_TOL[kernel] if dtn == "bfloat16" else (0.0, 0.0)
    excess = (err - rtol * want.abs()).max().item() if dtn == "bfloat16" else 0.0
    ok = err.max().item() <= TOL[dtn] and excess <= atol and bool(torch.isfinite(got).all())
    return err.max().item(), excess, ok


def _excess_note(kernel: str, excess: float, dtn: str) -> str:
    if dtn != "bfloat16":
        return ""
    atol, rtol = ATTN_BF16_TOL[kernel]
    return f", beyond {rtol}|plain| {excess:.3g} (atol {atol})"


def spread(values) -> dict:
    vals = sorted(values)
    return {"median": vals[len(vals) // 2], "min": vals[0], "max": vals[-1]}


MARKER = "spin"        # the kernel of torch.cuda._sleep, which separates timed runs


def device_ms(fn, inputs, iters: int = 20, repeats: int = 5) -> dict:
    """Device time per call of ``fn``: under one ``torch.profiler`` window,
    ``repeats`` runs of ``iters`` calls, each run between two marker kernels;
    a run's time is the summed device time of the CUDA kernels (and copies)
    between its markers, over ``iters``.  Median, min and max of the runs.
    The host's issue rate does not enter it.  A device event's time is its
    duration, which is what ``self_device_time_total`` reports for it unless
    the profiler flags the event async (then it reads 0; seen for the SSD
    scan's launches), so the durations are summed.  The window starts with
    warm-up calls, because the profiler can miss a window's first launches;
    a window whose runs do not show equal event counts, or show no device
    time, is taken again (at most twice) and then fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(3):
                fn(*inputs[i % len(inputs)])
            torch.cuda.synchronize()
            for _ in range(repeats):
                torch.cuda._sleep(1000)
                for i in range(iters):
                    fn(*inputs[i % len(inputs)])
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        marks = [i for i, e in enumerate(events) if MARKER in e.name]
        runs = [events[a + 1:b] for a, b in zip(marks[-repeats - 1:], marks[-repeats:])]
        counts = {len(r) for r in runs}
        per_call = [sum(e.time_range.elapsed_us() for e in r) / 1e3 / iters for r in runs]
        if (len(runs) == repeats and len(counts) == 1 and counts.pop() % iters == 0
                and min(per_call) > 0):
            return spread(per_call)
        log(f"    (profiler window {attempt + 1}: {len(marks)} markers, run event counts "
            f"{[len(r) for r in runs]}; taken again)")
    raise AssertionError("the profiler did not see every timed launch in three windows")


def call_ms(fn, inputs, repeats: int = 5) -> dict:
    return spread([timed_ms(fn, inputs) for _ in range(repeats)])


def fmt(st: dict) -> str:
    return f"{st['median']:.4f} [{st['min']:.4f}, {st['max']:.4f}]"


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


# main-path shapes of the attention kernels, with the run whose launches
# they carry: (label, B, S, H, Hkv, D, launch source)
FLASH_SHAPES = [("qwen2-0.5b prefill", 4, 512, 14, 2, 64, "qwen2-0.5b"),
                ("zamba2-1.2b shared block", 4, 512, 32, 32, 64, "zamba2-1.2b"),
                ("qwen2-0.5b train forward", 8, 128, 14, 2, 64, "train"),
                ("qwen3-4b prefill", 4, 512, 32, 8, 128, "qwen3-4b")]
DECODE_SHAPES = [("qwen2-0.5b decode", 4, 1024, 14, 2, 64, "qwen2-0.5b"),
                 ("zamba2-1.2b decode", 4, 1024, 32, 32, 64, "zamba2-1.2b"),
                 ("qwen3-4b decode", 4, 1024, 32, 8, 128, "qwen3-4b")]
DECODE_KV_LEN = 544      # the serve phases' last position: prompt 512 + 32


def phase_kernels() -> dict:
    """Every kernel against its plain version; device times at the main
    paths' shapes."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention, flash_attention, ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    report = {}

    # ---- flash -------------------------------------------------------------
    flash_cases = [  # B, S, H, Hkv, Dq, Dv, dtype, causal
        (4, 512, 14, 2, 64, 64, "bfloat16", True),     # the main path's prefill
        (4, 512, 32, 32, 64, 64, "bfloat16", True),    # zamba2's shared attention, G=1
        (8, 128, 14, 2, 64, 64, "bfloat16", True),     # the train forward
        (4, 512, 32, 8, 128, 128, "bfloat16", True),   # qwen3-4b's prefill, D 128, G = 4
        *[(2, n, 14, 2, 64, 64, "bfloat16", True) for n in (1, 17, 63, 65, 300)],  # ragged
        (1, 256, 8, 1, 128, 64, "bfloat16", False),    # Dq != Dv, not causal
        (1, 100, 4, 4, 32, 128, "bfloat16", True),
        (1, 64, 4, 2, 192, 128, "bfloat16", True),     # MLA prefill head dims
        (2, 300, 14, 2, 64, 64, "float32", True),      # ragged, the CUDA-core kernel
        (1, 256, 8, 1, 128, 64, "float32", False),
    ]
    worst = 0.0
    for B, S, H, Hkv, Dq, Dv, dtn, causal in flash_cases:
        q = _randn((B, S, H, Dq), dt[dtn], gen)
        k = _randn((B, S, Hkv, Dq), dt[dtn], gen)
        v = _randn((B, S, Hkv, Dv), dt[dtn], gen)
        got = flash_attention.flash(q, k, v, causal=causal)
        again = flash_attention.flash(q, k, v, causal=causal)
        want = ref.attention(q.float(), k.float(), v.float(), causal=causal)
        torch.cuda.synchronize()
        err, excess, ok = attn_check("flash", got, want, dtn)
        same = torch.equal(got, again)
        ok = ok and same
        log(f"  flash B{B} S{S} H{H} Hkv{Hkv} Dq{Dq} Dv{Dv} {dtn} causal={causal}: "
            f"max_abs_err {err:.3g} (tol {TOL[dtn]}){_excess_note('flash', excess, dtn)} "
            f"repeatable={same} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash disagrees with its plain version: {err}, {excess}")
        worst = max(worst, err)
    shapes = []
    elt = 2
    for label, B, S, H, Hkv, D, source in FLASH_SHAPES:
        sets = copies_past_l2([_randn(s, torch.bfloat16, gen) for s in
                               ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D))])

        def kern(q, k, v):
            return flash_attention.flash(q, k, v, causal=True)

        lib_sets = [tuple(t.transpose(1, 2) for t in s) for s in sets]

        def lib(q, k, v):
            return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

        nbytes = elt * (2 * B * S * H * D + 2 * B * S * Hkv * D)
        flops = 2 * B * H * (S * (S + 1) // 2) * (D + D)
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        shapes.append(dict(
            kernel="flash", label=label, source=source,
            shape=f"B{B} S{S} H{H} Hkv{Hkv} D{D} bfloat16 causal",
            ms=device_ms(kern, sets), call_ms=call_ms(kern, sets),
            library_ms=device_ms(lib, lib_sets),
            plain_ms=timed_ms(lambda q, k, v: ref.attention(q, k, v, causal=True), sets),
            bound_ms=b_ms, bound_by=b_by))
    report["flash"] = dict(max_abs_err=worst, shapes=shapes)

    # ---- flash_decode ------------------------------------------------------
    decode_cases = [  # B, S, H, Hkv, D, dtype, kv_lens
        (4, 1024, 14, 2, 64, "bfloat16", (1, 300, 544, 1024)),   # 544: end of the main path
        (4, 1024, 32, 32, 64, "bfloat16", (1, 300, 544)),        # zamba2's shared attention
        (4, 1024, 32, 8, 128, "bfloat16", (1, 65, 544, 1024)),   # qwen3-4b, D 128, G = 4
        (2, 512, 8, 2, 64, "float32", (77,)),
    ]
    for B, S, H, Hkv, D, dtn, _ in decode_cases[:2]:       # the split boundaries, and 0
        sp = decode_attention.split_size(S)
        decode_cases.append((B, S, H, Hkv, D, dtn, (0, sp - 1, sp, sp + 1, S)))
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
            err, excess, ok = attn_check("flash_decode", got, want, dtn)
            same = torch.equal(got, again)
            ok = ok and same
            log(f"  flash_decode B{B} S{S} H{H} Hkv{Hkv} D{D} {dtn} kv_len={kv_len}: "
                f"max_abs_err {err:.3g} (tol {TOL[dtn]})"
                f"{_excess_note('flash_decode', excess, dtn)} repeatable={same} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(
                    f"flash_decode disagrees with its plain version: {err}, {excess}")
            worst = max(worst, err)
    shapes = []
    kv_len = DECODE_KV_LEN
    kvl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    for label, B, S, H, Hkv, D, source in DECODE_SHAPES:
        sets = copies_past_l2([_randn(s, torch.bfloat16, gen) for s in
                               ((B, 1, H, D), (B, S, Hkv, D), (B, S, Hkv, D))])

        def kern(q, k, v):
            return decode_attention.flash_decode(q, k, v, kv_len=kvl)

        lib_sets = [(q.transpose(1, 2), k[:, :kv_len].transpose(1, 2),
                     v[:, :kv_len].transpose(1, 2)) for q, k, v in sets]

        def lib(q, k, v):
            return F.scaled_dot_product_attention(q, k, v, enable_gqa=True)

        nbytes = elt * (2 * B * H * D + 2 * B * kv_len * Hkv * D) + 4
        flops = 2 * B * H * kv_len * (D + D)
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        shapes.append(dict(
            kernel="flash_decode", label=label, source=source,
            shape=f"B{B} S{S} H{H} Hkv{Hkv} D{D} bfloat16 kv_len={kv_len} "
                  f"({decode_attention.num_splits(S)} splits)",
            ms=device_ms(kern, sets), call_ms=call_ms(kern, sets),
            library_ms=device_ms(lib, lib_sets),
            plain_ms=timed_ms(lambda q, k, v: ref.attention(q, k, v, causal=False,
                                                            kv_len=kvl), sets),
            bound_ms=b_ms, bound_by=b_by))
    report["flash_decode"] = dict(max_abs_err=worst, shapes=shapes)
    for r in report["flash"]["shapes"] + shapes:
        log(f"  {r['kernel']} timing, {r['label']} ({r['shape']}): device ms {fmt(r['ms'])}"
            f"  call_ms {fmt(r['call_ms'])}  library device ms {fmt(r['library_ms'])}"
            f"  plain_ms {r['plain_ms']:.4f}  bound_ms {r['bound_ms']:.6f} ({r['bound_by']})")

    # ---- flash under autograd: kernel forward, plain backward (training) ----
    B, S, H, Hkv, D, dtn = 8, 128, 14, 2, 64, "bfloat16"
    q, k, v = (_randn(s, dt[dtn], gen).requires_grad_()
               for s in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    go = _randn((B, S, H, D), dt[dtn], gen)
    out = flash_attention.flash(q, k, v, causal=True)
    grads = torch.autograd.grad(out, (q, k, v), go)
    plain_in = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want = ref.attention(*plain_in, causal=True)
    want_grads = torch.autograd.grad(want, plain_in, go.float())
    torch.cuda.synchronize()
    errs = [(a.detach().float() - b.detach()).abs().max().item() for a, b in
            zip((out, *grads), (want, *want_grads))]
    ok = all(e <= TOL[dtn] for e in errs) and all(bool(torch.isfinite(g).all()) for g in grads)
    log(f"  flash gradient B{B} S{S} H{H} Hkv{Hkv} D{D} {dtn}: max_abs_err out/dq/dk/dv "
        + "/".join(f"{e:.3g}" for e in errs) + f" (tol {TOL[dtn]}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash's gradient disagrees with the plain version's: {errs}")
    report["flash"]["grad_max_abs_err"] = max(errs[1:])

    report.update(_checksum_kernels(gen))
    report.update(_scan_kernels(gen))
    return report


def _checksum_kernels(gen) -> dict:
    """chunk_fingerprints and checksum against their plain versions, bit for
    bit; timed on the embed table's aligned body (the largest launch of a
    qwen2-0.5b save: 519 chunks of 1 MiB)."""
    import torch

    from repro_torch.kernels import checksum as CK
    from repro_torch.kernels import ops, ref

    def words(n):
        return torch.randint(-2**31, 2**31, (n,), generator=gen, dtype=torch.int64,
                             device="cuda").to(torch.int32)

    checked = 0
    for cw in (1, 8, 262144):
        for n in (0, 1, 3 * cw, 2 * cw + 5, cw + 1):
            w = words(n)
            for span in (w, w[1:]):                 # w[1:] starts off a 16-byte boundary
                got = ops.chunk_fingerprints(span, chunk_words=cw)
                if not torch.equal(got, ref.chunk_fingerprints(span, cw)):
                    raise AssertionError(f"chunk_fingerprints differs at n={span.numel()} cw={cw}")
                checked += 1
    for block in (8, 2048):
        for n in (0, 1, 7, 3000, (1 << 20) + 3):
            w = words(n)
            pad = (-n) % block
            got = ops.checksum(w, block=block)
            if not torch.equal(got, ref.checksum(torch.cat([w, w.new_zeros(pad)]))):
                raise AssertionError(f"checksum differs at n={n} block={block}")
            if not torch.equal(got, ops.checksum(w, block=block)):
                raise AssertionError(f"checksum is not repeatable at n={n}")
            checked += 1
    torch.cuda.synchronize()
    log(f"  chunk_fingerprints and checksum: {checked} cases equal to the plain "
        "versions bit for bit (cw 1/8/262144, ragged tails, empty, 1 word, unaligned)")

    # the embed table's aligned body: 151936 x 896 float32, 519 whole 1 MiB chunks
    cw = 262144
    body = torch.randn(519 * cw, generator=gen, device="cuda").view(torch.int32)
    nchunks = body.numel() // cw
    out = {}
    for name, fn, plain, out_bytes, source in (
            ("chunk_fingerprints", lambda w: CK.chunk_fingerprints(w, cw),
             lambda w: ref.chunk_fingerprints(w, cw), 4 * nchunks, "train"),
            ("checksum", lambda w: CK.checksum(w, block=2048),
             lambda w: ref.checksum(w), 4, None)):
        b_ms, b_by = bound(4 * body.numel() + out_bytes, 6 * body.numel(), "uint32")
        r = dict(kernel=name, label="qwen2-0.5b embed table", source=source,
                 shape=f"{body.numel()} words (519 x 1 MiB) int32",
                 ms=device_ms(fn, [(body,)]), call_ms=call_ms(fn, [(body,)]), library_ms=None,
                 plain_ms=timed_ms(plain, [(body,)], iters=3), bound_ms=b_ms, bound_by=b_by)
        out[name] = dict(max_abs_err=0.0, shapes=[r])
        log(f"  {name} timing ({r['shape']}): device ms {fmt(r['ms'])}  call_ms "
            f"{fmt(r['call_ms'])}  plain_ms {r['plain_ms']:.4f}  library none  "
            f"bound_ms {b_ms:.5f} ({b_by})")
    return out


def ssd_flops(B: int, S: int, H: int, P: int, N: int, Q: int = 64) -> int:
    """Operations of csrc/ssd_scan.cu's chunked form (chunk Q) on these shapes:
    lower-triangle scores, y, and the state update, per (batch, head)."""
    per = 0
    for t0 in range(0, S, Q):
        L = min(Q, S - t0)
        tri = L * (L + 1) // 2
        per += tri * (2 * N + 2) + tri * 2 * P + L * P * (2 * N + 4) + P * N * (3 * L + 2)
    return B * H * per


def _scan_inputs(kind, shape, dtype, gen, with_state):
    """SSD (B,S,H,P,N) or WKV6 (B,S,H,D) inputs at the scales of the reference's
    kernel tests (tests/test_kernels.py:63-102), made on the card."""
    import torch

    def rn(*sh):
        return torch.randn(sh, generator=gen, device="cuda")

    if kind == "ssd":
        B, S, H, P, N = shape
        dt = (rn(B, S, H).abs() * 0.5).to(dtype)
        args = ((rn(B, S, H, P) * 0.5).to(dtype), dt, rn(H) * 0.3,
                (rn(B, S, N) * 0.5).to(dtype), (rn(B, S, N) * 0.5).to(dtype),
                torch.ones(H, device="cuda"))
        st0 = rn(B, H, P, N) * 0.5
    else:
        B, S, H, D = shape
        w = torch.rand((B, S, H, D), generator=gen, device="cuda") * 0.299 + 0.7
        args = tuple((rn(B, S, H, D) * 0.5).to(dtype) for _ in range(3)) + (
            w.to(dtype), rn(H, D) * 0.3)
        st0 = rn(B, H, D, D) * 0.5
    return args, (st0 if with_state else None)


def _scan_kernels(gen) -> dict:
    """ssd and wkv6 against their plain versions (the sequential recurrences):
    the main shapes and the bfloat16 kernels' edge cases (ragged S, slices, P
    and N off the tile, under one chunk) in bfloat16, the reference's test
    shapes in float32 (the CUDA-core kernels), with and without an initial
    state; timed at the main shapes."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd as SSD
    from repro_torch.kernels import wkv6 as WKV

    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    kernels = {"ssd": (SSD.ssd, ref.ssd), "wkv6": (WKV.wkv6, ref.wkv6)}
    sources = {"ssd": "zamba2-1.2b", "wkv6": "rwkv6-1.6b"}
    # shape, dtype, with an initial state, and whether the error is taken
    # relative to each output's max |plain| (the main widths over 500+ tokens,
    # where |y| reaches ~20) or absolute (the reference's test shapes)
    cases = {
        "ssd": [((4, 512, 64, 64, 64), "bfloat16", False, True),   # zamba2's prefill
                ((4, 500, 64, 64, 64), "bfloat16", True, True),    # ragged, with a state
                ((1, 70, 2, 80, 128), "bfloat16", True, True),     # P over two slices, N 128
                ((1, 130, 3, 12, 20), "bfloat16", False, True),    # P, N padded to 8
                ((2, 37, 8, 32, 16), "bfloat16", True, True),      # under one chunk
                ((4, 512, 64, 64, 64), "float32", False, True),
                ((2, 128, 3, 32, 16), "float32", False, False),    # tests/test_kernels.py:74
                ((1, 256, 2, 16, 64), "float32", True, False),
                ((2, 64, 4, 8, 8), "float32", False, False),
                ((2, 500, 8, 64, 64), "float32", True, True)],
        "wkv6": [((4, 512, 32, 64), "bfloat16", False, True),      # rwkv6's prefill
                 ((4, 500, 32, 64), "bfloat16", True, True),
                 ((1, 70, 2, 128), "bfloat16", True, True),
                 ((2, 96, 1, 16), "bfloat16", False, True),
                 ((2, 37, 3, 32), "bfloat16", True, True),
                 ((4, 512, 32, 64), "float32", False, True),
                 ((2, 128, 3, 32), "float32", False, False),       # tests/test_kernels.py:106
                 ((1, 64, 2, 64), "float32", True, False),
                 ((2, 96, 1, 16), "float32", False, False),
                 ((2, 500, 4, 64), "float32", True, True)],
    }
    out = {}
    for name, (kernel, plain) in kernels.items():
        source = sources[name]
        worst = 0.0
        for shape, dtn, with_state, relative in cases[name]:
            args, st0 = _scan_inputs(name, shape, dt[dtn], gen, with_state)
            y, st = kernel(*args, init_state=st0, return_state=True)
            y2, st2 = kernel(*args, init_state=st0, return_state=True)
            want, wst = plain(*(a.float() for a in args), init_state=st0, return_state=True)
            torch.cuda.synchronize()
            errs = [(y.float() - want).abs().max().item(), (st - wst).abs().max().item()]
            scales = ([max(1.0, want.abs().max().item()), max(1.0, wst.abs().max().item())]
                      if relative else [1.0, 1.0])
            rel = max(e / s for e, s in zip(errs, scales))
            err = max(errs)
            same = torch.equal(y, y2) and torch.equal(st, st2)
            excess = {}
            if dtn == "bfloat16":
                for out_name, got_t, want_t in (("y", y, want), ("state", st, wst)):
                    rtol = SCAN_BF16_TOL[name][out_name][1]
                    excess[out_name] = ((got_t.float() - want_t).abs()
                                        - rtol * want_t.abs()).max().item()
            ok = (rel <= SCAN_TOL[name][dtn] and same
                  and all(excess[o] <= SCAN_BF16_TOL[name][o][0] for o in excess)
                  and bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all()))
            log(f"  {name} {'x'.join(map(str, shape))} {dtn} init_state={with_state}: "
                f"max_abs_err y/state {errs[0]:.3g}/{errs[1]:.3g}"
                + (f" = {errs[0] / scales[0]:.3g}/{errs[1] / scales[1]:.3g} of max |plain| "
                   f"{scales[0]:.3g}/{scales[1]:.3g}" if relative else "")
                + f" (tol {SCAN_TOL[name][dtn]})"
                + ("".join(f", {o} beyond {SCAN_BF16_TOL[name][o][1]}|plain| {e:.3g} (atol "
                           f"{SCAN_BF16_TOL[name][o][0]})" for o, e in excess.items()))
                + f" repeatable={same} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain version: {err}, {excess}")
            worst = max(worst, err)
        shape, dtn = cases[name][0][:2]
        args, _ = _scan_inputs(name, shape, dt[dtn], gen, False)
        sets = copies_past_l2(args)

        def kern(*a):
            return kernel(*a, return_state=True)

        plain_ms = timed_ms(lambda *a: plain(*a, return_state=True), sets, iters=3)
        elt = args[0].element_size()
        if name == "ssd":
            B, S, H, P, N = shape
            nbytes = elt * (2 * B * S * H * P + B * S * H + 2 * B * S * N) + 8 * H + 4 * B * H * P * N
            flops = ssd_flops(B, S, H, P, N)
        else:
            B, S, H, D = shape
            nbytes = elt * 5 * B * S * H * D + 4 * H * D + 4 * B * H * D * D
            flops = B * S * H * (4 * D * D + 5 * D)
        b_ms, b_by = bound(nbytes, flops, dtn)
        r = dict(kernel=name, label=f"{source} prefill", source=source,
                 shape=f"{'x'.join(map(str, shape))} {dtn}, final state out",
                 ms=device_ms(kern, sets), call_ms=call_ms(kern, sets), library_ms=None,
                 plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        out[name] = dict(max_abs_err=worst, shapes=[r])
        log(f"  {name} timing ({r['shape']}): device ms {fmt(r['ms'])}  call_ms "
            f"{fmt(r['call_ms'])}  plain_ms {plain_ms:.4f}  library none  bound_ms "
            f"{b_ms:.5f} ({b_by}; {nbytes} bytes, {flops} flops)")
    return out


def phase_serve(ckpt_dir: str, arch: str) -> dict:
    """The port's serving path at full width and depth, once, with the launch
    counts of every serving kernel set to 0 just before and read just after."""
    import torch

    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.kernels import ssd as SSD
    from repro_torch.kernels import wkv6 as WKV
    from repro_torch.launch import serve

    mods = {"flash": flash_attention, "flash_decode": decode_attention, "ssd": SSD,
            "wkv6": WKV}
    args = serve.parse_args(["--arch", arch] + SERVE_ARGV + ["--ckpt-dir", ckpt_dir])
    for m in mods.values():
        m.launches = 0
    rep = serve.run(args)
    counts = {name: m.launches for name, m in mods.items()}
    torch.cuda.empty_cache()
    log(f"  continuation {'MATCHES' if rep['match'] else 'DIVERGED FROM'} the "
        "unmigrated reference")
    log(f"  prefill_ms {rep['prefill_ms']:.3f} (second prefill {rep['prefill_warm_ms']:.3f})"
        f"  decode_ms_per_token "
        f"{rep['decode_ms_per_token']:.3f}  snapshot save_s {rep['save_s']:.4f} "
        f"restore_s {rep['restore_s']:.4f} bytes {rep['snapshot_bytes']}")
    log(f"  launches {counts} (expected {EXPECTED_LAUNCHES[arch]})")
    want_bytes = EXPECTED_SNAPSHOT_BYTES[arch]
    log(f"  snapshot bytes {rep['snapshot_bytes']} (expected {want_bytes}: the cache, t and "
        "the last tokens)")
    if not rep["match"]:
        raise AssertionError("the migrated continuation diverged")
    if rep["snapshot_bytes"] != want_bytes:
        raise AssertionError(f"snapshot of {rep['snapshot_bytes']} bytes, expected {want_bytes}")
    if not rep["logits_finite"]:
        raise AssertionError("non-finite logits")
    if counts != EXPECTED_LAUNCHES[arch]:
        raise AssertionError(f"launch counts {counts} != {EXPECTED_LAUNCHES[arch]}")
    return {"counts": counts, **rep}


def phase_profile(arch: str, steps: int = 8) -> dict:
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

    cfg = get_config(arch)
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
    del eng, model
    torch.cuda.empty_cache()
    return out


def phase_reference(arch: str, prompt_len: int, max_seq: int, steps: int = 8) -> dict:
    """A reduced model in float32: the card's path against the CPU path."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models import model as M

    cfg = reduced(get_config(arch))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               (2, prompt_len)).astype(np.int32)
    out = {}
    for device in ("cpu", "cuda"):
        lm = M.init_params(cfg, seed=0, device=device)
        logits, cache = M.prefill(lm, cfg, {"tokens": torch.from_numpy(tokens).to(device)},
                                  max_seq)
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
    log(f"  reduced {arch} f32 prompt {prompt_len}, cuda vs cpu: tokens equal={same} "
        f"max logit err {err:.3g}")
    if not same or err > 1e-3 or not math.isfinite(err):
        raise AssertionError("the card's path disagrees with the CPU path")
    return {"tokens_equal": same, "max_logit_err": err}


def _work_dir() -> Path:
    """A scratch directory for the checkpoints of phases 6 and 7, on whichever
    of the temporary directory and the repository's ``build/`` has more free
    space; fails clearly below TRAIN_DISK_BYTES."""
    bases = [Path(tempfile.gettempdir()), ROOT / "build"]
    for b in bases:
        b.mkdir(parents=True, exist_ok=True)
    free = {b: shutil.disk_usage(b).free for b in bases}
    base = max(free, key=free.get)
    log("  free disk: " + ", ".join(f"{b} {f / 1e9:.1f} GB" for b, f in free.items()))
    if free[base] < TRAIN_DISK_BYTES:
        raise RuntimeError(f"the train phases write ~18 GB of checkpoints; the most free "
                           f"space is {free[base] / 1e9:.1f} GB at {base}, under "
                           f"{TRAIN_DISK_BYTES / 1e9:.0f} GB")
    return Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=base))


def fp_launches_per_save(named, chunk_bytes: int) -> int:
    """Kernel launches of one ``tree_chunk_fingerprints`` over ``named``: one
    per leaf with a whole chunk, plus one for all the ragged tails."""
    sizes = [x.numel() * x.element_size() for _, x in named]
    return (sum(1 for n in sizes if n >= chunk_bytes)
            + int(any(n % chunk_bytes for n in sizes)))


def phase_state(work: Path) -> dict:
    """The full-width train state on the card after one step: fingerprinted
    whole (kernel against the plain version and the host), one profiled
    step, and saved twice with device fingerprints and once on the host path."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.checkpoint import serialization as SER
    from repro_torch.checkpoint.manager import CheckpointManager, CheckpointPolicy
    from repro_torch.checkpoint.store import TieredStore
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import checksum as CK
    from repro_torch.kernels import ops, ref
    from repro_torch.optim import adamw
    from repro_torch.train import step as TS
    from repro_torch.utils.tree import flatten_with_names

    cfg = get_config("qwen2-0.5b")
    oc = adamw.OptConfig(warmup_steps=10, decay_steps=TRAIN_STEPS)
    t0 = time.perf_counter()
    state = TS.init_train_state(cfg, oc, 0, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pipe = SyntheticTokens(cfg, 8, 128)
    batches = [{"tokens": torch.from_numpy(pipe.batch_at(i)["tokens"]).cuda()}
               for i in range(3)]
    step = TS.make_train_step(cfg, oc)
    torch.cuda.reset_peak_memory_stats()
    state, _ = step(state, batches[0])       # moments nonzero, kernels warm
    torch.cuda.synchronize()
    named = flatten_with_names(state)
    nbytes = sum(x.numel() * x.element_size() for _, x in named)
    log(f"  state: {len(named)} leaves, {nbytes} bytes ({nbytes / 1e9:.3f} GB), "
        f"init {init_s:.1f}s, peak device memory of a step "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # one step, untraced then traced: step ms and where the device time goes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = step(state, batches[1])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with prof:
        state, _ = step(state, batches[2])
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_s = sum(r[1] for r in rows) / 1e6
    rows.sort(key=lambda r: -r[1])
    log(f"  train step B8 S128: wall {wall_s * 1e3:.3f} ms untraced, device kernels "
        f"{busy_s * 1e3:.3f} ms = {100 * busy_s / wall_s:.1f}% busy")
    for key, us, n in rows[:10]:
        log(f"    {100 * us / 1e6 / busy_s:5.1f}%  {us / 1e3:8.4f} ms  x{n:<5d} {key[:90]}")

    # the whole state through the kernel, against the plain version and the host
    named = flatten_with_names(state)
    cb = SER.DELTA_CHUNK_BYTES
    cw = cb // 4
    want_launches = fp_launches_per_save(named, cb)
    n0 = CK.fingerprint_launches
    fps = ops.tree_chunk_fingerprints(named, cb)
    launches = CK.fingerprint_launches - n0
    chunks = 0
    for name, leaf in named:
        plain = ref.chunk_fingerprints(ops.leaf_words(leaf), cw).cpu().numpy().view(np.uint32)
        host = SER.fingerprint_chunks(SER.as_byte_view(SER.host_array(leaf)), cb)
        if not (np.array_equal(fps[name], plain) and np.array_equal(fps[name], host)):
            raise AssertionError(f"fingerprints of {name} differ from the plain version "
                                 "or the host's")
        chunks += len(host)
    log(f"  whole state: {chunks} chunk fingerprints equal to the plain version on the "
        f"card and to the host's, bit for bit; {launches} launches per tree "
        f"(expected {want_launches})")
    if launches != want_launches:
        raise AssertionError(f"{launches} launches per tree, expected {want_launches}")

    def tree_call():
        ops.tree_chunk_fingerprints(named, cb)

    def plain_tree():
        for _, leaf in named:
            ref.chunk_fingerprints(ops.leaf_words(leaf), cw).cpu()

    tree = {}
    for label, fn, iters in (("kernel", tree_call, 10), ("plain", plain_tree, 2)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        tree[label] = (time.perf_counter() - t0) / iters * 1e3
    tree_bound, _ = bound(nbytes, 6 * nbytes / 4, "uint32")
    log(f"  whole-state tree call ({nbytes / 1e9:.3f} GB, host clock, fingerprints on "
        f"the host at the end): kernel {tree['kernel']:.3f} ms, plain {tree['plain']:.3f} "
        f"ms, bound {tree_bound:.4f} ms (bytes)")

    # the same state saved twice through the device path, then on the host path
    store = TieredStore(work / "resave")
    saves = {}
    for label, device_fp, s in (("device, first", True, 1), ("device, clean", True, 2),
                                ("host, same state", False, 3)):
        mgr = CheckpointManager(store, CheckpointPolicy(delta=True, device_fp=device_fp))
        t0 = time.perf_counter()
        part = mgr.save(s, state)
        mgr.commit(s)
        wall = time.perf_counter() - t0
        mgr.close()
        d = part["delta"]
        saves[label] = {"wall_s": wall, **{k: d.get(k) for k in (
            "stall_s", "fp_device_s", "d2h_bytes", "d2h_s", "hash_s", "diff_s", "write_s",
            "chunks_total", "chunks_clean_device", "chunks_hashed", "bytes_written")}}
        log(f"  save {s} ({label}): stall_s {d.get('stall_s', 0):.3f} wall_s {wall:.3f} "
            f"(commit {wall - d.get('stall_s', 0):.3f}) fp_device_s "
            f"{d.get('fp_device_s', 0):.4f} d2h_bytes {d.get('d2h_bytes')} d2h_s "
            f"{d.get('d2h_s', 0):.3f} hash_s {d.get('hash_s', 0):.3f} diff_s "
            f"{d.get('diff_s', 0):.3f} write_s {d.get('write_s', 0):.3f} chunks "
            f"{d.get('chunks_total')} clean {d.get('chunks_clean_device')} hashed "
            f"{d.get('chunks_hashed')} bytes_written {d.get('bytes_written')}")
    clean = saves["device, clean"]
    if clean["d2h_bytes"] != 0 or clean["chunks_clean_device"] != clean["chunks_total"]:
        raise AssertionError(f"the re-save of an unchanged state copied bytes: {clean}")
    shutil.rmtree(work / "resave")
    del state, named, fps
    torch.cuda.empty_cache()
    return {"step_ms": wall_s * 1e3, "busy_share": busy_s / wall_s, "tree_ms": tree,
            "tree_bound_ms": tree_bound, "fp_launches_per_save": want_launches,
            "saves": saves}


def _child_env() -> dict:
    """The environment of a child process: this one's, with the port's
    sources first on the path and unbuffered output."""
    return {**os.environ, "PYTHONUNBUFFERED": "1", "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src")] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH")
                               else []))}


def _train_run(work: Path, tag: str, ckpt: str, extra: list) -> tuple[int, dict]:
    out = work / f"{tag}.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_ARGV,
           "--ckpt-dir", str(work / ckpt), "--metrics-out", str(out), *extra]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, env=_child_env(), capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if not out.exists():
        raise AssertionError(f"train run {tag} wrote no metrics (exit {r.returncode}):\n"
                             f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    m = json.loads(out.read_text())
    steps = m["steps"]
    log(f"  run {tag}: exit {r.returncode} in {wall:.1f}s, steps "
        f"{[s['step'] for s in steps]}, start {m['start_step']}, restore_s "
        f"{m['restore_s'] if m['restore_s'] is None else round(m['restore_s'], 3)}, "
        f"launches {m['launches']}")
    log("    step ms " + " ".join(f"{s['ms']:.1f}" for s in steps)
        + "  losses " + " ".join(repr(s["loss"]) for s in steps))
    for sv in m["saves"]:
        log(f"    save at step {sv['step']}: stall_s {sv.get('stall_s', 0):.3f} fp_device_s "
            f"{sv.get('fp_device_s', 0):.4f} d2h_bytes {sv.get('d2h_bytes')} d2h_s "
            f"{sv.get('d2h_s', 0):.3f} hash_s {sv.get('hash_s', 0):.3f} write_s "
            f"{sv.get('write_s', 0):.3f} chunks {sv.get('chunks_total')} clean "
            f"{sv.get('chunks_clean_device')}")
    return r.returncode, m


def _final_hashes(ckpt_dir: Path) -> dict:
    from repro_torch.checkpoint.manager import CheckpointManager, CheckpointPolicy
    from repro_torch.checkpoint.store import TieredStore

    mgr = CheckpointManager(TieredStore(ckpt_dir), CheckpointPolicy(delta=True))
    man = mgr.read_manifest(TRAIN_STEPS - 1)
    mgr.close()
    return {e["path"]: [c["hash"] for c in e["chunks"]] for e in man["leaves"]}


def _train_launches(m: dict, fp_per_save: int) -> dict:
    """What a train run's launch counts must be: flash 24 per step (one
    forward of 24 layers), the fingerprint kernel's per device-fp save."""
    return {"flash": 24 * len(m["steps"]), "chunk_fingerprints": fp_per_save * len(m["saves"])}


def phase_train(work: Path, fp_per_save: int) -> dict:
    """The paper's C/R loop at full width, as a user runs it: A uninterrupted;
    B with a walltime its margin exceeds, so it checkpoints after its first
    step and exits 85; C requeued on B's directory, restoring and finishing."""
    rc_a, a = _train_run(work, "A", "a", [])
    hashes_a = _final_hashes(work / "a")
    shutil.rmtree(work / "a")
    rc_b, b = _train_run(work, "B", "b", ["--walltime", "0.5", "--margin", "100"])
    rc_c, c = _train_run(work, "C", "b", [])
    if (rc_a, rc_b, rc_c) != (0, 85, 0):
        raise AssertionError(f"exit codes A/B/C {(rc_a, rc_b, rc_c)}, expected (0, 85, 0)")
    if [s["step"] for s in b["steps"]] != [0] or c["start_step"] != 1:
        raise AssertionError("B must stop after step 0 and C resume at step 1")
    loss_a, loss_c = a["steps"][-1]["loss"], c["steps"][-1]["loss"]
    same_losses = [s["loss"] for s in a["steps"]] == [s["loss"] for s in b["steps"] + c["steps"]]
    same_hashes = hashes_a == _final_hashes(work / "b")
    log(f"  final loss A {loss_a!r} C {loss_c!r}: {'EQUAL' if loss_a == loss_c else 'DIFFER'};"
        f" every step's loss equal {same_losses}; final chunk hashes identical {same_hashes}")
    if loss_a != loss_c or not same_losses or not same_hashes:
        raise AssertionError("the requeued run did not finish bit-identical to run A")
    counts = {}
    for tag, m in (("A", a), ("B", b), ("C", c)):
        want = _train_launches(m, fp_per_save)
        if m["launches"] != want:
            raise AssertionError(f"run {tag}: launches {m['launches']}, expected {want}")
        for k, n in m["launches"].items():
            counts[k] = counts.get(k, 0) + n
    log(f"  launches over A+B+C {counts} (flash 24 per step, chunk_fingerprints "
        f"{fp_per_save} per device-fp save)")
    shutil.rmtree(work / "b")
    return {"counts": counts, "A": a, "B": b, "C": c, "hashes_a": hashes_a}


FLEET_ARGV = ["--arch", "qwen2-0.5b", "--batch", "4", "--prompt-len", "512", "--gen", "32",
              "--max-seq", "1024", "--max-lag-steps", "2", "--pipeline-uploads"]
FLEET_BATCHES = 4


def _publish(mgr, registry, step: int) -> float:
    """Commit and announce a saved ``step``; returns the seconds it took."""
    t0 = time.perf_counter()
    man = mgr.commit(step)
    registry.announce_push(step=step, node="pub", manifest_version=man.get("manifest_version"))
    return time.perf_counter() - t0


def phase_fleet(work: Path) -> dict:
    """Weight-follow at full width: a publisher pushes qwen2-0.5b's float32
    weights as delta checkpoints; ``serve --follow`` in a subprocess must serve
    the step pushed while it runs, and the same follower wiring in this
    process must, after its swap, give a fresh engine's tokens."""
    import numpy as np
    import torch

    from repro_torch.checkpoint.manager import CheckpointManager, CheckpointPolicy
    from repro_torch.checkpoint.store import TieredStore
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.sched.cache_registry import REGISTRY_DIRNAME, CacheRegistry
    from repro_torch.serve.engine import Engine
    from repro_torch.utils.tree import tree_map

    cfg = get_config("qwen2-0.5b")
    root = work / "fleet"
    weights = root / "weights"
    model = M.init_params(cfg, 0, "cuda")
    trees = {1: tree_map(lambda t: t.cpu().numpy(), M.params_tree(model))}
    del model
    torch.cuda.empty_cache()
    # step 2 moves a few leaves: some embedding rows and the first layer's
    # down projection (negated, so that the greedy tokens change)
    trees[2] = tree_map(lambda a: a, trees[1])
    table = trees[2]["embed"]["table"] = trees[1]["embed"]["table"].copy()
    table[:64] += 0.01
    down = trees[2]["seg0"]["ffn"]["down"]["w"] = trees[1]["seg0"]["ffn"]["down"]["w"].copy()
    down[0] *= -1.0
    registry = CacheRegistry(weights / REGISTRY_DIRNAME)
    pub = CheckpointManager(TieredStore(weights), CheckpointPolicy(delta=True), node="pub",
                            registry=registry)
    fol = None
    try:
        t0 = time.perf_counter()
        pub.save(1, trees[1])
        push_s = {1: time.perf_counter() - t0 + _publish(pub, registry, 1)}
        # the same wiring in this process, uploads on the upload thread: it
        # restores step 1 now, and takes step 2 after the subprocess below
        args = serve.parse_args([*FLEET_ARGV, "--follow", "--ckpt-dir", str(weights),
                                 "--local-root", str(root / "r1"), "--replica", "r1"])
        fol = serve.open_follower(args)
        client, handle, eng, restore_s = fol.client, fol.client.handle, fol.engine, fol.restore_s
        prompts = serve.synthetic_prompts(cfg, np.random.default_rng(1), args.batch,
                                          args.prompt_len, fol.device)
        eng.prefill(prompts)
        at_step1 = eng.generate(args.gen)            # warm, and step 1's tokens

        # step 2's chunks are written now and the step is published (committed
        # and announced) once the subprocess follower has served batch 0, so
        # that it lands while that follower runs, not after its last batch
        t0 = time.perf_counter()
        pub.save(2, trees[2])
        save2_s = time.perf_counter() - t0
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", *FLEET_ARGV, "--follow",
               "--batches", str(FLEET_BATCHES), "--ckpt-dir", str(weights),
               "--local-root", str(root / "r0"), "--replica", "r0"]
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, env=_child_env(), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        watchdog = threading.Timer(600, proc.kill)
        watchdog.start()
        lines = []
        try:
            for line in proc.stdout:
                line = line.rstrip()
                lines.append(line)
                log(f"    follower: {line}")
                if 2 not in push_s and line.startswith("batch 0:"):
                    push_s[2] = _publish(pub, registry, 2)
                    log(f"  published step 2 in {push_s[2]:.3f}s (its save took {save2_s:.3f}s)")
            rc = proc.wait()
        finally:
            watchdog.cancel()
        wall = time.perf_counter() - t0
        batches = [ln for ln in lines if ln.startswith("batch ")]
        advert = weights / REGISTRY_DIRNAME / "followers" / "r0.json"
        served2 = any("served step 2," in ln for ln in batches[1:])
        restored = next((ln for ln in lines if " restored step " in ln), "")
        log(f"  follower subprocess: exit {rc} in {wall:.1f}s, {len(batches)} batch lines, "
            f"served step 2 on a later batch {served2}, advert {advert.exists()}; "
            f"push of step 1 {push_s[1]:.3f}s")
        if rc != 0 or len(batches) != FLEET_BATCHES or not served2 or not advert.exists():
            raise AssertionError(f"the follower subprocess failed (exit {rc}):\n"
                                 + "\n".join(lines[-40:]))
        # its own launch counts, from its last stderr line: every batch one
        # prefill (24 layers) and args.gen decode steps
        words = next((ln for ln in lines if ": launches flash " in ln), ": launches").split(
            ": launches")[1].split()
        sub_counts = {words[i]: int(words[i + 1]) for i in range(0, len(words) - 1, 2)}
        sub_want = {"flash": 24 * FLEET_BATCHES, "flash_decode": 24 * args.gen * FLEET_BATCHES}
        log(f"  follower subprocess launches {sub_counts} (expected {sub_want})")
        if sub_counts != sub_want:
            raise AssertionError(f"follower subprocess launches {sub_counts} != {sub_want}")

        for m in (flash_attention, decode_attention):
            m.launches = 0
        served, lags = 0, []
        rec = client.sync_once()
        # until a batch is prefilled on step 2: the staged push swaps in at the
        # entry of prefill or of generate, whichever finds it staged
        prefilled_on = 1
        while prefilled_on != 2 and served < 8:
            eng.prefill(prompts)
            prefilled_on = handle.step
            got = eng.generate(args.gen)
            served += 1
            lags.append((prefilled_on, handle.step, client.lag()))
        counts = {"flash": flash_attention.launches, "flash_decode": decode_attention.launches}
        want = {"flash": 24 * served, "flash_decode": 24 * args.gen * served}
        fresh = Engine(cfg, M.params_from_numpy(cfg, trees[2], "cuda"), batch=args.batch,
                       max_seq=args.max_seq)
        fresh.prefill(prompts)
        same = bool(np.array_equal(got, fresh.generate(args.gen)))
        changed = not np.array_equal(got, at_step1)
        log(f"  in process: restore of step 1 {restore_s:.3f}s; fetch of step 2 "
            f"{rec['fetch_s']:.3f}s, bytes by tier {rec['bytes_by_tier']}, chunks "
            f"{rec['chunks']}; {served} batches (step at prefill, after, lag) {lags}, swap stall "
            f"{handle.last_swap_s * 1e6:.0f}us; tokens after the swap equal a fresh engine's "
            f"on step 2 {same}, differ from step 1's {changed}; launches {counts} "
            f"(expected {want})")
        if handle.step != 2 or not same or not changed:
            raise AssertionError("the pipelined swap did not serve step 2's tokens")
        if counts != want:
            raise AssertionError(f"fleet launches {counts} != {want}")
    finally:
        if fol is not None:
            fol.close()
        pub.close()
        shutil.rmtree(root, ignore_errors=True)
    del fresh, fol, eng
    torch.cuda.empty_cache()
    counts = {k: n + sub_counts[k] for k, n in counts.items()}
    return {"counts": counts, "subprocess_wall_s": wall, "batch_lines": batches,
            "subprocess_restore": restored, "restore_s": restore_s, "fetch_s": rec["fetch_s"]}


def phase_sched(work: Path, train_rep: dict, fp_per_save: int) -> dict:
    """Phase 7's trainer under ``SlurmSim`` with two nodes and a cache
    affinity on its checkpoint directory: preempted (SIGTERM, scancel-style)
    once it has logged step 0, requeued onto the node whose promoted cache is
    warm, finishing on run A's losses and chunk hashes."""
    from repro_torch.sched.placement import SCORE_WARM, CacheAffinity
    from repro_torch.sched.slurmsim import REQUEUE_EXIT, JobSpec, SlurmSim

    ckpt, metrics = work / "sched", work / "sched.json"
    attempts, consumed = {}, {}

    def before_launch(rec):          # keep each attempt's metrics and wall time
        if rec.requeues:
            attempts[rec.requeues - 1] = json.loads(metrics.read_text())
            consumed[rec.requeues - 1] = rec.consumed_s

    sim = SlurmSim(work / "sim", nodes=2, pre_launch=before_launch)
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_ARGV,
           "--ckpt-dir", str(ckpt), "--metrics-out", str(metrics), "--ckpt-promote", "eager"]
    jid = sim.submit(JobSpec(name="train", cmd=cmd, walltime_s=900, max_requeues=2,
                             env=_child_env(),
                             cache_affinity=CacheAffinity(ckpt_dir=str(ckpt), warm_wait_s=60)))
    out = sim.workdir / "train.out"

    def preempt_after_step0():
        while sim.job(jid).state in ("PENDING", "RUNNING"):
            if out.exists() and "step 0 loss" in out.read_text():
                sim.preempt(jid)
                return
            time.sleep(0.05)

    watcher = threading.Thread(target=preempt_after_step0, daemon=True)
    t0 = time.perf_counter()
    watcher.start()
    sim.run(timeout_s=900)
    watcher.join(timeout=10)
    wall = time.perf_counter() - t0
    rec = sim.job(jid)
    attempts[rec.requeues] = json.loads(metrics.read_text())
    walls = [consumed.get(0, 0.0), rec.consumed_s - consumed.get(0, 0.0)]
    for line in out.read_text().splitlines():
        if line.startswith(("===", "step ", "[train]", "[cr] restore")):
            log(f"    job: {line[:200]}")
    log(f"  job: exit codes {rec.exit_codes}, placements {rec.placements}, attempt walls "
        f"{walls[0]:.1f}s / {walls[1]:.1f}s, sim {wall:.1f}s")
    if rec.state != "COMPLETED" or rec.exit_codes != [REQUEUE_EXIT, 0]:
        raise AssertionError(f"the job ended {rec.state} with exit codes {rec.exit_codes}")
    entry = rec.placement_log[1]
    node = rec.placements[0]
    st = attempts[1]["restore_stats"]
    log(f"  attempt 1 placement {entry['node']} scores {entry['scores']} reasons "
        f"{entry['reasons']}; restore_s {attempts[1]['restore_s']:.3f} (phase 7 run C "
        f"{train_rep['C']['restore_s']:.3f}) tier {st['tier']} promoted {st['promoted']} "
        f"bytes by tier {st['bytes_by_tier']}")
    if entry["node"] != node or entry["scores"][node] != SCORE_WARM:
        raise AssertionError("the requeued attempt was not placed on its warm node")
    if not st["promoted"] or st["bytes_by_tier"].get("shared", 0):
        raise AssertionError("the warm restore read the shared tier")
    steps = attempts[0]["steps"] + attempts[1]["steps"]
    a = train_rep["A"]["steps"]
    same_losses = [s["loss"] for s in steps] == [s["loss"] for s in a]
    same_hashes = _final_hashes(ckpt) == train_rep["hashes_a"]
    log(f"  steps {[s['step'] for s in steps]}; every loss equal to run A's {same_losses}; "
        f"final chunk hashes identical {same_hashes}")
    if [s["step"] for s in steps] != [s["step"] for s in a] or not same_losses or not same_hashes:
        raise AssertionError("the requeued job did not finish bit-identical to run A")
    counts = {}
    for k, m in sorted(attempts.items()):
        if m["launches"] != _train_launches(m, fp_per_save):
            raise AssertionError(f"attempt {k}: launches {m['launches']}")
        for name, n in m["launches"].items():
            counts[name] = counts.get(name, 0) + n
    log(f"  launches over both attempts {counts}")
    shutil.rmtree(ckpt, ignore_errors=True)
    shutil.rmtree(sim.workdir, ignore_errors=True)
    return {"counts": counts, "walls": walls, "restore_s": attempts[1]["restore_s"]}


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
    phase("phase 1 build")
    phase_build()
    phase("phase 2 kernels against their plain versions")
    kern = phase_kernels()
    serve_rep = {}
    for arch in SERVE_ARCHS:
        phase(f"phase 3 serve {arch} at full width with snapshot/migrate/restore")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            serve_rep[arch] = phase_serve(tmp, arch)
    phase("phase 4 reduced models: card against CPU")
    phase_reference("qwen2-0.5b", 24, 64)
    # 70 tokens: two chunks of the SSD kernel, the second ragged
    phase_reference("zamba2-1.2b", 70, 96)
    phase_reference("rwkv6-1.6b", 70, 96)
    phase_reference("qwen3-4b", 24, 64)
    phase_reference("granite-8b", 24, 64)
    for arch in SERVE_ARCHS:
        phase(f"phase 5 where the serving path's device time goes (torch.profiler), {arch}")
        phase_profile(arch)
    work = _work_dir()
    try:
        phase("phase 6 the full-width train state: fingerprints, a profiled step, saves")
        state_rep = phase_state(work)
        phase("phase 7 train qwen2-0.5b at full width through the C/R loop "
            "(--ckpt-delta --ckpt-device-fp): A, B preempted, C requeued")
        train_rep = phase_train(work, state_rep["fp_launches_per_save"])
        phase("phase 8 fleet: serve --follow at full width (qwen2-0.5b) on pushed weights")
        fleet_rep = phase_fleet(work)
        phase("phase 9 scheduler: SlurmSim preempts the phase 7 trainer and requeues it "
            "onto its warm node")
        sched_rep = phase_sched(work, train_rep, state_rep["fp_launches_per_save"])
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # launches over every main-path run of this script: the four serve runs,
    # the train runs of phase 7, the in-process follower and the scheduled
    # job (the checksum kernel is on no main path)
    runs = {arch: r["counts"] for arch, r in serve_rep.items()}
    runs["train"] = train_rep["counts"]
    runs["fleet"] = fleet_rep["counts"]
    runs["sched"] = sched_rep["counts"]
    sources = {"flash": ("src/repro_torch/csrc/flash_attention.cu",
                         "src/repro/kernels/flash_attention.py:75"),
               "flash_decode": ("src/repro_torch/csrc/decode_attention.cu",
                                "src/repro/kernels/decode_attention.py:74"),
               "chunk_fingerprints": ("src/repro_torch/csrc/checksum.cu",
                                      "src/repro/kernels/checksum.py:126"),
               "checksum": ("src/repro_torch/csrc/checksum.cu",
                            "src/repro/kernels/checksum.py:61"),
               "ssd": ("src/repro_torch/csrc/ssd_scan.cu",
                       "src/repro/kernels/_ssd_pallas.py:67"),
               "wkv6": ("src/repro_torch/csrc/wkv6.cu",
                        "src/repro/kernels/_rwkv6_pallas.py:64")}
    kernels, per_shape = [], []
    for name, (src, replaces) in sources.items():
        r = kern[name]
        for sh in r["shapes"]:
            per_shape.append({**sh, "launches": runs.get(sh["source"], {}).get(name, 0)})
        first = r["shapes"][0]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": sum(c.get(name, 0) for c in runs.values()),
                        "max_abs_err": r["max_abs_err"], "ms": first["ms"]["median"],
                        "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
                        "bound_by": first["bound_by"],
                        "library_ms": first["library_ms"] and first["library_ms"]["median"]})
    log(f"all phases passed in {time.perf_counter() - T0:.1f}s")
    # every timed shape with its launches on the main paths (ms and library_ms:
    # device time, median/min/max of 5; call_ms: back-to-back calls by events)
    print(json.dumps({"kernel_shapes": per_shape}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
