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
   the flash kernel's gradient under autograd, the scans' input gradients
   under autograd at the train shapes (bf16 and f32) bit-equal to autograd
   through the plain versions (their backward is that recompute: the
   reference package has no backward kernel either), the backwards' own
   time per call, and at every main-path shape of each kernel: its device
   time and the library call's (torch.profiler's kernel time per call,
   median/min/max of 5, with the library's kernels named), its call time
   (back-to-back calls between CUDA events, bounded by the host), the plain
   version's time (events) and the bound (``kernels/costs.py``'s formula at
   ``launch/roofline.py``'s rates); among them MLA's: ``flash`` at
   (Dq, Dv) = (192, 128) with 128 heads, and with the 8 heads a rank
   computes where "model" has 16 ranks (and ``ssd`` and ``wkv6`` at the
   4 of 64 and 2 of 32 heads a rank computes there), ``flash_decode`` at the absorbed
   shape (one kv head for 128 query heads, Dq 576, Dv 512, V a strided view
   of K's rows, the caller's scale), and both at reduced MLA's (48, 32);
   ``flash_decode``'s log-sum-exp (``return_lse``) at every case against
   the plain version's (2e-5 of max(|lse|, 1) in float32, 2e-3 in
   bfloat16; ``-inf`` where kv_len is 0), its device time with the lse
   beside the time without, and qwen2's decode shape split by position into
   4 blocks, each through the kernel with its lse and merged by
   ``tp.merge_partials``, against the whole cache's kernel;
3. serve: ``repro_torch.launch.serve`` with a snapshot, migration and
   restore half way, at full width and depth for qwen2-0.5b, zamba2-1.2b,
   rwkv6-1.6b, qwen3-4b and granite-moe-3b-a800m (MoE, 40 experts top-8),
   and at full width and 2 of 61 layers for deepseek-v3-671b (MLA, one
   dense and one MoE layer of 256 experts + 1 shared; ``SERVE_DEPTH``); each
   continuation must match the unmigrated run bit for bit, the snapshot must
   be the cache's bytes (EXPECTED_SNAPSHOT_BYTES), and the launch counts
   must show that every attention and SSM scan call went through the
   kernels.  Each model is drawn once (``served_model``) and profiled
   (phase 5) on the same parameters right after it serves;
4. reference: reduced qwen2-0.5b, zamba2-1.2b, rwkv6-1.6b, qwen3-4b,
   granite-8b, granite-moe-3b-a800m, deepseek-v3-671b, musicgen-large (4
   codebooks) and llava-next-mistral-7b (image embeddings over the first
   positions) in float32, the card's path (kernels) against the CPU path
   (plain versions): equal greedy tokens, close logits; and one train step
   (loss, its aux and MTP terms, every gradient) of reduced zamba2, rwkv6,
   granite-moe, deepseek-v3, musicgen and llava;
5. profile: device time by kernel and the device's busy share over one
   prefill and over decode steps at the serve phases' shapes, per arch; for
   the MoE models also the device time of routing, slot assignment,
   dispatch, the experts' products and combine, apart;
6. train state: the qwen2-0.5b train state at full width and 8 of 24 layers
   (params, AdamW m and v: 3.07 GB) after one step, fingerprinted whole on
   the card and held against
   the plain version and the host's fingerprints, with the tree call timed;
   one profiled train step; the same state saved twice with device
   fingerprints (the second save must copy no byte) and once on the host path;
7. train: the C/R loop through ``repro_torch.launch.train --ckpt-delta
   --ckpt-device-fp`` at full width and 4 of qwen2-0.5b's 24 layers (a 2.35
   GB state), as subprocesses: A uninterrupted, B cut by its walltime (exit
   85), C requeued on B's checkpoint; B and C run as a job of one rank (the
   launcher's ``RANK`` ... ``MASTER_PORT``: an NCCL group of one, whose
   all-reduce agrees on each step's exit) and A without a group; A and C
   must end on the same loss and the same chunk hashes, the metrics must
   name the group, and the launch counts must show every attention and
   every save's fingerprinting on the kernels;
8. fleet: a publisher pushes full-width qwen2-0.5b weights (delta
   checkpoints and the registry's push plane); ``repro_torch.launch.serve
   --follow --pipeline-uploads`` as a subprocess must serve the step pushed
   while it runs, with the launches its last line reports, and the same
   follower wiring in this process must give, after its swap, the tokens of
   a fresh engine on the pushed weights;
9. scheduler: ``SlurmSim`` with two nodes runs phase 7's trainer with
   ``--ckpt-promote eager``, preempted (SIGTERM) after its first step: it
   must exit 85, be requeued onto its warm node, exit 0, and end on run A's
   losses and chunk hashes;
10. train the SSM families: (a) in this process, full width and depth,
   zamba2-1.2b (13.86 GB state) and rwkv6-1.6b (19.20 GB) take two AdamW
   steps and one profiled step through ``train/step.py``, no checkpoint:
   finite losses and gradient norms, the scans and the shared attention on
   the kernels (ssd 38 and flash 6 a step; wkv6 24), and the backwards'
   share of the device time; (b) the C/R loop of phase 7 for zamba2-1.2b at
   full width and 6 of its 38 mamba2 layers (a 3.54 GB state): ssd 6 and
   flash 1 a step;
11. train the MoE and MLA families, in this process, B8 S128: (a)
   granite-moe-3b-a800m at full width and depth (3,374,295,552 float32
   parameters, 40.5 GB of state; phase 3's parameters, which are the train
   state's at seed 0) takes two AdamW steps and one profiled step: finite
   loss, aux and gradient norms, flash 32 a step, the forward's MoE steps'
   and the backwards' shares of the device time; (b) deepseek-v3-671b at
   full width cut to its one dense layer, an empty MoE segment and the MTP
   block (3,123,099,648 bfloat16 parameters, float32 moments), the same,
   with the MTP loss, flash 2 a step at (192, 128); (c) the reference's C/R
   cycle for granite-moe at full width and 1 layer: one step, a
   device-fingerprint save and commit, a restore through a fresh manager,
   and the next step on the continuing and the restored state, bit-equal;
12. parallelism: (a) the card's mesh (``launch.mesh.make_host_mesh``) is
   (1, 1) with no process group, and the mesh rules replicate every leaf of
   full-width qwen2-0.5b's, granite-moe-3b-a800m's and deepseek-v3-671b's
   train state, cache and batch (one batch shard: MoE routes with one
   group; on a mesh of one rank this holds by construction); phases 3-11
   run through those rules and ``place_tree`` as they are; (b)
   ``ops.attention(impl="ring")`` at qwen2's prefill shape: a ring over a
   "model" axis of one rank is attention, so under the (1, 1) mesh context,
   as with no mesh, it launches ``flash`` once and returns flash's output,
   within 5e-2 (bfloat16) of the plain version, with both device times; (c) the reference's elastic scenario (tests/test_elastic.py,
   reduced llama3.2-1b) across the card: two CPU ranks over gloo at mesh
   (2, 1) train three steps and save, then restore the save at (2, 1) and at
   (1, 2) and take step 4, the (1, 2) step on each rank's "model" blocks
   (``parallel/tp.py``: attention, SwiGLU, embedding and the vocabulary's
   cross entropy split over the two ranks; its count of block products
   above 0); the card restores it and takes step 4 too; every step-4 loss
   within 5e-4 of the (2, 1) restore's, and the card's re-save of the
   restored state keeps the CPU save's chunk hashes bit for bit; (d) on the
   same two CPU ranks at (1, 2), reduced qwen2-0.5b (its cache a kv head a
   rank) and reduced deepseek-v3 (MLA's latent cache 16 positions a rank,
   its products on 2 of the 4 heads a rank), reduced zamba2 (Mamba2 on 4 of
   8 heads a rank, its ssm states those heads; the shared block's cache a
   kv head a rank) and reduced rwkv6 (2 of 4 heads a rank), and at (2, 1)
   reduced granite-moe (4 of 8 experts a rank, all-to-alls), serve on
   blocks, each rank's count of products on a block as the CPU rehearsal
   counts it (``SERVE_TP_PRODUCTS``), and snapshot at token 4 (the whole
   cache, gathered); the card restores each snapshot at (1, 1) and
   continues with the ranks' tokens, flash_decode once an attention layer a
   step (zamba2's shared block once a group; rwkv6 none);
13. analysis: (a) phase 2's bounds read as PERF.md's table prints them
   (EXPECTED_BOUNDS); (b) a train step of qwen2-0.5b at full width and 8
   layers on the card under ``launch/hlo_costs.py``'s walk against the dry
   run of the same step on meta tensors: FLOPs and kernel calls equal, the
   arguments' bytes equal to the live state's and batch's, the predicted
   peak within 25% of the allocator's; (c) ``python -m
   repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k --mesh pod``
   (and ``--shape decode_32k`` and ``prefill_32k``, the three started
   together) and ``python -m repro_torch.launch.roofline`` as CPU
   subprocesses (started with phase 11(c)) exit 0 with ok records, whose
   steps compute on "model" blocks: train_4k's FLOPs a rank at most 1.0e14
   and 6ND/walk at least 0.11 (the step that gathered every parameter
   whole: 2.751e14 and 0.04), and the gradients' collectives (the walk's
   "grads" section) at most 1/8 of that step's 7.9 GB a rank; the serving
   cells with the cache as the rules' blocks within SERVE_LIMITS
   (decode_32k FLOPs a rank at most 5e9, output at most 0.5 GB, no
   all-gather as large as a cache leaf's block; prefill_32k FLOPs at most
   1.0e14, temporaries at most 3 GB); (d) each step the
   earlier phases time on the device (5, 6, 10(a), 11(a)-(b)) as a share of
   the peak: model FLOPs over (device time x peak), none above 1.05.

Phase 12(c)-(d)'s two CPU ranks run ``chip_smoke.py --gloo-child RANK WORLD STORE
WORK``, with no card, meet through a ``FileStore``, and start with phase 11(b).  The C/R loops
of phases 7, 9 and 10(b) run ``repro_torch.launch.train.main``
in a child process of this script (``chip_smoke.py --train-child ARCH LAYERS
ARGS``), which cuts the config's depth to LAYERS first; full-depth training
is phase 10(a) and 11, in process and without saves (11(c): one save of a
cut state), so that the whole keeps inside its time limit.  Every child has a deadline, about three times its
expected wall time on a slow-disk machine, past which it is killed and the
phase fails with the end of its output.

It prints a ``kernel_shapes`` JSON line (every timed shape with its launches
on the main paths), a ``phase_seconds`` JSON line (each phase's wall time and
the GB its saves wrote), a ``kernels`` JSON line (each kernel at its first
shape) and the card's name and power limit before the last line, and as the
last line ``{"ok": true, "device": {...}}``.
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
    # 32 attention + MoE layers, 24 query / 8 KV heads of 64
    "granite-moe-3b-a800m": {"flash": 64, "flash_decode": 2048, "ssd": 0, "wkv6": 0},
    # 2 MLA layers (SERVE_DEPTH): flash at (192, 128), flash_decode absorbed
    "deepseek-v3-671b": {"flash": 4, "flash_decode": 128, "ssd": 0, "wkv6": 0},
}
SERVE_ARCHS = tuple(EXPECTED_LAUNCHES)
# depth cuts of the served configs: deepseek-v3's 61 layers (671B parameters)
# do not fit one card; 2 keep one layer of each kind at full width, the cut
# ``reduced()`` makes to ``first_dense_layers`` (14,630,385,664 parameters,
# 29.26 GB in its own bfloat16, with the unused MTP block)
SERVE_DEPTH = {"deepseek-v3-671b": 2}     # serve's --num-layers
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
    # 32 layers x K,V x 4 x 1024 x 8 KV heads x 64 x bfloat16
    "granite-moe-3b-a800m": 268_435_476,
    # 2 layers x 4 x 1024 x the 576-wide latent (512 + rope 64) x bfloat16
    "deepseek-v3-671b": 9_437_204,
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
TRAIN_ARGV = ["--batch", "8", "--seq", "128", "--steps", str(TRAIN_STEPS), "--ckpt-delta",
              "--ckpt-device-fp"]
# the C/R loops' depth, cut so that the script keeps inside its time limit:
# qwen2-0.5b 4 of 24 layers (phases 7, 9: 8 until phase 11 came), zamba2-1.2b
# 6 of 38 (phase 10(b): one shared-attention group); full width both
TRAIN_LAYERS = {"qwen2-0.5b": 4, "zamba2-1.2b": 6}
# phase 6's train state: qwen2-0.5b at full width and 8 of 24 layers (3.07 GB,
# still past 2^31 bytes; full depth, 5.93 GB, until phase 12 came: its first
# save's write took 28 s of a run that passed 800 s)
STATE_LAYERS = 8
# kernel launches of one train step (one forward; the backwards launch none)
STEP_LAUNCHES = {"qwen2-0.5b": {"flash": 4},
                 "zamba2-1.2b": {"flash": 1, "ssd": 6},
                 "full zamba2-1.2b": {"flash": 6, "ssd": 38},
                 "full rwkv6-1.6b": {"wkv6": 24},
                 "full granite-moe-3b-a800m": {"flash": 32},
                 # one mla_dense layer, an empty mla_moe segment, the MTP block
                 "deepseek-v3-671b 1 dense layer + MTP": {"flash": 2},
                 "granite-moe-3b-a800m C/R cut": {"flash": 1}}
# phase 11(b)'s cut of deepseek-v3: its one dense layer and the MTP block at
# full width (3,123,099,648 parameters, 31.2 GB of state with float32
# moments).  A single mla_moe layer holds 11.5 billion parameters, so no cut
# with an MoE layer trains on one card; ``configs.base.cut_depth(cfg, 1)``
# keeps the MoE layer, not the dense one
MLA_TRAIN_CUT = {"num_layers": 1, "first_dense_layers": 1}
# phase 11(c)'s C/R cycle: granite-moe at full width and 1 of 32 layers (a
# 3.02 GB state; 2 layers, 4.23 GB, took the script past 800 s), in process,
# one save: three saves of the full 40.5 GB state would break the time limit
MOE_CR_LAYERS = 1
# about 8 GB on disk at a time (phase 9: two saves of the 2.35 GB state and
# a promoted copy); the saves write ~36 GB over the script
TRAIN_DISK_BYTES = 20e9
# phase 12: the full-width trees whose every leaf must resolve to replicated on
# the card's (1, 1) mesh, and the elastic scenario of the reference's
# tests/test_elastic.py (reduced llama3.2-1b, B8 S32 from seed 5, three steps,
# a save, step 4 on each restore), on two CPU ranks over gloo and on the card
PARALLEL_ARCHS = ("qwen2-0.5b", "granite-moe-3b-a800m", "deepseek-v3-671b")
ELASTIC_ARCH = "llama3.2-1b"
ELASTIC_OPT = {"warmup_steps": 2, "decay_steps": 10}
# the reference's limit on a step-4 loss under another mesh (reductions reassociate)
ELASTIC_TOL = 5e-4
# phase 12(d): serving on blocks on the two CPU ranks: at (1, 2) over "model",
# reduced qwen2-0.5b (its cache on kv_heads_dim: 2 kv heads, a head a rank)
# and reduced deepseek-v3 (MLA's latent on cache_seq: 16 positions a rank;
# its products on 2 of the 4 heads a rank, its experts' and shared expert's
# moe_d_ff on half a rank); at (2, 1) over "data", reduced granite-moe (4 of
# 8 experts a rank, the dispatched slots moved by all-to-alls); at (1, 2)
# reduced zamba2 (its Mamba2 mixers on 4 of 8 heads a rank, their ssm states
# those heads, the conv windows whole; the shared block's cache a kv head a
# rank) and reduced rwkv6 (2 of 4 heads a rank, its wkv states those heads);
# B4, prompts of 12, a cache of 32, a snapshot at token 4 and 4 tokens after it
SERVE_TP_ARCHS = {"qwen2-0.5b": (1, 2), "deepseek-v3-671b": (1, 2),
                  "granite-moe-3b-a800m": (2, 1), "zamba2-1.2b": (1, 2),
                  "rwkv6-1.6b": (1, 2)}
SERVE_TP = {"batch": 4, "prompt": 12, "max_seq": 32, "snap_at": 4, "after": 4}
# each rank's products on a "model" block over the 9 steps, as the CPU
# rehearsal of 12(d) counts them: the attention's four a layer a step (MLA's
# wq_b, wk_b, wv_b, wo; GQA's wq, wk, wv, wo), the dense SwiGLU's three, the
# MoE layers' three expert and three shared-expert products, the logits';
# Mamba2's in_proj and out_proj on its heads, zamba2's shared_in, RWKV6's
# time-mix six (wr, wk, wv, wg, the decay LoRA's second, wo) and channel-mix
# two (zamba2: 4 x 2 + 2 x (1 + 4 + 3) + 1 a step; rwkv6: 4 x 8 + 1)
SERVE_TP_PRODUCTS = {"qwen2-0.5b": 261, "deepseek-v3-671b": 342, "granite-moe-3b-a800m": 0,
                     "zamba2-1.2b": 225, "rwkv6-1.6b": 297}
# the card's continuation against the ranks': phase 4's limit (card and CPU)
SERVE_TP_LOGIT_TOL = 1e-3
# deadlines of the child processes, about 3x their wall time on a slow disk
GLOO_DEADLINE_S = 150
TRAIN_RUN_DEADLINE_S = 300
FOLLOW_DEADLINE_S = 300
SCHED_DEADLINE_S = 450

def log(msg: str) -> None:
    print(msg, flush=True)


T0 = time.perf_counter()
PHASE_SECONDS: dict = {}          # phase -> wall seconds
_current = ["0", T0]


def phase(msg: str) -> None:
    """A phase's heading ("phase N ..."), with the seconds since the script
    started; the time since the previous heading goes to that phase's
    entry of PHASE_SECONDS."""
    now = time.perf_counter()
    key, start = _current
    PHASE_SECONDS[key] = PHASE_SECONDS.get(key, 0.0) + now - start
    _current[:] = [msg.split()[1] if msg.startswith("phase ") else msg, now]
    log(f"{msg} [{now - T0:.1f}s]")


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
            # the kernels of a run, by name (the library's choice of backend)
            names = sorted({e.name[:80] for e in runs[-1]})
            return {**spread(per_call), "kernels": names}
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


def bound(cost: tuple, dtype: str) -> tuple[float, str]:
    """The least ms the card could take for a kernel's (flops, bytes)
    (``kernels/costs.py``), at the rates of ``launch/roofline.py``, and
    which of the two bounds it."""
    from repro_torch.launch.roofline import HBM_BYTES_PER_S, PEAK_FLOPS

    flops, nbytes = cost
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
# they carry: (label, B, S, H, Hkv, Dq, Dv, launch source)
FLASH_SHAPES = [("qwen2-0.5b prefill", 4, 512, 14, 2, 64, 64, "qwen2-0.5b"),
                ("zamba2-1.2b shared block", 4, 512, 32, 32, 64, 64, "zamba2-1.2b"),
                ("qwen2-0.5b train forward", 8, 128, 14, 2, 64, 64, "train"),
                ("zamba2-1.2b train forward", 8, 128, 32, 32, 64, 64, "train-zamba2"),
                ("qwen3-4b prefill", 4, 512, 32, 8, 128, 128, "qwen3-4b"),
                ("granite-moe-3b-a800m prefill", 4, 512, 24, 8, 64, 64,
                 "granite-moe-3b-a800m"),
                ("deepseek-v3-671b MLA prefill", 4, 512, 128, 128, 192, 128,
                 "deepseek-v3-671b"),
                ("reduced deepseek-v3 MLA prefill (phase 4)", 2, 24, 4, 4, 48, 32,
                 "reduced deepseek-v3-671b"),
                ("granite-moe-3b-a800m train forward", 8, 128, 24, 8, 64, 64,
                 "train-granite-moe"),
                ("deepseek-v3-671b MLA train forward", 8, 128, 128, 128, 192, 128,
                 "train-deepseek-v3"),
                # one rank's 8 of the 128 heads where "model" has 16 ranks (the
                # production mesh's): no run of this script launches it, the card
                # being one rank
                ("deepseek-v3-671b MLA prefill, a rank's heads at model 16", 4, 512, 8, 8,
                 192, 128, "deepseek-v3-671b over model 16")]
DECODE_KV_LEN = 544      # the serve phases' last position: prompt 512 + 32
# flash_decode's log-sum-exp against the plain version's, of max(|lse|, 1):
# the kernel and the plain version both sum in float32 (bfloat16 only in the
# inputs, read alike), so only the order of the sums differs
LSE_TOL = {"float32": 2e-5, "bfloat16": 2e-3}
SPLIT_BLOCKS = 4         # the split-by-position check: "model" ranks of cache_seq
# (label, B, S, H, Hkv, Dq, Dv, kv_len, launch source, MLA config); a row with
# an MLA config is MLA's absorbed decode: one kv head, V the first Dv columns
# of K's rows (a view), the scale ``models.attention.mla_scale`` of that config
# (1/sqrt(qk_head_dim) in float32, as the model passes it); the other rows
# take the kernel's default 1/sqrt(Dq), as a GQA model does
DECODE_SHAPES = [("qwen2-0.5b decode", 4, 1024, 14, 2, 64, 64, DECODE_KV_LEN, "qwen2-0.5b",
                  None),
                 ("zamba2-1.2b decode", 4, 1024, 32, 32, 64, 64, DECODE_KV_LEN,
                  "zamba2-1.2b", None),
                 ("qwen3-4b decode", 4, 1024, 32, 8, 128, 128, DECODE_KV_LEN, "qwen3-4b",
                  None),
                 ("granite-moe-3b-a800m decode", 4, 1024, 24, 8, 64, 64, DECODE_KV_LEN,
                  "granite-moe-3b-a800m", None),
                 ("deepseek-v3-671b MLA absorbed decode", 4, 1024, 128, 1, 576, 512,
                  DECODE_KV_LEN, "deepseek-v3-671b", "deepseek-v3-671b"),
                 ("reduced deepseek-v3 MLA absorbed decode (phase 4)", 2, 64, 4, 1, 48, 32,
                  32, "reduced deepseek-v3-671b", "reduced deepseek-v3-671b")]


def phase_kernels() -> dict:
    """Every kernel against its plain version; device times at the main
    paths' shapes."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs.base import get_config, reduced
    from repro_torch.kernels import costs, decode_attention, flash_attention, ref
    from repro_torch.models.attention import mla_scale

    deepseek = get_config("deepseek-v3-671b")
    mla = {None: None, "deepseek-v3-671b": mla_scale(deepseek),
           "reduced deepseek-v3-671b": mla_scale(reduced(deepseek))}
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
        (4, 512, 24, 8, 64, 64, "bfloat16", True),     # granite-moe's prefill, G = 3
        (4, 512, 128, 128, 192, 128, "bfloat16", True),   # deepseek-v3's MLA prefill
        (2, 24, 4, 4, 48, 32, "bfloat16", True),       # reduced MLA's prefill
        (2, 24, 4, 4, 48, 32, "float32", True),        # ... as phase 4 runs it
        (2, 70, 4, 4, 48, 32, "float32", True),
        (8, 128, 24, 8, 64, 64, "bfloat16", True),       # granite-moe's train forward
        (8, 128, 128, 128, 192, 128, "bfloat16", True),  # deepseek-v3's MLA train forward
        (4, 512, 8, 8, 192, 128, "bfloat16", True),    # its prefill on a rank's heads, model 16
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
    for label, B, S, H, Hkv, Dq, Dv, source in FLASH_SHAPES:
        sets = copies_past_l2([_randn(s, torch.bfloat16, gen) for s in
                               ((B, S, H, Dq), (B, S, Hkv, Dq), (B, S, Hkv, Dv))])

        def kern(q, k, v):
            return flash_attention.flash(q, k, v, causal=True)

        lib_sets = [tuple(t.transpose(1, 2) for t in s) for s in sets]

        def lib(q, k, v):
            return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

        b_ms, b_by = bound(costs.flash(B, S, S, H, Hkv, Dq, Dv, elt), "bfloat16")
        dims = f"D{Dq}" if Dq == Dv else f"Dq{Dq} Dv{Dv}"
        shapes.append(dict(
            kernel="flash", label=label, source=source,
            shape=f"B{B} S{S} H{H} Hkv{Hkv} {dims} bfloat16 causal",
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
    decode_cases = [(B, S, H, Hkv, D, D, dtn, kvls, None) for B, S, H, Hkv, D, dtn, kvls in
                    decode_cases]
    decode_cases += [  # B, S, H, Hkv, Dq, Dv, dtype, kv_lens, MLA config (absorbed)
        (4, 1024, 24, 8, 64, 64, "bfloat16", (1, 65, 544, 1024), None),   # granite-moe, G = 3
        (4, 1024, 128, 1, 576, 512, "bfloat16", (0, 1, 63, 64, 65, 544, 1024),
         "deepseek-v3-671b"),
        (2, 64, 4, 1, 48, 32, "bfloat16", (1, 25, 32, 64), "reduced deepseek-v3-671b"),
        (2, 64, 4, 1, 48, 32, "float32", (1, 25, 32, 64), "reduced deepseek-v3-671b"),
    ]
    worst = lse_worst = 0.0
    for B, S, H, Hkv, Dq, Dv, dtn, kv_lens, mla_cfg in decode_cases:
        q = _randn((B, 1, H, Dq), dt[dtn], gen)
        k = _randn((B, S, Hkv, Dq), dt[dtn], gen)
        # MLA: V is the first Dv columns of K's rows, a strided view
        v = k[..., :Dv] if mla_cfg else _randn((B, S, Hkv, Dv), dt[dtn], gen)
        scale = mla[mla_cfg]
        for kv_len in kv_lens:
            kvl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
            got = decode_attention.flash_decode(q, k, v, kv_len=kvl, scale=scale)
            want, want_lse = ref.attention(q.float(), k.float(), v.float(), causal=False,
                                           kv_len=kv_len, scale=scale, return_lse=True)
            again, lse = decode_attention.flash_decode(q, k, v, kv_len=kvl, scale=scale,
                                                       return_lse=True)
            torch.cuda.synchronize()
            err, excess, ok = attn_check("flash_decode", got, want, dtn)
            same = torch.equal(got, again)
            lse_err, lse_ok = lse_check(lse, want_lse, dtn)
            ok = ok and same and lse_ok
            dims = (f"Dq{Dq} Dv{Dv} (v a view of k) scale {scale!r}" if mla_cfg
                    else f"D{Dq}" if Dq == Dv else f"Dq{Dq} Dv{Dv}")
            log(f"  flash_decode B{B} S{S} H{H} Hkv{Hkv} {dims} {dtn} kv_len={kv_len}: "
                f"max_abs_err {err:.3g} (tol {TOL[dtn]})"
                f"{_excess_note('flash_decode', excess, dtn)} repeatable={same}; lse "
                f"{lse_err:.3g} of max(|lse|, 1) (tol {LSE_TOL[dtn]}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(
                    f"flash_decode disagrees with its plain version: {err}, {excess}, "
                    f"lse {lse_err}, the output with its lse the same {same}")
            worst, lse_worst = max(worst, err), max(lse_worst, lse_err)
    shapes = []
    for label, B, S, H, Hkv, Dq, Dv, kv_len, source, mla_cfg in DECODE_SHAPES:
        kvl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
        scale = mla[mla_cfg]
        absorbed = mla_cfg is not None
        shs = ((B, 1, H, Dq), (B, S, Hkv, Dq)) + (() if absorbed else ((B, S, Hkv, Dv),))
        sets = copies_past_l2([_randn(s, torch.bfloat16, gen) for s in shs])
        if absorbed:        # (q, k, v as the view of k's rows the model passes)
            sets = [(q, k, k[..., :Dv]) for q, k in sets]

        def kern(q, k, v):
            return decode_attention.flash_decode(q, k, v, kv_len=kvl, scale=scale)

        lib_sets = [(q.transpose(1, 2), k[:, :kv_len].transpose(1, 2),
                     v[:, :kv_len].transpose(1, 2)) for q, k, v in sets]

        def lib(q, k, v):
            return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, scale=scale)

        def kern_lse(q, k, v):
            return decode_attention.flash_decode(q, k, v, kv_len=kvl, scale=scale,
                                                 return_lse=True)

        library = device_ms(lib, lib_sets)
        if absorbed:
            # one kv head: the same function is one SDPA call without GQA, the
            # G query heads folded into the query length (q (B, 1, G, Dq) is
            # already that layout); the faster of the two calls is the library's
            fold_sets = [(q, k[:, :kv_len].transpose(1, 2), v[:, :kv_len].transpose(1, 2))
                         for q, k, v in sets]

            def lib_folded(q, k, v):
                return F.scaled_dot_product_attention(q, k, v, scale=scale)

            folded = lib_folded(*fold_sets[0]).float()
            err = (folded - lib(*lib_sets[0]).transpose(1, 2).float()).abs().max().item()
            if not err <= TOL["bfloat16"]:
                raise AssertionError(f"the folded SDPA call is not the GQA call's function: {err}")
            calls = {"gqa": library, "folded": device_ms(lib_folded, fold_sets)}
            library = min(calls.values(), key=lambda st: st["median"])
            for how, st in calls.items():
                log(f"  flash_decode library, {label}, {how} call: device ms {fmt(st)} "
                    f"({', '.join(k[:60] for k in st['kernels'][:3])})")

        b_ms, b_by = bound(costs.flash_decode(B, S, H, Hkv, Dq, Dv, kv_len, elt,
                                              v_is_k=absorbed), "bfloat16")
        dims = f"Dq{Dq} Dv{Dv} (v a view of k)" if absorbed else f"D{Dq}"
        shapes.append(dict(
            kernel="flash_decode", label=label, source=source,
            shape=f"B{B} S{S} H{H} Hkv{Hkv} {dims} bfloat16 kv_len={kv_len} "
                  f"({decode_attention.num_splits(S)} splits, "
                  f"{decode_attention.heads_per_cta(Dq, Dv, H // Hkv, elt)} heads a CTA)",
            ms=device_ms(kern, sets), call_ms=call_ms(kern, sets), library_ms=library,
            lse_ms=device_ms(kern_lse, sets),
            plain_ms=timed_ms(lambda q, k, v: ref.attention(q, k, v, causal=False,
                                                            kv_len=kvl, scale=scale), sets),
            bound_ms=b_ms, bound_by=b_by))
    report["flash_decode"] = dict(max_abs_err=worst, lse_max_err=lse_worst, shapes=shapes,
                                  split=_split_decode(gen))
    for r in report["flash"]["shapes"] + shapes:
        with_lse = f" (with its lse {fmt(r['lse_ms'])})" if "lse_ms" in r else ""
        log(f"  {r['kernel']} timing, {r['label']} ({r['shape']}): device ms {fmt(r['ms'])}"
            f"{with_lse}  call_ms {fmt(r['call_ms'])}  library device ms {fmt(r['library_ms'])} "
            f"({', '.join(k[:40] for k in r['library_ms']['kernels'][:3])})"
            f"  plain_ms {r['plain_ms']:.4f}  bound_ms {r['bound_ms']:.6f} ({r['bound_by']})")

    # ---- flash under autograd: kernel forward, plain backward (training) ----
    grad_worst = 0.0
    train_shapes = [sh for sh in FLASH_SHAPES if sh[-1].startswith("train")]
    for label, B, S, H, Hkv, Dq, Dv, _ in train_shapes:
        q, k, v = (_randn(s, torch.bfloat16, gen).requires_grad_()
                   for s in ((B, S, H, Dq), (B, S, Hkv, Dq), (B, S, Hkv, Dv)))
        go = _randn((B, S, H, Dv), torch.bfloat16, gen)
        out = flash_attention.flash(q, k, v, causal=True)
        grads = torch.autograd.grad(out, (q, k, v), go)
        plain_in = [t.detach().float().requires_grad_() for t in (q, k, v)]
        want = ref.attention(*plain_in, causal=True)
        want_grads = torch.autograd.grad(want, plain_in, go.float())
        torch.cuda.synchronize()
        errs = [(a.detach().float() - b.detach()).abs().max().item() for a, b in
                zip((out, *grads), (want, *want_grads))]
        ok = (all(e <= TOL["bfloat16"] for e in errs)
              and all(bool(torch.isfinite(g).all()) for g in grads))
        log(f"  flash gradient, {label} (B{B} S{S} H{H} Hkv{Hkv} Dq{Dq} Dv{Dv} bfloat16): "
            "max_abs_err out/dq/dk/dv " + "/".join(f"{e:.3g}" for e in errs)
            + f" (tol {TOL['bfloat16']}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash's gradient disagrees with the plain version's: {errs}")
        grad_worst = max(grad_worst, *errs[1:])
        del q, k, v, go, out, grads, plain_in, want, want_grads
    report["flash"]["grad_max_abs_err"] = grad_worst
    report["flash"]["backward_ms"] = {
        label: backward_ms(flash_attention.flash, [_randn(sh, torch.bfloat16, gen) for sh in (
            (B, S, H, Dq), (B, S, Hkv, Dq), (B, S, Hkv, Dv))], dict(causal=True))
        for label, B, S, H, Hkv, Dq, Dv, _ in train_shapes}
    for label, t in report["flash"]["backward_ms"].items():
        log(f"  flash backward (plain recompute), {label}: {fmt(t)} ms per call (events)")
    for sh in report["flash"]["shapes"]:            # into the kernel_shapes line
        if sh["label"] in report["flash"]["backward_ms"]:
            sh["backward_ms"] = report["flash"]["backward_ms"][sh["label"]]

    report.update(_checksum_kernels(gen))
    report.update(_scan_kernels(gen))
    return report


def backward_ms(fn, inputs, kw, repeats: int = 5, iters: int = 3) -> dict:
    """Time per call of the backward of ``fn(*inputs, **kw)`` under autograd
    (every input needing a gradient), between CUDA events: the graph is
    kept, and each call runs the backward alone for a fixed upstream
    gradient."""
    import torch

    leaves = [t.clone().requires_grad_() for t in inputs]
    out = fn(*leaves, **kw)
    go = torch.ones_like(out)
    torch.autograd.grad(out, leaves, go, retain_graph=True)
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            torch.autograd.grad(out, leaves, go, retain_graph=True)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / iters)
    return spread(times)


def lse_check(got, want, dtn: str) -> tuple[float, bool]:
    """The kernel's log-sum-exp against the plain version's: the largest
    |difference| over max(|lse|, 1) (within LSE_TOL), ``-inf`` exactly
    where the plain version has it (no key below kv_len)."""
    import torch

    got, want = got.float(), want.float()
    empty = torch.isneginf(want)
    if not torch.equal(torch.isneginf(got), empty) or not bool(torch.isfinite(got[~empty]).all()):
        return math.inf, False
    if bool(empty.all()):
        return 0.0, True
    err = ((got - want)[~empty].abs() / want[~empty].abs().clamp(min=1.0)).max().item()
    return err, err <= LSE_TOL[dtn]


def _split_decode(gen) -> dict:
    """qwen2-0.5b's decode shape (B4 S1024 H14 Hkv2 D64 bfloat16, kv_len
    DECODE_KV_LEN) as a cache split by position into SPLIT_BLOCKS blocks,
    as "model" ranks hold it under ``cache_seq``: each block through the
    kernel with its lse and its own kv_len (``tp.local_kv_len``'s: the last
    block holds no key), merged by ``tp.merge_partials`` in block order,
    against the whole-cache kernel within phase 2's attention tolerance
    (TOL, and per element ``attn_check``'s atol + rtol |whole| plus what the
    blocks' own bfloat16 outputs carry in: 2^-8 of the lse-weighted mean of
    their |output|)."""
    import torch

    from repro_torch.kernels import decode_attention
    from repro_torch.parallel import tp

    B, S, H, Hkv, D = 4, 1024, 14, 2, 64
    q = _randn((B, 1, H, D), torch.bfloat16, gen)
    k, v = (_randn((B, S, Hkv, D), torch.bfloat16, gen) for _ in range(2))
    n = S // SPLIT_BLOCKS
    kvl = torch.tensor(DECODE_KV_LEN, dtype=torch.int32, device="cuda")
    whole = decode_attention.flash_decode(q, k, v, kv_len=kvl)
    outs, lses, lens = [], [], []
    for r in range(SPLIT_BLOCKS):
        local = torch.clamp(kvl - r * n, 0, n).to(torch.int32)
        o, lse = decode_attention.flash_decode(q, k[:, r * n:(r + 1) * n].contiguous(),
                                               v[:, r * n:(r + 1) * n].contiguous(),
                                               kv_len=local, return_lse=True)
        outs.append(o)
        lses.append(lse)
        lens.append(int(local))
    merged = tp.merge_partials(outs, lses)
    carried = 2.0 ** -8 * tp.merge_partials([o.float().abs() for o in outs], lses)
    torch.cuda.synchronize()
    diff = (merged.float() - whole.float()).abs()
    atol, rtol = ATTN_BF16_TOL["flash_decode"]
    err = diff.max().item()
    excess = (diff - rtol * whole.float().abs() - carried).max().item()
    ok = err <= TOL["bfloat16"] and excess <= atol and bool(torch.isfinite(merged).all())
    empty = [bool(torch.isneginf(lse).all()) for lse in lses]
    log(f"  flash_decode split by position: B{B} S{S} H{H} Hkv{Hkv} D{D} bfloat16 kv_len "
        f"{DECODE_KV_LEN} in {SPLIT_BLOCKS} blocks of {n} (kv_len {lens}, lse -inf {empty}), "
        f"merged by lse: max_abs_err {err:.3g} against the whole cache's kernel (tol "
        f"{TOL['bfloat16']}), beyond {rtol}|whole| + 2^-8 of the blocks' |output| "
        f"{excess:.3g} (atol {atol}) {'ok' if ok else 'FAIL'}")
    if not ok or empty != [n_ == 0 for n_ in lens]:
        raise AssertionError(f"the merged blocks disagree with the whole cache: {err}, "
                             f"{excess}, empty blocks {empty} of kv_lens {lens}")
    return {"max_abs_err": err, "kv_lens": lens}


def _checksum_kernels(gen) -> dict:
    """chunk_fingerprints and checksum against their plain versions, bit for
    bit; timed on the embed table's aligned body (the largest launch of a
    qwen2-0.5b save: 519 chunks of 1 MiB)."""
    import torch

    from repro_torch.kernels import checksum as CK
    from repro_torch.kernels import costs, ops, ref

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
    out = {}
    for name, fn, plain, cost, source in (
            ("chunk_fingerprints", lambda w: CK.chunk_fingerprints(w, cw),
             lambda w: ref.chunk_fingerprints(w, cw),
             costs.chunk_fingerprints(body.numel(), cw), "train"),
            ("checksum", lambda w: CK.checksum(w, block=2048),
             lambda w: ref.checksum(w), costs.checksum(body.numel()), None)):
        b_ms, b_by = bound(cost, "uint32")
        r = dict(kernel=name, label="qwen2-0.5b embed table", source=source,
                 shape=f"{body.numel()} words (519 x 1 MiB) int32",
                 ms=device_ms(fn, [(body,)]), call_ms=call_ms(fn, [(body,)]), library_ms=None,
                 plain_ms=timed_ms(plain, [(body,)], iters=3), bound_ms=b_ms, bound_by=b_by)
        out[name] = dict(max_abs_err=0.0, shapes=[r])
        log(f"  {name} timing ({r['shape']}): device ms {fmt(r['ms'])}  call_ms "
            f"{fmt(r['call_ms'])}  plain_ms {r['plain_ms']:.4f}  library none  "
            f"bound_ms {b_ms:.5f} ({b_by})")
    return out


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
                ((2, 500, 8, 64, 64), "float32", True, True),
                (RANK_SCAN_SHAPES["ssd"], "bfloat16", False, True)],
        "wkv6": [((4, 512, 32, 64), "bfloat16", False, True),      # rwkv6's prefill
                 ((4, 500, 32, 64), "bfloat16", True, True),
                 ((1, 70, 2, 128), "bfloat16", True, True),
                 ((2, 96, 1, 16), "bfloat16", False, True),
                 ((2, 37, 3, 32), "bfloat16", True, True),
                 ((4, 512, 32, 64), "float32", False, True),
                 ((2, 128, 3, 32), "float32", False, False),       # tests/test_kernels.py:106
                 ((1, 64, 2, 64), "float32", True, False),
                 ((2, 96, 1, 16), "float32", False, False),
                 ((2, 500, 4, 64), "float32", True, True),
                 (RANK_SCAN_SHAPES["wkv6"], "bfloat16", False, True)],
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
        shapes = [_scan_timing(name, kernel, plain, cases[name][0][0], f"{source} prefill",
                               source, True, gen),
                  _scan_timing(name, kernel, plain, TRAIN_SCAN_SHAPES[name],
                               f"{source} train forward", f"train-{source.split('-')[0]}",
                               False, gen),
                  _scan_timing(name, kernel, plain, RANK_SCAN_SHAPES[name],
                               f"{source} prefill, a rank's heads at model 16",
                               f"{source} over model 16", True, gen)]
        out[name] = dict(max_abs_err=worst, shapes=shapes, **_scan_gradients(name, gen))
    return out


# the scans' shapes on the train paths (B8 S128, no state in or out)
TRAIN_SCAN_SHAPES = {"ssd": (8, 128, 64, 64, 64), "wkv6": (8, 128, 32, 64)}
# the prefill scans at one rank's heads where "model" has 16 ranks (the
# production mesh's): zamba2's 4 of 64, rwkv6's 2 of 32; no run of this
# script launches them, the card being one rank
RANK_SCAN_SHAPES = {"ssd": (4, 512, 4, 64, 64), "wkv6": (4, 512, 2, 64)}


def _scan_timing(name, kernel, plain, shape, label, source, state_out, gen) -> dict:
    """A bfloat16 scan's device time, call time, plain time and bound at
    ``shape``, with the final state written or not."""
    import torch

    from repro_torch.kernels import costs

    args, _ = _scan_inputs(name, shape, torch.bfloat16, gen, False)
    sets = copies_past_l2(args)

    def kern(*a):
        return kernel(*a, return_state=state_out)

    plain_ms = timed_ms(lambda *a: plain(*a, return_state=state_out), sets, iters=3)
    elt = args[0].element_size()
    flops, nbytes = getattr(costs, name)(*shape, elt, state_out=state_out)
    b_ms, b_by = bound((flops, nbytes), "bfloat16")
    r = dict(kernel=name, label=label, source=source,
             shape=f"{'x'.join(map(str, shape))} bfloat16"
                   + (", final state out" if state_out else ", no state"),
             ms=device_ms(kern, sets), call_ms=call_ms(kern, sets), library_ms=None,
             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    log(f"  {name} timing, {label} ({r['shape']}): device ms {fmt(r['ms'])}  call_ms "
        f"{fmt(r['call_ms'])}  plain_ms {plain_ms:.4f}  library none  bound_ms "
        f"{b_ms:.5f} ({b_by}; {nbytes} bytes, {flops} flops)")
    return r


def _scan_gradients(name, gen) -> dict:
    """At the train shape, in bfloat16 and float32: the scan under autograd
    (the kernel forward, one launch, none in the backward) gives each input
    the gradient of autograd through the plain version, bit for bit, for the
    same fixed upstream gradient; and the backward's own time per call."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd as SSD
    from repro_torch.kernels import wkv6 as WKV

    mod, plain = (SSD, ref.ssd) if name == "ssd" else (WKV, ref.wkv6)
    shape = TRAIN_SCAN_SHAPES[name]
    out = {"backward_ms": {}}
    for dtn, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        args, _ = _scan_inputs(name, shape, dtype, gen, False)
        leaves = [a.clone().requires_grad_() for a in args]
        n0 = mod.launches
        y = getattr(mod, name)(*leaves)
        go = torch.randn(y.shape, generator=gen, device="cuda").to(y.dtype)
        got = torch.autograd.grad(y, leaves, go)
        launches = mod.launches - n0
        plain_leaves = [a.clone().requires_grad_() for a in args]
        want = torch.autograd.grad(plain(*plain_leaves), plain_leaves, go)
        torch.cuda.synchronize()
        same = [bool(torch.equal(a, b)) and a.dtype == t.dtype for a, b, t in zip(got, want, args)]
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        ok = all(same) and finite and launches == 1 and y.grad_fn is not None
        log(f"  {name} gradient {'x'.join(map(str, shape))} {dtn}: each input's gradient "
            f"bit-equal to autograd through the plain version {same}, finite {finite}, "
            f"{launches} launch (forward only) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}'s gradient under autograd is not the plain "
                                 f"version's: {same}, finite {finite}, launches {launches}")
        out["backward_ms"][dtn] = backward_ms(getattr(mod, name), list(args), {})
        log(f"  {name} backward (plain recompute) {dtn}: "
            f"{fmt(out['backward_ms'][dtn])} ms per call (events)")
    return out


def served_model(arch: str):
    """The model phase 3 serves, drawn from seed 0 on the card at full width,
    its depth cut as SERVE_DEPTH says; with the seconds the draw took."""
    import torch

    from repro_torch.configs.base import cut_depth, get_config
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    cfg = get_config(arch)
    if arch in SERVE_DEPTH:
        cfg = cut_depth(cfg, SERVE_DEPTH[arch])
    t0 = time.perf_counter()
    model = M.init_params(cfg, 0, "cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = M.count_params_analytic(cfg)
    log(f"  {arch}: {cfg.num_layers} layers ({[(s.kind, s.count) for s in M.layer_plan(cfg)]})"
        f", {n} parameters in {cfg.param_dtype} "
        f"({n * L.torch_dtype(cfg.param_dtype).itemsize} bytes), drawn on the host's pool "
        f"and placed on the card in {secs:.1f}s")
    return model, secs


def phase_serve(ckpt_dir: str, arch: str, model) -> dict:
    """The port's serving path at full width, once, with the launch counts of
    every serving kernel set to 0 just before and read just after.  ``model``:
    the parameters to serve (``served_model``), of the config the argv names."""
    import torch

    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.kernels import ssd as SSD
    from repro_torch.kernels import wkv6 as WKV
    from repro_torch.launch import serve

    mods = {"flash": flash_attention, "flash_decode": decode_attention, "ssd": SSD,
            "wkv6": WKV}
    depth = ["--num-layers", str(SERVE_DEPTH[arch])] if arch in SERVE_DEPTH else []
    argv = ["--arch", arch] + SERVE_ARGV + depth + ["--ckpt-dir", ckpt_dir]
    log(f"  python -m repro_torch.launch.serve {' '.join(argv)}")
    args = serve.parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    for m in mods.values():
        m.launches = 0
    rep = serve.run(args, model)
    counts = {name: m.launches for name, m in mods.items()}
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    log(f"  peak device memory {peak / 1e9:.2f} GB")
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
    return {"counts": counts, "peak_bytes": peak, **rep}


MOE_STEPS = ("route", "assign_slots", "dispatch", "expert_ffn", "combine")


@contextlib.contextmanager
def moe_ranges():
    """Each step of ``models/moe.py``'s FFN inside a ``torch.profiler``
    range named ``moe.<step>``, while the context is open; the module's own
    code carries no instrumentation."""
    from torch.profiler import record_function

    from repro_torch.models import moe as MOE

    orig = {name: getattr(MOE, name) for name in MOE_STEPS}

    def ranged(name, fn):
        def call(*a, **kw):
            with record_function(f"moe.{name}"):
                return fn(*a, **kw)
        return call

    for name, fn in orig.items():
        setattr(MOE, name, ranged(name, fn))
    try:
        yield
    finally:
        for name, fn in orig.items():
            setattr(MOE, name, fn)


def _range_device_us(prof) -> dict:
    """Device microseconds under each ``moe.<step>`` range: the kernels its
    operations launched, children included."""
    from torch.autograd import DeviceType

    out: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("moe."):
            out[e.name] = out.get(e.name, 0.0) + e.device_time_total
    return out


def phase_profile(arch: str, model, steps: int = 4) -> dict:
    """Where the device time of the serving path goes, at the main path's
    shapes, over one prefill and over ``steps`` decode steps.  Each window is
    run twice: untraced, for its host-clock wall time, then under
    ``torch.profiler`` for the time of every device kernel.  Device busy
    share = summed kernel time over the untraced wall time; the traced
    window's extra wall time is the profiler's own cost.  ``model``: phase
    3's (``served_model``).  A MoE model's FFN steps are read apart
    (``moe_ranges``)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import synthetic_prompts
    from repro_torch.serve.engine import Engine

    cfg = model.cfg
    prompts = synthetic_prompts(cfg, np.random.default_rng(0), 4, 512, torch.device("cuda"))
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
        with moe_ranges() if cfg.num_experts else contextlib.nullcontext():
            traced_s = timed(name, prof)
        # device rows, less the ranges' own spans (``moe.*``, which would
        # count their kernels twice and the gaps between them)
        rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                and not e.key.startswith("moe.")]
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
        if cfg.num_experts:
            moe_us = _range_device_us(prof)
            shares = {k.removeprefix("moe."): v / 1e6 / busy_s for k, v in moe_us.items()}
            moved = shares.get("dispatch", 0.0) + shares.get("combine", 0.0)
            log(f"    MoE share of the device time: dispatch + combine {100 * moved:.1f}%, "
                f"the experts' products (expert_ffn) {100 * shares.get('expert_ffn', 0):.1f}%"
                "; " + ", ".join(f"{k} {100 * v:.1f}% ({moe_us['moe.' + k] / per / 1e3:.4f} ms)"
                                 for k, v in shares.items()))
            out[name]["moe_share"] = shares
    del eng, model
    torch.cuda.empty_cache()
    out["cfg"] = cfg
    return out


def phase_reference(arch: str, prompt_len: int, max_seq: int, steps: int = 8) -> dict:
    """A reduced model in float32: the card's path against the CPU path.
    Codebook models take (B, S, K) tokens; an image-token model takes image
    embeddings over its first positions in the prefill."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config, reduced
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.models import model as M

    cfg = reduced(get_config(arch))
    rng = np.random.default_rng(0)
    shape = (2, prompt_len, cfg.num_codebooks) if cfg.num_codebooks else (2, prompt_len)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(np.int32)}
    if cfg.num_image_tokens:
        batch["image_embeds"] = rng.standard_normal(
            (2, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    mods = {"flash": flash_attention, "flash_decode": decode_attention}
    out = {}
    for device in ("cpu", "cuda"):
        for m in mods.values():
            m.launches = 0
        lm = M.init_params(cfg, seed=0, device=device)
        logits, cache = M.prefill(lm, cfg, {k: torch.from_numpy(v).to(device)
                                            for k, v in batch.items()}, max_seq)
        toks, all_logits = [], [logits.cpu()]
        nxt = logits.argmax(-1).to(torch.int32)
        for _ in range(steps):
            toks.append(nxt.cpu())
            logits, cache = M.decode_step(lm, cfg, nxt, cache)
            all_logits.append(logits.cpu())
            nxt = logits.argmax(-1).to(torch.int32)
        out[device] = (torch.stack(toks, 1), torch.stack(all_logits, 1))
    counts = {k: m.launches for k, m in mods.items()}
    same = torch.equal(out["cpu"][0], out["cuda"][0])
    err = (out["cpu"][1] - out["cuda"][1]).abs().max().item()
    log(f"  reduced {arch} f32 prompt {prompt_len}, cuda vs cpu: tokens equal={same} "
        f"max logit err {err:.3g}; launches on the card {counts}")
    if not same or err > 1e-3 or not math.isfinite(err):
        raise AssertionError("the card's path disagrees with the CPU path")
    return {"tokens_equal": same, "max_logit_err": err, "counts": counts}


# phase 4's train step: each gradient within 10x the float32 tolerance of the
# model's kernels (SCAN_TOL: SSD 5e-5, WKV6 1e-4; attention TOL 2e-5) of the
# leaf's largest |gradient| on the CPU, the loss (and its aux and MTP terms)
# within the tolerance itself of |loss|.  The factor covers the products'
# other summation order on the card: the reduced models' float32 gradients
# are ill conditioned enough that two float32 evaluations on the CPU differ
# by up to 2.6e-4 of a leaf's largest |gradient| (rwkv6;
# tests/test_torch_ssm_train.py), against 1e-3 here.
TRAIN_GRAD_FACTOR = 10
# looser, of the leaf's largest |gradient|: reduced deepseek-v3's float32
# gradients stand up to 1.53e-4 from a float64 evaluation on the CPU at
# phase 4's inputs (embed/table).  The card and the CPU each err from the
# exact gradient by about that much, so they may differ by twice it,
# 3.06e-4, above the attention models' 2e-4: held to 4e-4 (the card read
# 2.16e-4).  Every limit here is at least twice the CPU's float32 error
# from float64 (tests/test_torch_mla_train.py::
# test_phase4_gradient_limit_covers_float32_error)
TRAIN_GRAD_TOL = {"deepseek-v3-671b": 4e-4}


def train_tols(arch: str, cfg) -> tuple[float, float]:
    """Phase 4's train-step limits for ``arch``: (of |loss|, of a leaf's
    largest |gradient|)."""
    tol = (SCAN_TOL["ssd"]["float32"] if cfg.mixer == "mamba2" else
           SCAN_TOL["wkv6"]["float32"] if cfg.mixer == "rwkv6" else TOL["float32"])
    return tol, TRAIN_GRAD_TOL.get(arch, TRAIN_GRAD_FACTOR * tol)


def reduced_train_inputs(arch: str, seq: int = 70):
    """Phase 4's train inputs on the CPU: (reduced config, float32 params
    drawn from seed 0, a B2 batch drawn by numpy from seed 0)."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    cfg = reduced(get_config(arch))
    params = L.materialize(M.param_specs(cfg), 0, torch.float32, "cpu")
    rng = np.random.default_rng(0)
    shape = (2, seq, cfg.num_codebooks) if cfg.num_codebooks else (2, seq)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, shape).astype(np.int32))}
    if cfg.num_image_tokens:
        batch["image_embeds"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.num_image_tokens, cfg.d_model)).astype(np.float32))
    return cfg, params, batch


def phase_reference_train(arch: str, seq: int = 70) -> dict:
    """One train step (loss, its aux and MTP terms, every gradient) of a
    reduced model in float32: the card's path (the kernels forward under
    autograd, the plain versions' gradients) against the CPU path (the
    plain versions).  Codebook models take (B, S, K) tokens, an image-token
    model its image embeddings; MoE layers route with one group, as the
    train step does."""
    import torch

    from repro_torch.kernels import flash_attention
    from repro_torch.kernels import ssd as SSD
    from repro_torch.kernels import wkv6 as WKV
    from repro_torch.models import model as M
    from repro_torch.train import step as TS
    from repro_torch.utils.tree import flatten_with_names, tree_map

    cfg, params, batch = reduced_train_inputs(arch, seq)
    mods = {"flash": flash_attention, "ssd": SSD, "wkv6": WKV}
    out = []
    for dev in ("cpu", "cuda"):
        for m in mods.values():
            m.launches = 0
        loss, mets, grads = TS.loss_and_grads(tree_map(lambda t: t.to(dev), params), cfg,
                                              {k: v.to(dev) for k, v in batch.items()})
        counts = {k: m.launches for k, m in mods.items()}
        out.append((float(loss), {k: float(v) for k, v in mets.items()},
                    {n: g.cpu() for n, g in flatten_with_names(grads)}, counts))
    (l_cpu, m_cpu, g_cpu, _), (l_gpu, m_gpu, g_gpu, counts) = out
    tol, grad_tol = train_tols(arch, cfg)
    rel = {n: (g_gpu[n] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
           for n, g in g_cpu.items() if g.numel()}
    worst = max(rel, key=rel.get)
    finite = all(bool(torch.isfinite(g).all()) for g in g_gpu.values())
    terms = {k: (m_gpu[k], m_cpu[k]) for k in ("aux", "mtp_ce") if k in m_cpu}
    # a forward launches flash once an attention layer (zamba2: once a
    # shared-attention group; the MTP block once more), a scan once a layer
    plan = M.layer_plan(cfg)
    if cfg.mixer == "mamba2":
        want = {"flash": plan[0].count, "ssd": cfg.num_layers, "wkv6": 0}
    elif cfg.mixer == "rwkv6":
        want = {"flash": 0, "ssd": 0, "wkv6": cfg.num_layers}
    else:
        want = {"flash": cfg.num_layers + (1 if cfg.mtp_depth and not cfg.num_codebooks
                                           else 0), "ssd": 0, "wkv6": 0}
    log(f"  reduced {arch} f32 train step B2 S{seq}, cuda vs cpu: loss {l_gpu!r} / {l_cpu!r} "
        f"(err {abs(l_gpu - l_cpu):.3g}, tol {tol} |loss|)"
        + "".join(f"; {k} {a!r} / {b!r}" for k, (a, b) in terms.items())
        + f"; gradients of {len(rel)} leaves, worst {rel[worst]:.3g} of the leaf's max |cpu| "
        f"at {worst} (tol {grad_tol:g}); finite {finite}; launches {counts} "
        f"(expected {want})")
    if (abs(l_gpu - l_cpu) > tol * abs(l_cpu) or rel[worst] > grad_tol
            or not finite or any(abs(a - b) > tol * abs(l_cpu) for a, b in terms.values())):
        raise AssertionError("the card's train step disagrees with the CPU's")
    if counts != want:
        raise AssertionError(f"train step launches {counts} != {want}")
    return {"loss_err": abs(l_gpu - l_cpu), "grad_rel_err": rel[worst], "counts": counts,
            "terms": terms}


def _work_dir() -> Path:
    """A scratch directory for the checkpoints of phases 6-10, on whichever
    of the temporary directory and the repository's ``build/`` has more free
    space; fails clearly below TRAIN_DISK_BYTES."""
    bases = [Path(tempfile.gettempdir()), ROOT / "build"]
    for b in bases:
        b.mkdir(parents=True, exist_ok=True)
    free = {b: shutil.disk_usage(b).free for b in bases}
    base = max(free, key=free.get)
    log("  free disk: " + ", ".join(f"{b} {f / 1e9:.1f} GB" for b, f in free.items()))
    if free[base] < TRAIN_DISK_BYTES:
        raise RuntimeError(f"the train phases write ~36 GB of checkpoints, up to ~8 GB at a "
                           f"time; the most free "
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
    """The full-width train state (STATE_LAYERS layers) on the card after one
    step: fingerprinted whole (kernel against the plain version and the
    host), one profiled step, and saved twice with device fingerprints and
    once on the host path."""
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
    from repro_torch.kernels import costs, ops, ref
    from repro_torch.optim import adamw
    from repro_torch.train import step as TS
    from repro_torch.utils.tree import flatten_with_names

    cfg = get_config("qwen2-0.5b").replace(num_layers=STATE_LAYERS)
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
    tree_bound, _ = bound(costs.chunk_fingerprints(nbytes // 4, cw), "uint32")
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
    return {"step_ms": wall_s * 1e3, "device_ms": busy_s * 1e3, "cfg": cfg,
            "busy_share": busy_s / wall_s, "tree_ms": tree,
            "tree_bound_ms": tree_bound, "saves": saves}


def _child_env() -> dict:
    """The environment of a child process: this one's, with the port's
    sources first on the path and unbuffered output."""
    return {**os.environ, "PYTHONUNBUFFERED": "1", "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src")] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH")
                               else []))}


def _tail(out) -> str:
    if isinstance(out, bytes):
        out = out.decode(errors="replace")
    return (out or "")[-3000:]


def train_cmd(arch: str, ckpt_dir: Path, metrics: Path, extra: list) -> list:
    """The C/R loop's command: ``launch.train.main`` at TRAIN_LAYERS[arch]
    layers, in a child process of this script."""
    return [sys.executable, str(ROOT / "chip_smoke.py"), "--train-child", arch,
            str(TRAIN_LAYERS[arch]), *TRAIN_ARGV, "--ckpt-dir", str(ckpt_dir),
            "--metrics-out", str(metrics), *extra]


def train_child(argv: list) -> int:
    """``chip_smoke.py --train-child ARCH LAYERS ARGS``: ``python -m
    repro_torch.launch.train --arch ARCH ARGS`` with the config's depth cut
    to LAYERS (``get_config`` reads the module's ``CONFIG``)."""
    import dataclasses
    import importlib

    from repro_torch.configs import base
    from repro_torch.launch import train

    arch, layers = argv[0], int(argv[1])
    mod = importlib.import_module(f"repro_torch.configs.{base._MODULES[arch]}")
    mod.CONFIG = dataclasses.replace(mod.CONFIG, num_layers=layers)
    return train.main(["--arch", arch, *argv[2:]])


def _rank_env() -> dict:
    """The launcher's variables of a job of one rank on this card (a free
    port of its own): the trainer joins an NCCL group of one."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(port)}


def _train_run(work: Path, arch: str, tag: str, ckpt: str, extra: list,
               ranks: bool = False) -> tuple[int, dict]:
    out = work / f"{tag}.json"
    cmd = train_cmd(arch, work / ckpt, out, extra)
    launched = time.time()
    t0 = time.perf_counter()
    try:
        r = subprocess.run(cmd, env={**_child_env(), **(_rank_env() if ranks else {})},
                           capture_output=True, text=True, timeout=TRAIN_RUN_DEADLINE_S)
    except subprocess.TimeoutExpired as e:
        raise AssertionError(f"train run {tag} ({arch}) passed its deadline of "
                             f"{TRAIN_RUN_DEADLINE_S}s and was killed; its output ended:\n"
                             f"{_tail(e.stdout)}\n{_tail(e.stderr)}") from None
    wall = time.perf_counter() - t0
    ended = time.time()
    if not out.exists():
        raise AssertionError(f"train run {tag} wrote no metrics (exit {r.returncode}):\n"
                             f"{_tail(r.stdout)}\n{_tail(r.stderr)}")
    m = json.loads(out.read_text())
    steps = m["steps"]
    log(f"  run {tag}: exit {r.returncode} in {wall:.1f}s, steps "
        f"{[s['step'] for s in steps]}, start {m['start_step']}, restore_s "
        f"{m['restore_s'] if m['restore_s'] is None else round(m['restore_s'], 3)}, "
        f"launches {m['launches']}, ranks {m['ranks']}"
        + (f", group started in {m['ranks_start_s']:.3f}s" if m.get("ranks_start_s") else ""))
    log("    step ms " + " ".join(f"{s['ms']:.1f}" for s in steps)
        + "  losses " + " ".join(repr(s["loss"]) for s in steps))
    log(f"    wall: {steps[0]['t'] - steps[0]['ms'] / 1e3 - launched:.1f}s to the first step, "
        f"{steps[-1]['t'] - steps[0]['t'] + steps[0]['ms'] / 1e3:.1f}s of steps, "
        f"{ended - steps[-1]['t']:.1f}s after the last (its save, the exit)")
    for sv in m["saves"]:
        log(f"    save at step {sv['step']}: stall_s {sv.get('stall_s', 0):.3f} fp_device_s "
            f"{sv.get('fp_device_s', 0):.4f} d2h_bytes {sv.get('d2h_bytes')} d2h_s "
            f"{sv.get('d2h_s', 0):.3f} hash_s {sv.get('hash_s', 0):.3f} write_s "
            f"{sv.get('write_s', 0):.3f} chunks {sv.get('chunks_total')} clean "
            f"{sv.get('chunks_clean_device')} bytes_written {sv.get('bytes_written')}")
    return r.returncode, m


def _final_hashes(ckpt_dir: Path) -> dict:
    from repro_torch.checkpoint.manager import CheckpointManager, CheckpointPolicy
    from repro_torch.checkpoint.store import TieredStore

    mgr = CheckpointManager(TieredStore(ckpt_dir), CheckpointPolicy(delta=True))
    man = mgr.read_manifest(TRAIN_STEPS - 1)
    mgr.close()
    return {e["path"]: [c["hash"] for c in e["chunks"]] for e in man["leaves"]}


def fp_launches_for(arch: str, layers: int) -> tuple[int, int]:
    """(fingerprint launches of one device-fp save, state bytes) of the train
    state of ``arch`` cut to ``layers``, from its shapes (meta tensors)."""
    import dataclasses

    from repro_torch.checkpoint import serialization as SER
    from repro_torch.configs.base import get_config
    from repro_torch.optim import adamw
    from repro_torch.train import step as TS
    from repro_torch.utils.tree import flatten_with_names

    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    named = flatten_with_names(TS.abstract_train_state(cfg, adamw.OptConfig()))
    nbytes = sum(x.numel() * x.element_size() for _, x in named)
    return fp_launches_per_save(named, SER.DELTA_CHUNK_BYTES), nbytes


def _train_launches(m: dict, per_step: dict, fp_per_save: int) -> dict:
    """What a train run's launch counts must be: ``per_step`` a step (one
    forward; the backwards launch no kernel), the fingerprint kernel's per
    device-fp save."""
    n = len(m["steps"])
    return {"flash": per_step.get("flash", 0) * n, "ssd": per_step.get("ssd", 0) * n,
            "wkv6": per_step.get("wkv6", 0) * n,
            "chunk_fingerprints": fp_per_save * len(m["saves"])}


def saved_bytes(*runs) -> int:
    return sum(sv.get("bytes_written") or 0 for m in runs for sv in m["saves"])


def phase_train(work: Path, arch: str, ranks: bool = False) -> dict:
    """The paper's C/R loop at full width and TRAIN_LAYERS[arch] layers, as a
    user runs it: A uninterrupted; B with a walltime its margin exceeds, so it
    checkpoints after its first step and exits 85; C requeued on B's
    directory, restoring and finishing.  With ``ranks``, B and C run as a job
    of one rank (the launcher's variables): an NCCL group of one is up, and
    every step boundary's agreement all-reduce runs on it; A has no group."""
    fp_per_save, nbytes = fp_launches_for(arch, TRAIN_LAYERS[arch])
    log(f"  {arch} at {TRAIN_LAYERS[arch]} layers: a {nbytes} byte state "
        f"({nbytes / 1e9:.2f} GB), {fp_per_save} fingerprint launches per save")
    rc_a, a = _train_run(work, arch, "A", "a", [])
    hashes_a = _final_hashes(work / "a")
    shutil.rmtree(work / "a")
    rc_b, b = _train_run(work, arch, "B", "b", ["--walltime", "0.5", "--margin", "100"], ranks)
    rc_c, c = _train_run(work, arch, "C", "b", [], ranks)
    if (rc_a, rc_b, rc_c) != (0, 85, 0):
        raise AssertionError(f"exit codes A/B/C {(rc_a, rc_b, rc_c)}, expected (0, 85, 0)")
    want = {"world": 1, "backend": "nccl" if ranks else None}
    if a["ranks"] != {"world": 1, "backend": None} or b["ranks"] != want or c["ranks"] != want:
        raise AssertionError(f"ranks A {a['ranks']} B {b['ranks']} C {c['ranks']}: expected A "
                             f"without a group, B and C {want}")
    if [s["step"] for s in b["steps"]] != [0] or c["start_step"] != 1:
        raise AssertionError("B must stop after step 0 and C resume at step 1")
    loss_a, loss_c = a["steps"][-1]["loss"], c["steps"][-1]["loss"]
    same_losses = [s["loss"] for s in a["steps"]] == [s["loss"] for s in b["steps"] + c["steps"]]
    same_hashes = hashes_a == _final_hashes(work / "b")
    log(f"  final loss A {loss_a!r} C {loss_c!r}: {'EQUAL' if loss_a == loss_c else 'DIFFER'};"
        f" every step's loss equal {same_losses}; final chunk hashes identical {same_hashes}")
    if loss_a != loss_c or not same_losses or not same_hashes:
        raise AssertionError("the requeued run did not finish bit-identical to run A")
    if not all(math.isfinite(s["loss"]) for s in a["steps"]):
        raise AssertionError(f"non-finite losses: {[s['loss'] for s in a['steps']]}")
    counts = {}
    for tag, m in (("A", a), ("B", b), ("C", c)):
        want = _train_launches(m, STEP_LAUNCHES[arch], fp_per_save)
        if m["launches"] != want:
            raise AssertionError(f"run {tag}: launches {m['launches']}, expected {want}")
        for k, n in m["launches"].items():
            counts[k] = counts.get(k, 0) + n
    log(f"  launches over A+B+C {counts} ({STEP_LAUNCHES[arch]} per step, "
        f"chunk_fingerprints {fp_per_save} per device-fp save)")
    shutil.rmtree(work / "b")
    return {"counts": counts, "A": a, "B": b, "C": c, "hashes_a": hashes_a,
            "fp_per_save": fp_per_save, "saved_bytes": saved_bytes(a, b, c)}


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
        parts = [pub.save(1, trees[1])]
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
        parts.append(pub.save(2, trees[2]))
        save2_s = time.perf_counter() - t0
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", *FLEET_ARGV, "--follow",
               "--batches", str(FLEET_BATCHES), "--ckpt-dir", str(weights),
               "--local-root", str(root / "r0"), "--replica", "r0"]
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, env=_child_env(), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        late = threading.Event()

        def kill_late():
            late.set()
            proc.kill()

        watchdog = threading.Timer(FOLLOW_DEADLINE_S, kill_late)
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
        if late.is_set():
            raise AssertionError(f"the follower subprocess passed its deadline of "
                                 f"{FOLLOW_DEADLINE_S}s and was killed; its output ended:\n"
                                 + "\n".join(lines[-40:]))
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
            "saved_bytes": sum(pt["delta"].get("bytes_written") or 0 for pt in parts),
            "subprocess_restore": restored, "restore_s": restore_s, "fetch_s": rec["fetch_s"]}


def phase_sched(work: Path, train_rep: dict) -> dict:
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
    arch = "qwen2-0.5b"
    cmd = train_cmd(arch, ckpt, metrics, ["--ckpt-promote", "eager"])
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
    try:
        sim.run(timeout_s=SCHED_DEADLINE_S)
    except TimeoutError:
        tail = out.read_text()[-3000:] if out.exists() else "(no output)"
        raise AssertionError(f"the SlurmSim job passed its deadline of {SCHED_DEADLINE_S}s "
                             f"and was killed; its output ended:\n{tail}") from None
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
        if m["launches"] != _train_launches(m, STEP_LAUNCHES[arch], train_rep["fp_per_save"]):
            raise AssertionError(f"attempt {k}: launches {m['launches']}")
        for name, n in m["launches"].items():
            counts[name] = counts.get(name, 0) + n
    log(f"  launches over both attempts {counts}")
    promoted = sum(f.stat().st_size for f in (sim.workdir / "nodes").rglob("*")
                   if f.is_file())
    shutil.rmtree(ckpt, ignore_errors=True)
    shutil.rmtree(sim.workdir, ignore_errors=True)
    return {"counts": counts, "walls": walls, "restore_s": attempts[1]["restore_s"],
            "saved_bytes": saved_bytes(*attempts.values()), "promoted_bytes": promoted}


def _recompute_marked(ref, names: list, cycles: int = 100):
    """``ref.recompute_grads`` (every kernel wrapper's backward) between two
    marker kernels, recording each call's plain version in ``names``: in a
    trace of one stream, the kernels between a pair of markers are that
    backward's."""
    import torch

    plain_grads = ref.recompute_grads

    def marked(plain, *args, **kw):
        names.append(plain.__name__)
        torch.cuda._sleep(cycles)
        try:
            return plain_grads(plain, *args, **kw)
        finally:
            torch.cuda._sleep(cycles)

    return marked


def _read_marked_trace(events, names: list):
    """(device us of the traced step, {plain version: device us of its
    recomputes}) from its CUDA events sorted by start, whose recomputes are
    bracketed by marker kernels (``_recompute_marked``); None where the
    trace cannot be whole: a marker missing, or two recomputes of one plain
    version (the same operations) showing different kernel counts."""
    if sum(1 for e in events if MARKER in e.name) != 2 * len(names):
        return None
    busy_us, recompute_us, kernels = 0.0, {}, {}
    pairs, inside, n = iter(names), None, 0
    for e in events:
        if MARKER in e.name:
            if inside is not None:
                kernels.setdefault(inside, set()).add(n)
            inside, n = (next(pairs), 0) if inside is None else (None, 0)
            continue
        busy_us += e.time_range.elapsed_us()
        if inside is not None:
            n += 1
            recompute_us[inside] = recompute_us.get(inside, 0.0) + e.time_range.elapsed_us()
    if any(len(c) != 1 for c in kernels.values()):
        return None
    return busy_us, recompute_us


def phase_train_full(arch: str, cfg=None, key=None, params=None) -> dict:
    """Full width, in this process, through ``train/step.py`` as the CLI
    calls it: two AdamW steps at B8 S128, then one traced by
    ``torch.profiler`` (a trace that dropped events is taken again with the
    next step, at most twice); no checkpoint.  ``cfg``: the config if not
    ``arch``'s own at full depth; ``key``: its entry of STEP_LAUNCHES;
    ``params``: parameters on the card already drawn for it from seed 0 (the
    values ``init_train_state`` draws), trained in place, else drawn here.
    Device time = the summed
    durations of the traced step's device events; busy share = that over the
    untraced step's wall time; the backwards' share = the device time
    between the marker kernels that bracket each plain recompute
    (``_recompute_marked``) during the traced step.  A MoE model's forward
    FFN steps are read apart (``moe_ranges``: CPU ranges, so the trace then
    records CPU activity too; the backward runs outside them)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import flash_attention, ref
    from repro_torch.kernels import ssd as SSD
    from repro_torch.kernels import wkv6 as WKV
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import step as TS
    from repro_torch.utils.tree import flatten_with_names

    cfg = cfg or get_config(arch)
    key = key or f"full {arch}"
    oc = adamw.OptConfig(warmup_steps=10, decay_steps=TRAIN_STEPS)
    t0 = time.perf_counter()
    if params is None:
        state = TS.init_train_state(cfg, oc, 0, "cuda")
    else:
        state = {"params": params, "opt": adamw.init_opt_state(params, oc),
                 "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    named = flatten_with_names(state)
    nbytes = sum(x.numel() * x.element_size() for _, x in named)
    nparams = sum(x.numel() for n, x in named if n.startswith("params/"))
    pipe = SyntheticTokens(cfg, 8, 128)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in pipe.batch_at(i).items()}
               for i in range(5)]
    step = TS.make_train_step(cfg, oc)
    mods = {"flash": flash_attention, "ssd": SSD, "wkv6": WKV}
    for m in mods.values():
        m.launches = 0
    torch.cuda.reset_peak_memory_stats()
    metrics = []
    state, m = step(state, batches[0])                  # warm
    metrics.append(m)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, batches[1])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    metrics.append(m)
    plain_grads = ref.recompute_grads
    moe = bool(cfg.num_experts)
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if moe else [])
    for attempt in range(3):
        names: list = []
        ref.recompute_grads = _recompute_marked(ref, names)
        try:
            t0 = time.perf_counter()
            with profile(activities=acts) as prof, \
                    (moe_ranges() if moe else contextlib.nullcontext()):
                warm = torch.zeros(1, device="cuda")
                for _ in range(3):          # the profiler can miss a window's first launches
                    warm.add_(1)
                torch.cuda.synchronize()
                state, m = step(state, batches[2 + attempt])
                torch.cuda.synchronize()
            traced_s = time.perf_counter() - t0
        finally:
            ref.recompute_grads = plain_grads
        metrics.append(m)
        t0 = time.perf_counter()
        # the MoE ranges also show on the device's timeline, spanning their
        # kernels and the gaps between them: left out, as phase 5 leaves them
        events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                         and not e.name.startswith("moe.")),
                        key=lambda e: e.time_range.start)
        trace = _read_marked_trace(events, names)
        parse_s = time.perf_counter() - t0
        if trace is not None:
            break
        log(f"    (traced step {attempt + 1}: {len(events)} device events, the recomputes' "
            "kernel counts differ or markers are missing: events were dropped; taken again)")
    counts = {k: mod.launches for k, mod in mods.items()}
    busy_us, recompute_us = trace if trace is not None else (float("nan"), {})
    moe_us = _range_device_us(prof) if moe and trace is not None else {}
    peak = torch.cuda.max_memory_allocated()
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    terms = {k: [float(m[k]) for m in metrics] for k in ("aux", "mtp_ce") if k in metrics[0]}
    per_step = STEP_LAUNCHES[key]
    want = {k: per_step.get(k, 0) * len(metrics) for k in mods}
    busy = busy_us / 1e6 / wall_s
    shares = {k: v / busy_us for k, v in recompute_us.items()}
    moe_shares = {k.removeprefix("moe."): v / busy_us for k, v in moe_us.items()}
    calls = {k: names.count(k) for k in sorted(set(names))}
    plan = [(sg.kind, sg.count) for sg in M.layer_plan(cfg)]
    log(f"  {key}: {plan}, {nparams} parameters in {cfg.param_dtype}; state {nbytes} bytes "
        f"({nbytes / 1e9:.2f} GB), {'drawn' if params is None else 'reused'} + placed in "
        f"{init_s:.1f}s; losses {losses}; grad norms {gnorms}"
        + "".join(f"; {k} {v}" for k, v in terms.items())
        + f"; launches {counts} (expected {want})")
    log(f"  step B8 S128: wall {wall_s * 1e3:.1f} ms untraced ({traced_s * 1e3:.1f} traced, "
        f"{parse_s:.1f}s to read the trace), device {busy_us / 1e3:.1f} ms = "
        f"{100 * busy:.1f}% busy; the plain recomputes (the backwards of the kernels, "
        f"calls {calls}): " + ", ".join(f"{k} {v / 1e3:.1f} ms ({100 * shares[k]:.1f}%)"
                                         for k, v in recompute_us.items())
        + f" of the device time; peak device memory {peak / 1e9:.2f} GB")
    by_name: dict = {}
    for e in events:
        if MARKER not in e.name:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"    {100 * us / busy_us:5.1f}%  {us / 1e3:8.3f} ms  {name[:90]}")
    if moe_shares:
        log("  the forward's MoE steps, share of the traced step's device time: "
            + ", ".join(f"{k} {100 * v:.1f}% ({moe_us['moe.' + k] / 1e3:.2f} ms)"
                        for k, v in moe_shares.items())
            + f"; all five {100 * sum(moe_shares.values()):.1f}%")
    if trace is None:
        log("  device time not measured: the profiler dropped events in three traced steps")
    if not all(math.isfinite(x) for x in losses + gnorms + sum(terms.values(), [])):
        raise AssertionError(f"{key}: non-finite loss, term or gradient norm: {losses}, "
                             f"{gnorms}, {terms}")
    if counts != want:
        raise AssertionError(f"{key}: launches {counts} != {want}")
    del state, step, prof, events, named, batches
    torch.cuda.empty_cache()
    return {"counts": counts, "losses": losses, "grad_norms": gnorms, "terms": terms,
            "step_ms": wall_s * 1e3, "device_ms": busy_us / 1e3, "busy_share": busy,
            "recompute_ms": {k: v / 1e3 for k, v in recompute_us.items()},
            "recompute_share": shares, "moe_share": moe_shares, "peak_bytes": peak,
            "state_bytes": nbytes, "init_s": init_s, "cfg": cfg}


def phase_cr_in_process(work: Path, arch: str, layers: int) -> dict:
    """The reference's C/R cycle (tests/test_cr_all_archs.py) on the card, in
    this process: ``arch`` at full width and ``layers`` layers takes one
    step, is saved with device fingerprints (``--ckpt-delta
    --ckpt-device-fp``) and committed, restored through a fresh manager
    into ``abstract_train_state`` and placed on the card; the next batch on
    the continuing and on the restored state must give the same loss and
    the same bits in every leaf.  Deterministic algorithms on, as the CLI
    runs."""
    import torch

    from repro_torch.checkpoint import serialization as SER
    from repro_torch.checkpoint.manager import CheckpointManager, CheckpointPolicy
    from repro_torch.checkpoint.store import TieredStore
    from repro_torch.configs.base import get_config
    from repro_torch.core.virtualization import place_tree
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import checksum as CK
    from repro_torch.kernels import flash_attention
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import _deterministic
    from repro_torch.optim import adamw
    from repro_torch.parallel.mesh_rules import Rules
    from repro_torch.train import step as TS
    from repro_torch.utils.tree import flatten_with_names

    cfg = get_config(arch).replace(num_layers=layers)
    oc = adamw.OptConfig(warmup_steps=10, decay_steps=TRAIN_STEPS)
    pipe = SyntheticTokens(cfg, 8, 128)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in pipe.batch_at(i).items()}
               for i in range(2)]
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    _deterministic(True)
    flash_attention.launches = 0
    fp0 = CK.fingerprint_launches
    try:
        t0 = time.perf_counter()
        state = TS.init_train_state(cfg, oc, 0, "cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        step = TS.make_train_step(cfg, oc)
        state, m0 = step(state, batches[0])
        named = flatten_with_names(state)
        nbytes = sum(x.numel() * x.element_size() for _, x in named)
        want_fp = fp_launches_per_save(named, SER.DELTA_CHUNK_BYTES)
        store = TieredStore(work / "cr11")
        mgr = CheckpointManager(store, CheckpointPolicy(delta=True, device_fp=True))
        t0 = time.perf_counter()
        part = mgr.save(1, state)
        mgr.commit(1)
        save_s = time.perf_counter() - t0
        mgr.close()
        fp_launches = CK.fingerprint_launches - fp0
        t0 = time.perf_counter()
        fresh = CheckpointManager(TieredStore(work / "cr11"), CheckpointPolicy(delta=True))
        host, _ = fresh.restore(TS.abstract_train_state(cfg, oc))
        fresh.close()
        restored = place_tree(host, TS.state_logical_axes(cfg), Rules(make_host_mesh("cuda")),
                              "cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        del host
        state, m_cont = step(state, batches[1])
        restored, m_rest = step(restored, batches[1])
        torch.cuda.synchronize()
        same_loss = float(m_cont["loss"]) == float(m_rest["loss"])
        a, b = dict(flatten_with_names(state)), dict(flatten_with_names(restored))
        differ = [n for n in a if not torch.equal(a[n], b[n])]
    finally:
        _deterministic(was)
    d = part["delta"]
    flash = flash_attention.launches
    want_flash = STEP_LAUNCHES[f"{arch} C/R cut"]["flash"] * 3
    log(f"  {arch} at {layers} of {get_config(arch).num_layers} layers: a {nbytes} byte "
        f"state ({nbytes / 1e9:.2f} GB), "
        f"drawn in {init_s:.1f}s; step 0 loss {float(m0['loss'])!r}")
    log(f"  save + commit {save_s:.3f}s: stall_s {d.get('stall_s', 0):.3f} fp_device_s "
        f"{d.get('fp_device_s', 0):.4f} d2h_bytes {d.get('d2h_bytes')} hash_s "
        f"{d.get('hash_s', 0):.3f} write_s {d.get('write_s', 0):.3f} chunks "
        f"{d.get('chunks_total')} bytes_written {d.get('bytes_written')}; chunk_fingerprints "
        f"launches {fp_launches} (expected {want_fp})")
    log(f"  restore through a fresh manager + placement {restore_s:.3f}s; the next step's "
        f"loss continuing {float(m_cont['loss'])!r} restored {float(m_rest['loss'])!r}: "
        f"{'EQUAL' if same_loss else 'DIFFER'}; leaves differing {len(differ)} of {len(a)}"
        f"; flash launches {flash} (expected {want_flash})")
    shutil.rmtree(work / "cr11", ignore_errors=True)
    if not same_loss or differ:
        raise AssertionError(f"the restored step is not the continuing one: {differ[:5]}")
    if fp_launches != want_fp or flash != want_flash:
        raise AssertionError(f"launches: chunk_fingerprints {fp_launches} (want {want_fp}), "
                             f"flash {flash} (want {want_flash})")
    if not math.isfinite(float(m_cont["loss"])):
        raise AssertionError("non-finite loss")
    del state, restored, step, a, b, named, batches
    torch.cuda.empty_cache()
    return {"counts": {"flash": flash, "chunk_fingerprints": fp_launches},
            "fp_per_save": want_fp, "stall_s": d.get("stall_s"), "save_s": save_s,
            "restore_s": restore_s, "state_bytes": nbytes,
            "saved_bytes": d.get("bytes_written") or 0}


# ----------------------------------------------------------------------------------
# phase 12: parallelism (the mesh rules, the ring, the elastic MxN restore)
# ----------------------------------------------------------------------------------


def _elastic_setup():
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.optim import adamw

    return reduced(get_config(ELASTIC_ARCH)), adamw.OptConfig(**ELASTIC_OPT)


def _chunk_hashes(root: Path, step: int) -> dict:
    from repro_torch.checkpoint.manager import CheckpointManager, CheckpointPolicy
    from repro_torch.checkpoint.store import TieredStore

    mgr = CheckpointManager(TieredStore(root), CheckpointPolicy(delta=True))
    man = mgr.read_manifest(step)
    mgr.close()
    return {e["path"]: [c["hash"] for c in e["chunks"]] for e in man["leaves"]}


def _elastic_restore(root: Path, rules, device: str):
    """The saved state of the elastic scenario, laid out for ``rules``' mesh."""
    from repro_torch.checkpoint.manager import CheckpointManager, CheckpointPolicy
    from repro_torch.checkpoint.store import TieredStore
    from repro_torch.core.virtualization import place_tree
    from repro_torch.train import step as TS

    cfg, oc = _elastic_setup()
    mgr = CheckpointManager(TieredStore(root), CheckpointPolicy(delta=True))
    host, _ = mgr.restore(TS.abstract_train_state(cfg, oc), promote=False)
    mgr.close()
    return place_tree(host, TS.state_logical_axes(cfg), rules, device)


def _elastic_save(root: Path, state, rank: int) -> None:
    """Gathers ``state`` (every rank) and saves it as step 2 (rank 0)."""
    from repro_torch.checkpoint.manager import CheckpointManager, CheckpointPolicy
    from repro_torch.checkpoint.store import TieredStore
    from repro_torch.core.virtualization import fetch_tree

    host = fetch_tree(state)
    if rank == 0:
        mgr = CheckpointManager(TieredStore(root), CheckpointPolicy(delta=True))
        mgr.save(2, host)
        mgr.commit(2)
        mgr.close()


def _serve_tp_setup(arch: str, device: str):
    """Phase 12(d)'s reduced model (parameters drawn on the CPU from seed 0,
    alike on the ranks and the card) and its prompts."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models import model as M
    from repro_torch.utils.tree import tree_map

    cfg = reduced(get_config(arch))
    tree = tree_map(lambda t: t.numpy(), M.params_tree(M.init_params(cfg, 0, "cpu")))
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size, (SERVE_TP["batch"], SERVE_TP["prompt"]))
    return (cfg, M.params_from_numpy(cfg, tree, device),
            {"tokens": torch.from_numpy(tokens.astype(np.int32)).to(device)})


def _serve_tp_ranks(work: Path, rank: int) -> dict:
    """Phase 12(d) on the two ranks, each arch at its mesh of
    ``SERVE_TP_ARCHS``: it serves on blocks, snapshots at ``snap_at`` (rank
    0 saves the whole snapshot) and goes on; the cache blocks' shapes, the
    tokens after the snapshot, each rank's products on a "model" block and
    all-to-alls."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import ep, tp
    from repro_torch.parallel.mesh_rules import Rules
    from repro_torch.serve.engine import Engine
    from repro_torch.utils.tree import flatten_with_names, tree_map

    out = {}
    for arch, shape in SERVE_TP_ARCHS.items():
        rules = Rules(make_mesh(shape))
        cfg, model, prompts = _serve_tp_setup(arch, "cpu")
        eng = Engine(cfg, model, batch=SERVE_TP["batch"], max_seq=SERVE_TP["max_seq"],
                     rules=rules)
        tp.COUNTS["block_products"] = ep.COUNTS["all_to_all"] = 0
        eng.prefill(prompts)
        eng.generate(SERVE_TP["snap_at"])
        # a leaf no rank splits (zamba2's conv windows, rwkv6's token-shift
        # rows at (1, 2)) is the live cache itself, which decoding goes on
        # writing: copied before the engine goes on
        snap = tree_map(torch.clone, eng.snapshot())
        tokens = eng.generate(SERVE_TP["after"])
        counts = [None] * dist.get_world_size()
        dist.all_gather_object(counts, [tp.COUNTS["block_products"], ep.COUNTS["all_to_all"]])
        logits = eng.whole_rows(eng.last_logits)        # a collective at (2, 1)
        if rank == 0:
            torch.save({**snap, "logits": logits}, work / f"serve-{arch}.pt")
        out[arch] = {"mesh": list(shape), "tokens": tokens.tolist(), "blocks": sorted(eng.blocks),
                     "shapes": {n: list(x.shape) for n, x in flatten_with_names(eng.cache)
                                if n in eng.blocks},
                     "block_products": [c[0] for c in counts],
                     "all_to_all": [c[1] for c in counts]}
    return out


def gloo_child(argv: list) -> int:
    """``chip_smoke.py --gloo-child RANK WORLD STORE WORK``: one CPU rank of
    phase 12(c)-(d), joined to the other over gloo (a ``FileStore``): three
    steps of the elastic scenario from seed 3 at mesh (2, 1) and a save;
    then, in each of the meshes (2, 1) and (1, 2) over the same two ranks, a
    restore of that save and step 4; then 12(d)'s serving.  Rank
    0 prints the losses and the served tokens as JSON."""
    import datetime

    import torch
    import torch.distributed as dist

    rank, world, store, work = int(argv[0]), int(argv[1]), argv[2], Path(argv[3])
    torch.set_num_threads(2)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        from repro_torch.core.virtualization import fetch_tree, place_tree
        from repro_torch.data.pipeline import SyntheticTokens
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.parallel import tp
        from repro_torch.parallel.mesh_rules import Rules
        from repro_torch.train import step as TS
        from repro_torch.utils.tree import flatten_with_names

        cfg, oc = _elastic_setup()
        pipe = SyntheticTokens(cfg, 8, 32, seed=5)

        def batch(b):
            return {k: torch.from_numpy(v) for k, v in b.items()}

        t0 = time.perf_counter()
        mesh = make_mesh((2, 1))
        rules = Rules(mesh)
        step = TS.make_train_step(cfg, oc, rules=rules)
        state = place_tree(fetch_tree(TS.init_train_state(cfg, oc, 3, "cpu")),
                           TS.state_logical_axes(cfg), rules, "cpu")
        rep: dict = {"losses": [], "step4": {}}
        for _ in range(3):
            state, m = step(state, batch(next(pipe)))
            rep["losses"].append(float(m["loss"]))
        rep["split_leaves"] = sum(hasattr(x, "to_local") for _, x in flatten_with_names(state))
        _elastic_save(work / "cpu-save", state, rank)
        dist.barrier()
        del state
        rep["block_products"] = {}
        for shape in ((2, 1), (1, 2)):
            mesh = make_mesh(shape)
            rules = Rules(mesh)
            state = _elastic_restore(work / "cpu-save", rules, "cpu")
            tp.COUNTS["block_products"] = 0
            state, m = TS.make_train_step(cfg, oc, rules=rules)(state, batch(pipe.batch_at(3)))
            rep["step4"][str(shape)] = float(m["loss"])
            rep["block_products"][str(shape)] = tp.COUNTS["block_products"]
        rep["s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rep["serve"] = _serve_tp_ranks(work, rank)
        rep["serve_s"] = time.perf_counter() - t0
        if rank == 0:
            print(json.dumps(rep), flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


class _GlooGroup:
    """The two CPU ranks of ``gloo_child``, started together, with no card."""

    def __init__(self, work: Path):
        env = {**_child_env(), "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "2"}
        self.logs = [work / f"gloo-rank{r}.log" for r in range(2)]
        self.procs = []
        for r, path in enumerate(self.logs):
            with open(path, "w") as out:
                self.procs.append(subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"), "--gloo-child", str(r), "2",
                     str(work / "gloo-store"), str(work)],
                    env=env, stdout=out, stderr=subprocess.STDOUT))
        self.started = time.perf_counter()
        self.deadline = time.monotonic() + GLOO_DEADLINE_S

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def wait(self) -> dict:
        try:
            for p in self.procs:
                p.wait(timeout=max(self.deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            self.kill()
        texts = [path.read_text() for path in self.logs]
        if any(p.returncode for p in self.procs):
            raise AssertionError(f"the gloo ranks exited {[p.returncode for p in self.procs]}:"
                                 "\n" + "\n".join(_tail(t) for t in texts))
        return json.loads([ln for ln in texts[0].splitlines() if ln.startswith("{")][-1])


def phase_parallel(work: Path, ranks: "_GlooGroup") -> dict:
    """(a) the card's mesh is (1, 1), with no process group, and the rules
    replicate every leaf of three full-width models' trees (structural on a
    mesh of one rank: the CPU tests hold the rules to the reference's at
    meshes of several); (b) ``impl="ring"`` at qwen2's prefill shape: a ring
    of one rank is attention, so under the (1, 1) mesh context, as without a
    mesh, it launches ``flash`` once and returns flash's output, within the
    bf16 tolerance of the plain version; (c) the elastic
    scenario across the card: two CPU ranks (``ranks``, started earlier) at
    (2, 1) train and save, the card restores it and takes step 4, the ranks
    at (2, 1) and at (1, 2) do too; every step-4 loss within ELASTIC_TOL of
    the (2, 1) ranks' own, and the card's re-save of the restored state
    keeps the CPU save's chunk hashes; (d) the ranks' serving snapshots
    (``_serve_tp_ranks``) restored on the card (``_serve_tp_card``)."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import flash_attention, ops, ref
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.parallel.context import use_mesh_context
    from repro_torch.parallel.mesh_rules import Rules, batch_logical_axes, named_axes
    from repro_torch.train import step as TS
    from repro_torch.utils.tree import flatten_with_names

    # the CPU ranks of (c)-(d) end before (b)'s profiled windows: their load on
    # the host's cores can make the profiler drop a window's device events
    cpu = ranks.wait()
    ranks_s = time.perf_counter() - ranks.started

    # ---- (a) the rules on the card's mesh ---------------------------------
    mesh = make_host_mesh("cuda")
    rules = Rules(mesh)
    if mesh.shape != (1, 1) or mesh.device_mesh is not None or dist.is_initialized():
        raise AssertionError(f"the card's mesh is {mesh}, process group "
                             f"{dist.is_initialized()}")
    leaves = 0
    for arch in PARALLEL_ARCHS:
        cfg = get_config(arch)
        trees = [(TS.state_logical_axes(cfg),
                  [(n, tuple(x.shape)) for n, x in
                   flatten_with_names(TS.abstract_train_state(cfg, adamw.OptConfig()))]),
                 (M.cache_logical_axes(cfg, 4, 1024),
                  [(n, s) for n, (s, _) in flatten_cache(M.cache_specs(cfg, 4, 1024))])]
        tokens = {"tokens": torch.empty((8, 128), device="meta")}
        trees.append((batch_logical_axes(tokens), [("tokens", (8, 128))]))
        for axes_tree, named in trees:
            ax = dict(named_axes(axes_tree))
            split = [n for n, shp in named if not rules.is_replicated(ax[n], shp)]
            if split:
                raise AssertionError(f"{arch}: leaves split on the card's mesh: {split[:5]}")
            leaves += len(named)
    groups = rules.axis_group_size("batch")
    log(f"  (a) mesh {mesh}, no process group; {leaves} leaves of {', '.join(PARALLEL_ARCHS)} "
        f"(train state, cache B4 S1024, batch) replicated; batch shards {groups}")
    if groups != 1:
        raise AssertionError(f"batch shards {groups} on one card")

    # ---- (b) the ring at qwen2-0.5b's prefill shape -----------------------
    gen = torch.Generator(device="cuda").manual_seed(12)
    B, S, H, Hkv, D = 4, 512, 14, 2, 64
    sets = copies_past_l2([_randn(s, torch.bfloat16, gen)
                           for s in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D))])
    q, k, v = sets[0]

    def ring(q, k, v):
        with use_mesh_context(mesh, rules):
            return ops.attention(q, k, v, impl="ring")

    def flash(q, k, v):
        return flash_attention.flash(q, k, v, causal=True)

    plain = ref.attention(q.float(), k.float(), v.float(), causal=True)
    got_flash = flash(q, k, v)
    flash_attention.launches = 0
    got_ring = ring(q, k, v)
    ring_launches = flash_attention.launches
    flash_attention.launches = 0
    no_mesh = ops.attention(q, k, v, impl="ring")
    ring_fallthrough = flash_attention.launches
    torch.cuda.synchronize()
    err_plain = float((got_ring.float() - plain).abs().max())
    is_flash = torch.equal(got_ring, got_flash) and torch.equal(no_mesh, got_flash)
    ring_ms, flash_ms = device_ms(ring, sets), device_ms(flash, sets)
    log(f"  (b) impl='ring' B{B} S{S} H{H} Hkv{Hkv} D{D} bfloat16 causal under the (1, 1) "
        f"mesh: flash launches {ring_launches} (expected 1), max_abs_err {err_plain:.3g} "
        f"against the plain version (tol {TOL['bfloat16']}); with no mesh: flash launches "
        f"{ring_fallthrough} (expected 1); both outputs flash's: {is_flash}; device ms "
        f"ring {fmt(ring_ms)}, flash {fmt(flash_ms)}")
    if not (err_plain <= TOL["bfloat16"] and bool(torch.isfinite(got_ring).all())):
        raise AssertionError(f"impl='ring' disagrees with the plain version: {err_plain}")
    if ring_launches != 1 or ring_fallthrough != 1 or not is_flash:
        raise AssertionError(f"impl='ring' launched flash {ring_launches} times under the "
                             f"(1, 1) mesh and {ring_fallthrough} without one")
    del sets, q, k, v, plain, got_ring, got_flash, no_mesh

    # ---- (c) the elastic scenario across the card ---------------------------
    base, other = cpu["step4"]["(2, 1)"], cpu["step4"]["(1, 2)"]
    t0 = time.perf_counter()
    state = _elastic_restore(work / "cpu-save", rules, "cuda")
    restore_s = time.perf_counter() - t0
    _elastic_save(work / "card-resave", state, 0)
    same_hashes = _chunk_hashes(work / "card-resave", 2) == _chunk_hashes(work / "cpu-save", 2)
    cfg, oc = _elastic_setup()
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in SyntheticTokens(cfg, 8, 32, seed=5).batch_at(3).items()}
    flash_attention.launches = 0
    state, m = TS.make_train_step(cfg, oc, rules=rules)(state, batch)
    card4 = float(m["loss"])
    card_flash = flash_attention.launches
    on_card = all(x.is_cuda for _, x in flatten_with_names(state))
    log(f"  (c) {ELASTIC_ARCH} reduced, B8 S32: two CPU ranks at (2, 1) train {cpu['losses']} "
        f"({cpu['split_leaves']} leaves split) and save, then restore at (2, 1) and (1, 2) "
        f"[{cpu['s']:.1f}s from their mesh to their last step; started with phase 11(b), "
        f"done {ranks_s:.1f}s later]; "
        f"step-4 loss at (2, 1) {base!r}, at (1, 2) {other!r} (products on a \"model\" block: "
        f"{cpu['block_products']['(1, 2)']} at (1, 2), {cpu['block_products']['(2, 1)']} at "
        f"(2, 1)), on the card {card4!r} (restore "
        f"{restore_s:.2f}s, flash launches {card_flash}; tol {ELASTIC_TOL}); the card's "
        f"re-save keeps the CPU save's chunk hashes: {same_hashes}")
    if not same_hashes:
        raise AssertionError("the card's re-save of the restored state changed its chunks")
    if cpu["block_products"]["(1, 2)"] <= 0 or cpu["block_products"]["(2, 1)"]:
        raise AssertionError(f"the (1, 2) step did not compute on model blocks: "
                             f"{cpu['block_products']}")
    if not on_card or abs(card4 - base) > ELASTIC_TOL or abs(other - base) > ELASTIC_TOL:
        raise AssertionError(f"step 4 differs across meshes: {cpu['step4']}, card {card4}")
    if card_flash != cfg.num_layers or not math.isfinite(card4):
        raise AssertionError(f"the card's step launched flash {card_flash} times")
    del state
    serve = _serve_tp_card(work, cpu)
    return {"ring_ms": ring_ms, "flash_ms": flash_ms, "ring_err": err_plain,
            "step4": {**cpu["step4"], "card": card4}, "losses": cpu["losses"],
            "card_flash": card_flash, "ring_fallthrough": ring_fallthrough,
            "ring_launches": ring_launches, "serve": serve}


def _attention_layers(cfg) -> int:
    """The layers of ``cfg`` that attend to a cache (zamba2: its shared
    block, once a group; rwkv6: none)."""
    from repro_torch.models import blocks as BL
    from repro_torch.models.model import layer_plan

    return sum(seg.count for seg in layer_plan(cfg)
               if seg.kind in BL.ATTN_KINDS or seg.kind == "zamba_group")


def _serve_tp_card(work: Path, cpu: dict) -> dict:
    """Phase 12(d) on the card: each snapshot the ranks took (at (1, 2) their
    cache blocks on "model": a kv head a rank for qwen2, 16 positions a rank
    for deepseek-v3's latent; at (2, 1) granite-moe's rows) restored at
    (1, 1) and continued: the ranks' tokens, the last logits within
    SERVE_TP_LOGIT_TOL of the largest |logit|, every decode step through
    flash_decode; the ranks' products on blocks as the CPU rehearsal counts
    them, and all-to-alls exactly where the experts split."""
    import torch

    from repro_torch.kernels import decode_attention
    from repro_torch.serve.engine import Engine

    out = {}
    for arch, ranks in cpu["serve"].items():
        cfg, model, _ = _serve_tp_setup(arch, "cuda")
        snap = torch.load(work / f"serve-{arch}.pt", map_location="cuda")
        eng = Engine(cfg, model, batch=SERVE_TP["batch"], max_seq=SERVE_TP["max_seq"])
        decode_attention.launches = 0
        eng.restore({"cache": snap["cache"], "last_tokens": snap["last_tokens"]})
        tokens = eng.generate(SERVE_TP["after"])
        launched = decode_attention.launches
        want = snap["logits"].float()
        err = float((eng.last_logits.float() - want).abs().max())
        scale = float(want.abs().max())
        same = tokens.tolist() == ranks["tokens"]
        want_products = SERVE_TP_PRODUCTS[arch]
        log(f"  (d) {arch} reduced, B{SERVE_TP['batch']} cache {SERVE_TP['max_seq']}: two CPU "
            f"ranks at {tuple(ranks['mesh'])} serve on blocks (products on a \"model\" block, "
            f"rank 0 / 1: {ranks['block_products']}, the rehearsal's {want_products}; "
            f"all-to-alls {ranks['all_to_all']}; cache blocks {ranks['shapes']}) and "
            f"snapshot at token {SERVE_TP['snap_at']}; the card restores the whole snapshot at "
            f"(1, 1): its {SERVE_TP['after']} tokens equal the ranks': {same}; last logits "
            f"max_abs_err {err:.3g} (tol {SERVE_TP_LOGIT_TOL} of {scale:.3g}); flash_decode "
            f"launches {launched}")
        if not same or err > SERVE_TP_LOGIT_TOL * scale:
            raise AssertionError(f"{arch}: the card's continuation differs from the ranks': "
                                 f"{tokens.tolist()} / {ranks['tokens']}, logits {err}")
        if launched != SERVE_TP["after"] * _attention_layers(cfg):
            raise AssertionError(f"{arch}: flash_decode launched {launched} times")
        if ranks["block_products"] != [want_products] * 2:
            raise AssertionError(f"{arch}: the ranks computed {ranks['block_products']} "
                                 f"products on \"model\" blocks, not {want_products}")
        # granite-moe's 8 experts split over the two "data" ranks, nobody else's
        experts_split = ranks["mesh"][0] > 1 and bool(cfg.num_experts)
        if (min(ranks["all_to_all"]) > 0) != experts_split or \
                (not experts_split and max(ranks["all_to_all"])):
            raise AssertionError(f"{arch}: the ranks ran {ranks['all_to_all']} all-to-alls")
        out[arch] = {"tokens_equal": same, "logit_err": err, "flash_decode": launched,
                     "block_products": ranks["block_products"],
                     "all_to_all": ranks["all_to_all"]}
    return out

# ----------------------------------------------------------------------------------
# phase 13: the analysis tools (kernels/costs.py, launch/{hlo_costs,dryrun,roofline})
# ----------------------------------------------------------------------------------

# phase 2's bounds as PERF.md's kernel table prints them, (kernel, label) ->
# ms at those digits: the formulas of kernels/costs.py give the bounds the
# inline arithmetic gave before them
EXPECTED_BOUNDS = {
    ("flash", "qwen2-0.5b prefill"): "0.00250",
    ("flash", "zamba2-1.2b shared block"): "0.01002",
    ("flash", "qwen2-0.5b train forward"): "0.00125",
    ("flash", "zamba2-1.2b train forward"): "0.00501",
    ("flash", "qwen3-4b prefill"): "0.01252",
    ("flash", "granite-moe-3b-a800m prefill"): "0.00501",
    ("flash", "deepseek-v3-671b MLA prefill"): "0.10016",
    ("flash", "reduced deepseek-v3 MLA prefill (phase 4)"): "0.00002",
    ("flash", "granite-moe-3b-a800m train forward"): "0.00250",
    ("flash", "deepseek-v3-671b MLA train forward"): "0.05008",
    ("flash", "deepseek-v3-671b MLA prefill, a rank's heads at model 16"): "0.00626",
    ("flash_decode", "qwen2-0.5b decode"): "0.00034",
    ("flash_decode", "zamba2-1.2b decode"): "0.00533",
    ("flash_decode", "qwen3-4b decode"): "0.00268",
    ("flash_decode", "granite-moe-3b-a800m decode"): "0.00134",
    ("flash_decode", "deepseek-v3-671b MLA absorbed decode"): "0.00108",
    ("flash_decode", "reduced deepseek-v3 MLA absorbed decode (phase 4)"): "0.000002",
    ("chunk_fingerprints", "qwen2-0.5b embed table"): "0.16245",
    ("checksum", "qwen2-0.5b embed table"): "0.16245",
    ("ssd", "zamba2-1.2b prefill"): "0.01150",
    ("ssd", "zamba2-1.2b train forward"): "0.00513",
    ("wkv6", "rwkv6-1.6b prefill"): "0.01315",
    ("wkv6", "rwkv6-1.6b train forward"): "0.00626",
    ("ssd", "zamba2-1.2b prefill, a rank's heads at model 16"): "0.000866",
    ("wkv6", "rwkv6-1.6b prefill, a rank's heads at model 16"): "0.000822",
}
# (c): the dry run (three cells, their processes started together) and then
# the roofline, as a user runs them, on the CPU
ANALYSIS_SHAPES = ("train_4k", "decode_32k", "prefill_32k")
ANALYSIS_CLI = ([["repro_torch.launch.dryrun", "--arch", "qwen2-0.5b", "--shape", shape,
                  "--mesh", "pod"] for shape in ANALYSIS_SHAPES],
                ["repro_torch.launch.roofline"])
ANALYSIS_DEADLINE_S = 240
# (c): the record's step on "model" blocks, against the step that gathered
# every parameter whole (2.751e14 FLOPs a rank, 6ND/walk 0.04, 7.9 GB of
# whole float32 gradients all-reduced a rank a step)
TP_FLOPS_MAX = 1.0e14
TP_USEFUL_MIN = 0.11
TP_GRAD_BYTES_MAX = 7.9e9 / 8
# (c): the serving cells on "model" blocks, with the cache as the rules' blocks,
# against the steps that gathered every parameter whole and redistributed the
# cache to rows (decode_32k 3.05e10 FLOPs a rank, 3.23 GB of output, two cache
# leaves all-gathered, 2 x 201 MB; prefill_32k 1.39e14 FLOPs, 5.80 GB of
# temporaries).  A cache leaf's block a rank, seg0/k, is 100.7 MB: the decode
# step's all-gathers (the parameters' FSDP blocks) stay below it
SERVE_LIMITS = {"decode_32k": {"flops": 5e9, "output_size": 0.5e9, "all-gather": 1.0e8},
                "prefill_32k": {"flops": 1.0e14, "temp_size": 3.0e9}}
PEAK_TOL = 0.25          # (b): the dry run's peak against the allocator's
SHARE_MAX = 1.05         # (d): model FLOPs over (device time x peak)


class _AnalysisCLI:
    """Phase 13(c)'s two commands, one after the other in a thread, with no
    card, started before phase 11(c) so that they run behind it."""

    def __init__(self, work: Path):
        self.log = work / "analysis.log"
        self.procs, self.rcs, self.secs, self.stopped = [], [], [], False
        self.deadline = time.monotonic() + ANALYSIS_DEADLINE_S
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        env = {**_child_env(), "CUDA_VISIBLE_DEVICES": ""}
        with open(self.log, "w") as out:
            for argvs in ANALYSIS_CLI:
                if self.stopped:
                    return
                t0 = time.perf_counter()
                self.procs = [subprocess.Popen([sys.executable, "-m", *argv], env=env,
                                               cwd=ROOT, stdout=out, stderr=subprocess.STDOUT)
                              for argv in (argvs if isinstance(argvs[0], list) else [argvs])]
                self.rcs.append(max(p.wait() for p in self.procs))
                self.secs.append(time.perf_counter() - t0)
                if self.rcs[-1]:
                    return

    def kill(self) -> None:
        self.stopped = True
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def wait(self) -> dict:
        self.thread.join(max(self.deadline - time.monotonic(), 1))
        if self.thread.is_alive():
            self.kill()
            self.thread.join()
        text = self.log.read_text()
        if self.rcs != [0, 0]:
            raise AssertionError(f"dryrun / roofline exited {self.rcs}:\n{_tail(text)}")
        recs = {shape: json.loads((ROOT / "results" / "dryrun_torch" /
                                   f"qwen2-0.5b__{shape}__pod.json").read_text())
                for shape in ANALYSIS_SHAPES}
        bad = {shape: rec.get("error") for shape, rec in recs.items() if not rec.get("ok")}
        if bad:
            raise AssertionError(f"the dry run's records are not ok: {bad}")
        return {"record": recs["train_4k"], "serving": recs, "secs": self.secs,
                "output": text}


def phase_analysis(kern: dict, timed: list, cli: "_AnalysisCLI") -> dict:
    """(a) phase 2's bounds, from ``kernels/costs.py`` and the roofline's
    constants, read as PERF.md's table prints them; (b) one train step of
    qwen2-0.5b at full width and phase 6's STATE_LAYERS layers (B8 S128) on
    the card under ``launch/hlo_costs.py``'s walk, against the dry run of
    the same configuration and shape on meta tensors (mesh (1, 1)): FLOPs
    and kernel calls by kind equal (and equal to the wrappers' launches),
    the arguments' bytes equal to the live state's and batch's, the
    predicted peak (arguments + temporaries) within PEAK_TOL of
    ``torch.cuda.max_memory_allocated()``; (c) ``launch.dryrun`` and
    ``launch.roofline`` as subprocesses (``cli``): both exit 0, the record
    ok; (d) each step timed on the device in the earlier phases (``timed``:
    label, config, kind, batch, seq, device ms): model FLOPs over (device
    time x the compute dtype's peak), none above SHARE_MAX."""
    # ---- (a) the bounds --------------------------------------------------------
    seen = {}
    for name, r in kern.items():
        for sh in r["shapes"]:
            want = EXPECTED_BOUNDS.get((name, sh["label"]))
            if want is not None:
                seen[(name, sh["label"])] = f"{sh['bound_ms']:.{len(want) - 2}f}"
    if seen != EXPECTED_BOUNDS:
        raise AssertionError(f"bounds differ from PERF.md's table: "
                             f"{ {k: v for k, v in seen.items() if EXPECTED_BOUNDS.get(k) != v} }"
                             f", missing {sorted(set(EXPECTED_BOUNDS) - set(seen))}")
    log(f"  (a) {len(seen)} phase-2 bounds from kernels/costs.py, as PERF.md prints them")
    step_rep = analysis_step()
    cli_rep = analysis_cli(cli)
    shares = timed_shares(timed)
    return {**step_rep, "cli_secs": cli_rep["secs"], "shares": shares,
            "tp": {k: cli_rep[k] for k in ("flops", "useful", "grad_bytes", "serving")}}


def analysis_step() -> dict:
    """Phase 13(b) (see ``phase_analysis``)."""
    import torch

    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.kernels import ssd as SSD
    from repro_torch.kernels import wkv6 as WKV
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_costs import analyze_step
    from repro_torch.optim import adamw
    from repro_torch.train import step as TS
    from repro_torch.utils.tree import flatten_with_names

    cfg = get_config("qwen2-0.5b").replace(num_layers=STATE_LAYERS)
    oc = adamw.OptConfig(warmup_steps=10, decay_steps=TRAIN_STEPS)
    t0 = time.perf_counter()
    walk, _ = dryrun.walk_cell(cfg, ShapeConfig("phase 6", "train", 128, 8), (1, 1),
                               microbatches=1)
    dry = {**walk.costs(), "memory": walk.memory}
    dry_s = time.perf_counter() - t0
    state = TS.init_train_state(cfg, oc, 0, "cuda")
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in SyntheticTokens(cfg, 8, 128).batch_at(0).items()}
    step = TS.make_train_step(cfg, oc)
    state, _ = step(state, batch)                # warm
    torch.cuda.synchronize()
    live = sum(x.numel() * x.element_size() for _, x in flatten_with_names([state, batch]))
    mods = {"flash": flash_attention, "flash_decode": decode_attention, "ssd": SSD, "wkv6": WKV}
    n0 = {k: m.launches for k, m in mods.items()}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    card = analyze_step(step, state, batch)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launched = {k: m.launches - n0[k] for k, m in mods.items() if m.launches - n0[k]}
    calls = {k: v["calls"] for k, v in card["kernels"].items()}
    dry_calls = {k: v["calls"] for k, v in dry["kernels"].items()}
    predicted = dry["memory"]["argument_size"] + dry["memory"]["temp_size"]
    log(f"  (b) qwen2-0.5b {STATE_LAYERS} layers B8 S128, a train step on the card under the "
        f"walk ({card_s:.1f}s) and its dry run on meta ({dry_s:.1f}s): FLOPs {card['flops']:.0f}"
        f" / {dry['flops']:.0f}; kernel calls {calls} / {dry_calls}, launches {launched}; "
        f"bytes {card['bytes']:.0f} / {dry['bytes']:.0f}; arguments {live} live / "
        f"{dry['memory']['argument_size']}; peak {peak} allocated / {predicted} predicted "
        f"(arguments + {dry['memory']['temp_size']} temporaries), "
        f"{100 * (predicted - peak) / peak:+.2f}%")
    if card["flops"] != dry["flops"] or calls != dry_calls or calls != launched:
        raise AssertionError(f"the card's step and its dry run differ: FLOPs {card['flops']} / "
                             f"{dry['flops']}, calls {calls} / {dry_calls}, launches {launched}")
    if live != dry["memory"]["argument_size"]:
        raise AssertionError(f"argument bytes {dry['memory']['argument_size']} != the live "
                             f"state's and batch's {live}")
    if abs(predicted - peak) > PEAK_TOL * peak:
        raise AssertionError(f"predicted peak {predicted} is not within {PEAK_TOL:.0%} of "
                             f"the allocator's {peak}")
    del state, batch, step
    torch.cuda.empty_cache()
    return {"card": {k: card[k] for k in ("flops", "bytes", "kernels")},
            "dry_memory": dry["memory"], "peak": peak, "live": live}


def analysis_cli(cli: "_AnalysisCLI") -> dict:
    """Phase 13(c) (see ``phase_analysis``)."""
    cli_rep = cli.wait()
    rec = cli_rep["record"]
    log(f"  (c) dryrun, {len(ANALYSIS_SHAPES)} cells at once ({cli_rep['secs'][0]:.1f}s), and "
        f"roofline ({cli_rep['secs'][1]:.1f}s) "
        f"exit 0; qwen2-0.5b train_4k pod, rank 0 of 256: FLOPs {rec['hlo_costs']['flops']:.4g},"
        f" bytes {rec['hlo_costs']['bytes']:.4g}, collectives {rec['hlo_costs']['collectives']},"
        f" arguments {rec['memory']['argument_size']}, temporaries "
        f"{rec['memory']['temp_size']}, walked in {rec['trace_s']}s")
    for ln in cli_rep["output"].splitlines():
        if ln.startswith("| qwen2-0.5b"):
            log(f"      {ln}")
    from repro_torch.launch.roofline import analyze_cell

    flops = rec["hlo_costs"]["flops"]
    useful = analyze_cell(rec)["useful_ratio"]
    grads = rec["hlo_costs"]["section_collective_bytes"].get("grads", 0.0)
    log(f"      on \"model\" blocks: FLOPs a rank {flops:.4g} (at most {TP_FLOPS_MAX:.4g}), "
        f"6ND/walk {useful:.4f} (at least {TP_USEFUL_MIN}), the gradients' collectives "
        f"{grads:.4g} B a rank a step (at most {TP_GRAD_BYTES_MAX:.4g})")
    if flops > TP_FLOPS_MAX or useful < TP_USEFUL_MIN or grads > TP_GRAD_BYTES_MAX:
        raise AssertionError(f"the dry run's step is not split over 'model': FLOPs {flops}, "
                             f"6ND/walk {useful}, gradient collectives {grads}")
    cli_rep.update(flops=flops, useful=useful, grad_bytes=grads)
    serving = {}
    for shape, limits in SERVE_LIMITS.items():
        rec = cli_rep["serving"][shape]
        got = {"flops": rec["hlo_costs"]["flops"],
               "all-gather": rec["hlo_costs"]["collectives"].get("all-gather", 0.0),
               **rec["memory"]}
        log(f"      {shape} on \"model\" blocks, the cache as the rules' blocks: FLOPs a rank "
            f"{got['flops']:.4g}, output {got['output_size']:.4g} B, temporaries "
            f"{got['temp_size']:.4g} B, all-gathers {got['all-gather']:.4g} B (limits "
            + ", ".join(f"{k} {v:.4g}" for k, v in limits.items()) + ")")
        over = {k: got[k] for k, v in limits.items() if got[k] > v}
        if over:
            raise AssertionError(f"the dry run's {shape} is over its limits: {over}")
        serving[shape] = {k: got[k] for k in ("flops", "output_size", "temp_size",
                                               "all-gather")}
    cli_rep["serving"] = serving
    return cli_rep


def timed_shares(timed: list) -> dict:
    """Phase 13(d) (see ``phase_analysis``)."""
    from repro_torch.launch.roofline import PEAK_FLOPS, model_flops

    shares = {}
    for label, c, kind, B, S, ms in timed:
        if not math.isfinite(ms):
            log(f"  (d) {label}: device time not measured, no share")
            continue
        shares[label] = model_flops(c, kind, B, S) / (ms / 1e3 * PEAK_FLOPS[c.compute_dtype])
    log("  (d) model FLOPs over (device time x peak): "
        + ", ".join(f"{k} {v:.4f}" for k, v in shares.items()))
    over = {k: v for k, v in shares.items() if v > SHARE_MAX}
    if over:
        raise AssertionError(f"shares above {SHARE_MAX}: {over}")
    return shares


def flatten_cache(specs, path=()):
    """(path, (shape, dtype)) of a ``models.model.cache_specs`` tree."""
    for k in sorted(specs):
        v = specs[k]
        if isinstance(v, dict):
            yield from flatten_cache(v, path + (k,))
        else:
            yield "/".join(path + (k,)), v


def main() -> int:
    import torch

    from repro_torch.configs.base import get_config

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
    serve_rep, profile_rep = {}, {}
    for arch in SERVE_ARCHS:
        depth = SERVE_DEPTH.get(arch)
        phase(f"phase 3 serve {arch} at full width"
              + (f" and {depth} layers" if depth else "") + " with snapshot/migrate/restore")
        model = served_model(arch)[0]
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            serve_rep[arch] = phase_serve(tmp, arch, model)
        phase(f"phase 5 where the serving path's device time goes (torch.profiler), {arch}"
              " on phase 3's parameters")
        profile_rep[arch] = phase_profile(arch, model)
        if arch == "granite-moe-3b-a800m":
            # the values ``init_train_state`` draws from seed 0
            # (``layers.materialize``): trained in place, not drawn again,
            # and freed with the model, before any other phase reads a peak
            phase("phase 11(a) train granite-moe-3b-a800m at full width and depth, in "
                  "process, on phase 3's parameters")
            moe_rep = phase_train_full(arch, params=model.tree)
        del model
        torch.cuda.empty_cache()
    phase("phase 4 reduced models: card against CPU")
    phase_reference("qwen2-0.5b", 24, 64)
    # 70 tokens: two chunks of the SSD kernel, the second ragged
    phase_reference("zamba2-1.2b", 70, 96)
    phase_reference("rwkv6-1.6b", 70, 96)
    phase_reference("qwen3-4b", 24, 64)
    phase_reference("granite-8b", 24, 64)
    phase_reference("granite-moe-3b-a800m", 24, 64)
    reduced_mla = phase_reference("deepseek-v3-671b", 24, 64)
    phase_reference("musicgen-large", 24, 64)
    phase_reference("llava-next-mistral-7b", 24, 64)
    phase_reference_train("zamba2-1.2b")
    phase_reference_train("rwkv6-1.6b")
    for arch in ("granite-moe-3b-a800m", "deepseek-v3-671b", "musicgen-large",
                 "llava-next-mistral-7b"):
        phase_reference_train(arch)
    work = _work_dir()
    ranks = cli = None
    try:
        phase(f"phase 6 the full-width train state ({STATE_LAYERS} layers): fingerprints, a "
              "profiled step, saves")
        state_rep = phase_state(work)
        phase(f"phase 7 train qwen2-0.5b at full width and {TRAIN_LAYERS['qwen2-0.5b']} layers "
              "through the C/R loop (--ckpt-delta --ckpt-device-fp): A, B preempted, C "
              "requeued; B and C as a job of one rank (an NCCL group of one)")
        train_rep = phase_train(work, "qwen2-0.5b", ranks=True)
        phase("phase 8 fleet: serve --follow at full width (qwen2-0.5b) on pushed weights")
        fleet_rep = phase_fleet(work)
        phase("phase 9 scheduler: SlurmSim preempts the phase 7 trainer and requeues it "
              "onto its warm node")
        sched_rep = phase_sched(work, train_rep)
        full_rep = {}
        for arch in ("zamba2-1.2b", "rwkv6-1.6b"):
            phase(f"phase 10(a) train {arch} at full width and depth, in process")
            full_rep[arch] = phase_train_full(arch)
        phase(f"phase 10(b) train zamba2-1.2b at full width and "
              f"{TRAIN_LAYERS['zamba2-1.2b']} layers through the C/R loop: A, B preempted, "
              "C requeued")
        ssm_rep = phase_train(work, "zamba2-1.2b")
        # phase 12(c)'s two CPU ranks (mostly ``import torch``, then a few
        # small steps) run beside 11(b), whose step keeps the card busy
        ranks = _GlooGroup(work)
        phase("phase 11(b) train deepseek-v3-671b at full width: one dense layer, an empty "
              "MoE segment and the MTP block, in process")
        mla_rep = phase_train_full("deepseek-v3-671b",
                                   get_config("deepseek-v3-671b").replace(**MLA_TRAIN_CUT),
                                   "deepseek-v3-671b 1 dense layer + MTP")
        # phase 13(c)'s dry run and roofline (CPU subprocesses) run behind 11(c)
        cli = _AnalysisCLI(work)
        phase(f"phase 11(c) the C/R cycle of granite-moe-3b-a800m at full width and "
              f"{MOE_CR_LAYERS} of 32 layers, in process: step, device-fp save, restore, "
              "next step")
        cr_rep = phase_cr_in_process(work, "granite-moe-3b-a800m", MOE_CR_LAYERS)
        phase("phase 12 parallelism: the card's mesh and rules, the ring, the elastic restore "
              "across CPU ranks and the card, a snapshot of CPU ranks serving on 'model' "
              "blocks restored on the card")
        phase_parallel(work, ranks)
        phase("phase 13 analysis: the bounds' formulas, a train step on the card under the "
              "walk against its dry run, dryrun and roofline, the timed steps' shares")
        timed = [(f"serve {arch} {kind}", rep_["cfg"], kind, 4, 512, rep_[kind]["busy_ms"])
                 for arch, rep_ in profile_rep.items() for kind in ("prefill", "decode")]
        timed.append((f"phase 6 train ({STATE_LAYERS} layers)", state_rep["cfg"], "train", 8,
                       128, state_rep["device_ms"]))
        for label, r in (("10(a) train zamba2-1.2b", full_rep["zamba2-1.2b"]),
                         ("10(a) train rwkv6-1.6b", full_rep["rwkv6-1.6b"]),
                         ("11(a) train granite-moe-3b-a800m", moe_rep),
                         ("11(b) train deepseek-v3-671b cut", mla_rep)):
            timed.append((label, r["cfg"], "train", 8, 128, r["device_ms"]))
        phase_analysis(kern, timed, cli)
        phase("done")
    finally:
        if cli is not None:
            cli.kill()
        if ranks is not None:
            ranks.kill()
        shutil.rmtree(work, ignore_errors=True)

    # launches over every main-path run of this script: the six serve runs,
    # the train runs of phases 7, 10 and 11, the in-process follower and the
    # scheduled job (the checksum kernel is on no main path)
    runs = {arch: r["counts"] for arch, r in serve_rep.items()}
    runs["train"] = train_rep["counts"]
    runs["fleet"] = fleet_rep["counts"]
    runs["sched"] = sched_rep["counts"]
    runs["train-zamba2"] = {k: full_rep["zamba2-1.2b"]["counts"].get(k, 0) + n
                            for k, n in ssm_rep["counts"].items()}
    runs["train-rwkv6"] = full_rep["rwkv6-1.6b"]["counts"]
    runs["train-granite-moe"] = {"flash": moe_rep["counts"]["flash"] + cr_rep["counts"]["flash"],
                                 "chunk_fingerprints": cr_rep["counts"]["chunk_fingerprints"]}
    runs["train-deepseek-v3"] = mla_rep["counts"]
    # phase 4's reduced MLA model: the (48, 32) shapes' launches, on no main path
    checks = {"reduced deepseek-v3-671b": reduced_mla["counts"]}
    gb = {"6": sum(sv.get("bytes_written") or 0 for sv in state_rep["saves"].values()),
          "7": train_rep["saved_bytes"], "8": fleet_rep["saved_bytes"],
          "9": sched_rep["saved_bytes"], "9 promoted": sched_rep["promoted_bytes"],
          "10(b)": ssm_rep["saved_bytes"], "11(c)": cr_rep["saved_bytes"]}
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
            per_shape.append({**sh, "launches": {**runs, **checks}.get(sh["source"], {})
                              .get(name, 0)})
        first = r["shapes"][0]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": sum(c.get(name, 0) for c in runs.values()),
                        "max_abs_err": r["max_abs_err"], "ms": first["ms"]["median"],
                        "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
                        "bound_by": first["bound_by"],
                        "library_ms": first["library_ms"] and first["library_ms"]["median"]})
    # the card's (1, 1) mesh splits no expert: every MoE run above took the plain path
    from repro_torch.parallel import ep

    if ep.COUNTS["all_to_all"]:
        raise AssertionError(f"the card ran {ep.COUNTS['all_to_all']} all-to-alls")
    log(f"all phases passed in {time.perf_counter() - T0:.1f}s; all-to-alls on the card: "
        f"{ep.COUNTS['all_to_all']}")
    # every timed shape with its launches on the main paths (ms and library_ms:
    # device time, median/min/max of 5; call_ms: back-to-back calls by events;
    # backward_ms, at the train shapes: the plain recompute by events)
    print(json.dumps({"kernel_shapes": per_shape}))
    print(json.dumps({"phase_seconds": PHASE_SECONDS,
                      "saves_gb": {k: v / 1e9 for k, v in gb.items()}}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--train-child"]:
        sys.exit(train_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--gloo-child"]:
        sys.exit(gloo_child(sys.argv[2:]))
    sys.exit(main())
