#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one CUDA card.

Drives the port's paths at full width through the entry points a user
calls -- the paper's evaluation, the ReCXL mechanism (replication into
per-node log rings, Algorithms 1-2 recovery, the log-dump compressor,
the YCSB key-value demo), serving hymba-1.5b, moonshot-v1-16b-a3b,
whisper-medium (enc-dec) and internvl2-26b (vlm) whole and four more
decoder configs cut in depth (prefill + greedy decode), the scenario
service with its chaos recovery over logical shards, and training
qwen3-0.6b whole through the fault-tolerant ``Trainer`` -- and holds
each hand-written CUDA kernel against its plain PyTorch version:

1. build ``bank_scan.cu``, ``log_compress.cu``, ``flash_attn.cu``,
   ``flash_attn_bwd.cu``, ``ssd_scan.cu`` and ``store_timeline.cu`` from
   ``src/repro_torch/csrc``, one nvcc each, started together; ptxas
   reports no spill in any ``store_timeline`` instantiation, in the
   three ``flash_attn`` instantiations at head dim 160 nor in the
   ``flash_attn_bwd`` tensor-core kernels at head dims 64 and 128;
2. kernel against the plain version on the card, ``==`` on all three
   outputs, over real banks at sb in {1, 7, 24, 48, 72, 200, 500}, a
   ragged n, n = 1, padded lanes and the ``[0]`` view of a sub-bank stack,
   with the ring instantiation (register, shared, scratch) each sb ran
   on: sb 48 and 72 on the register ring; and a 4-shard, k_replicas = 2
   stack with NaN replica blocks and capacity tail, read through flat
   rows by lanes of every shard at sb 48, 72 and 200;
3. ``run_sweep(fig10_grid(), n_stores=50_000)`` on the blocked tier: one
   launch, every cell ``==`` the plain version on CPU tensors, three
   cells ``==`` the serial per-store oracle, geomeans inside the paper's
   bands and ``==`` the JAX package's values at this size; the kernel's
   time beside its bound and the serial chain's floor;
4. ``run_sweep(mega_grid(), n_stores=50_000)`` on the stream tier: 27 +
   1 298 bank rows, 2 700 lanes, one launch per tile, 64 sampled lanes
   ``==`` the plain version on CPU;
5. ``compress`` / ``decompress`` kernels against the plain version on the
   card, ``==`` on codes, scales and decompressed words: bits 8 and 4,
   ragged n and n = 1, zero-delta rows, subnormal input, and a NaN word
   (no fault; its code as documented);
6. ``run_fault_scenario`` over ``enumerate_fault_scenarios()`` (51 Fig. 9
   fail -> replay -> resume runs) on the card: every invariant holds and
   each check's newest_ts and downtime ``==`` the JAX package's;
7. the paper's width: Table II's 16 CNs, N_r = 3, the SS VI YCSB store
   (500 000 records x 10 fields x 100 B, 10 leaves of (500 000, 25) f32
   sharded over the nodes), default engine knobs with f32 logs: a 19.2 GB
   log ring, 10 steps of YCSB updates (the ring wraps at 8), node 5 fails
   at step 6 and node 11 at step 8, both recover ``==`` their truth; then
   one compress and one decompress of the 500 MB state against its base
   at 8 and 4 bits, ``==`` the plain version on the card;
8. ``flash_attention`` and ``ssd_scan`` kernels against their plain
   versions (``_blockwise_attention``, ``ssd_chunked``) and oracles
   (``attention_ref``, ``ssd_ref``) on the card, with TF32 off: every
   case of ``tests/test_kernels.py`` and a bf16 twin of each f32 attention
   case (each kernel's bf16 through its tensor-core kernel, f32 through
   its CUDA-core one, each call's route checked), unmasked cases with
   Skv = 1 500 (not a multiple of the 64-key tile) and Sq 100 or 1 500,
   hymba-1.5b's, moonshot-v1-16b-a3b's, stablelm-12b's (head dim 160, in
   bf16 and f32), whisper-medium's (encoder and cross-attention unmasked,
   the cross one at Sq 224 against 1 500 frames; decoder causal) and
   internvl2-26b's per-layer shapes; for the SSD also mamba2-2.7b's p 64 /
   n 128, n = 8, a ragged
   last chunk, an initial state, a decay strong enough to overflow exp
   above the diagonal and one weak enough (A = -0.05) to carry the state
   across 16 chunks of 256, at the JAX tests' tolerances; at the serving
   shapes each query row of attention against its own scale and the SSD
   state against its own; planted faults that must land above the limit
   (attention's last q tile without its diagonal kv tile, the SSD state
   without its last chunk, each SSD chunk reading its own output state as
   its prior); each kernel's time against its bound, its plain version and,
   in turns, its CUDA-core kernel run on bf16 (and, attention, at every
   per-layer shape above and qwen3-0.6b's, ``scaled_dot_product_attention``),
   the SSD passes split by the profiler and the SSD f32 time;
9. ``repro_torch.launch.serve.serve`` of hymba-1.5b at full width (32
   layers, d_model 1600, seeded random weights): 4 prompts of 4 096
   tokens, 32 greedy tokens each; each kernel launched once per layer in
   the prefill, both on their tensor-core kernels (bf16) and, for the
   f32 copy below, on their CUDA-core ones; tokens in range and logits
   finite; the prefill's logits
   through the kernels against the plain versions on the card, and decode
   steps 1 and 31 against a fresh prefill of the prompt plus the tokens
   generated so far; then the same comparisons on an f32 copy of the
   weights; in both, faults planted on purpose (a wrong GQA head map, an
   SSD state not carried across chunks, a zeroed SSD state or a short kv
   length handed to decode) must land above the limit, save those the
   bf16 comparison cannot see;
10. the ``store_timeline`` kernel (the five commit rules before the
    max-plus collapse) against its plain versions, ``==`` on all three
    outputs, with the ring instantiation each call took (register at sb
    48 / 72, shared up to 384 slots, scratch above): the serial mode for
    each rule at sb 1, 7, 48, 72 and 500 on real Fig. 10 cells at a ragged
    n = 2 003 (plain version on the card), at sb 48 and 72 (proactive also
    1, 7, 500) at 50 000 stores (plain version on CPU tensors of the same
    inputs), at n = 1, 5 and one either side of the kernel's chunk, and on
    views that start at element 1 (no input 16-byte aligned); the
    per-step mode on Fig. 10's own sb-72 batch (the register ring, read
    from the lanes' depths) at those sizes and 50 000, on a mixed-SB batch (sb
    16 / 48 / 72 / 200: shared) and one past the shared ring (sb 16 / 48 /
    400 / 500: scratch), padded lanes; a lane deeper than its ring gives
    NaN / -1;
11. Fig. 10 at ``n_stores=50 000`` through four routes, caches cleared
    before each: ``simulate_grid(engine="serial")`` (45 store_timeline
    launches, all on the register ring), ``simulate_batch(chunk_size=0)``
    (one per-step launch, register ring), ``simulate_batch(data_plane=
    "stacked")`` (one bank_scan launch per SB group) and the banked
    ``simulate_batch`` (one launch); every field of every cell ``==``
    across the routes, the serial route ``==`` the per-store numpy oracle
    on three cells and its geomeans ``==`` the JAX package's; each
    route's wall, and store_timeline's time per launch (serial, by rule,
    per-step on the register and the shared ring) beside its bound (by
    rule: each reads only its rule's inputs) and the chain floor;
12. the mega-grid at 50 000 stores on the stacked stream tier (82 tiles
    of cell-major per-cell arrays, one bank_scan launch each): every
    cell ``==`` the banked stream tier's, six sampled cells ``==``
    ``simulate_spec``; the spans and ``bank_stats()``;
13. the scenario service at the evaluation's width: a ``ScenarioServer``
    over 4 logical shards (64-lane serve tiles) warmed on the mega-grid
    (27 + 1 298 rows, 2 700 lanes, 512 local wv rows a shard), then a
    seeded stream of 500 queries (70% mega-grid cells, 30% of 30 novel
    seed-3 cells), a 64-query submit burst, a grid query and a downtime
    query: mega-grid answers ``==`` phase 4's, novel ones ``==`` the
    blocked oracle and three ``==`` ``simulate_spec``; zero new tile
    programs and kernel builds after the warm; hit and miss latency,
    queries per second, h2d bytes per query, launches, resident bytes;
14. resilience: the mega-grid at 4 logical shards with a replica set,
    fault-free, then losing shard 3 at dispatch 5 (rebuilt from the
    replica block), then with wv row 0 corrupted (found by digest), each
    ``==`` phase 4 with zero new tile programs; a degraded finish on 3
    shards (``==``, one new program per SB group); and
    ``serve_scenarios`` in process at 50 000 stores, 200 queries, 4
    shards, shard 3 lost mid-stream, ``--check``;
15. ``repro_torch.launch.serve.serve`` of moonshot-v1-16b-a3b at its
    published width and depth (48 layers, d_model 2 048, 64 experts top-6
    + 2 shared, 28.9e9 parameters in bf16, seeded random weights): 4
    prompts of 2 048 tokens, 32 greedy tokens each; 48 tensor-core
    ``flash_attn`` launches in the prefill; request 0's logits through
    the kernel against the plain attention, decode steps 1 and 31 against
    fresh prefills at the no-drop capacity factor 16, and three planted
    faults (gates not renormalized, shared experts left out, a short kv
    length); then an f32 copy cut to 4 layers through the CUDA-core
    kernel. Routing flips between two runs are counted, shown and, where
    a comparison reads above its limit with flips, read again with the
    second run pinned to the first run's experts; a profiled prefill and
    8 decode steps with the MoE dispatch as its own bucket;
16. grok-1-314b, deepseek-67b, stablelm-12b (head dim 160) and
    starcoder2-15b at full width, cut to 2 layers: batch 1, a 512-token
    prompt, 4 decode steps each; 2 tensor-core launches each, logits
    against the plain attention and fresh prefills (grok at capacity
    factor 16);
17. ``repro_torch.examples.ycsb_kv`` with its Logging Units on the card:
    the failed node's shard recovered with an exact match, 0 drops;
18. ``repro_torch.launch.serve.serve`` of whisper-medium at its published
    width and depth (24 encoder and 24 decoder layers, d_model 1 024, 16
    heads of 64, 0.81e9 parameters in bf16, seeded random weights, stub
    frame embeddings): 8 requests of 1 500 frames and 224 prompt tokens,
    32 greedy tokens each; 72 tensor-core ``flash_attn`` launches per
    prefill (24 encoder, 24 decoder, 24 cross-attention), 0 in decode;
    request 0's logits at every prompt position through the kernel
    against the plain attention, decode steps 1 and 31 against fresh
    prefills, planted faults (cross-attention under a causal mask, the
    encoder causal, the cross caches one frame short; the two
    cross-attention ones below bf16's rounding, so gated on the f32
    copy only); then an f32 copy of the whole model through the
    CUDA-core kernel; a profiled prefill and 8 decode steps;
19. the same for internvl2-26b at its published width and depth (48
    layers, d_model 6 144, 48 heads and 8 kv heads of 128, 19.9e9
    parameters, 39.7 GB in bf16, stub patch embeddings in the leading
    256 positions): 4 prompts of 1 024 positions, 32 greedy tokens each;
    48 launches per prefill; the planted fault: ``patch_embeds``
    ignored; the f32 copy at full width cut to 2 layers;
20. training: the ``flash_attn`` backward kernels (``flash_attn_bwd.cu``:
    bf16 on the tensor cores, f32 on the CUDA cores) against their plain
    version (``attention_bwd_ref``, one request at a time) at qwen3-0.6b's
    training shape (B 4, S 4 096, H 16, K 8, D 128, causal), hymba-1.5b's,
    whisper-medium's encoder and cross-attention (unmasked, Sq 224 / Skv
    1 500) and stablelm-12b's head dim 160, in bf16 (also against an f32
    oracle, and the CUDA-core kernels on the same inputs) and, at the
    last two, f32; two launches bit-identical;
    planted faults (dK / dV not summed over the GQA group, the causal
    mask dropped) above the limits; each shape's time beside its bound,
    the CUDA-core kernels' on the same bf16 inputs (the tensor-core ones
    at least 4x faster at qwen3's shape), the plain version's and SDPA's
    forward + backward; then
    qwen3-0.6b at its published width and depth (28 layers, 0.6e9
    parameters, bf16, AdamW with an f32 master copy, ``remat="full"``)
    trained 6 steps through ``Trainer`` on a logical data 4 x model 2
    mesh (proactive, N_r 2, 4 buckets) at train_4k's 4 096 positions and
    batch 4, node 2 failing at step 3 (recovered from the replica logs,
    the installed shard ``==`` the node's parameters with its blocks
    lost) and one MN dump (restored bit for bit); 56 forward and 28
    backward launches a step, all 28 on the tensor-core backward, no
    ``ssd_scan``; step time, tokens/s, peak memory, model FLOP share, replicate, recovery and dump walls; and the
    gradients of ``loss_fn`` through the kernels against the plain
    attention on an f32 copy cut to 2 layers (the CUDA-core backward),
    with the causal mask dropped in the backward as a planted fault;
21. the ssm, hybrid, MoE and enc-dec families trained: the ``ssd_scan``
    backward kernels (``ssd_scan_bwd.cu``, CUDA cores, f32 sums, no
    atomics) against their plain version (``ssd_bwd_ref``, from the
    forward's priors) and the f32 autograd of ``ssd_chunked`` at
    hymba-1.5b's training shape (b 4, l 4 096, h 50, p 64, n 16, bf16),
    mamba2-2.7b's (b 2, h 80, n 128, bf16; f32 at b 1) and mamba2's heads
    over a ragged l 4 000 with an initial state and the final state's
    gradient (both dtypes); two launches bit-identical; planted faults (dB
    not summed over the heads, the chunk decay dropped from the reverse
    walk, the padded tail's seg_last gradient dropped) above the limits;
    each shape's time beside its bound, the forward's with and without
    its priors, the plain version's and the plain autograd's; then
    hymba-1.5b (32 layers, node 2 failing at step 2, recovered ``==``)
    and mamba2-2.7b (64 layers, batch 2, one log slot) at 4 096 positions,
    moonshot-v1-16b-a3b at full width cut to 2 layers (batch 2 x 2 048)
    and whisper-medium whole (batch 8, 1 500 frames, 224 tokens) trained
    through ``Trainer`` (bf16, AdamW with an f32 master copy, remat full,
    the data 4 x model 2 mesh, no MN dump), each step's ``flash_attn``
    and ``ssd_scan`` launches counted (hymba 64 / 32 of each, mamba2 128
    / 64 ``ssd_scan``, moonshot 4 / 2, whisper 144 / 72 ``flash_attn``),
    step time, tokens/s, peak memory and (hymba, mamba2) model FLOP share;
    and the gradients of hymba's and mamba2's ``loss_fn`` on f32 copies cut
    to 2 layers through the kernels against the plain versions, each leaf
    in the norm (the elementwise reading and a reference with the SSD
    backward in f64 printed beside), with dB not summed over the heads
    planted in the backward.

Run from the root of a checkout: ``python3 chip_smoke.py``. It prints
the card, the build, each phase's checks and times, a ``{"kernels":
[...]}`` line, and as its last line ``{"ok": true, "device": {...}}``.
It exits non-zero, without that line, when a phase fails, when torch
sees no CUDA device, or when the repo's sources are missing.
``--report PATH`` also writes every measured number as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
N_STORES = 50_000
#: Tiles of the mega-grid at N_STORES: 1 350 lanes per SB group in
#: 160-lane tiles, as the JAX package's plan_tiles gives them.
MEGA_TILES = 18
#: (newest_ts, downtime total_ns) of every check of run_fault_scenario over
#: enumerate_fault_scenarios(), from the JAX package on the CPU: a single
#: failure at step s gives (s, JAX_FAULT_DOWNTIME_NS[s]).
JAX_FAULT_DOWNTIME_NS = {1: 50508.9, 2: 50524.9, 3: 50524.9, 4: 50524.9}
JAX_DOUBLE_FAILURE = ((1, 50508.9), (4, 50500.9))
#: The paper-width run: Table II's cluster and the SS VI YCSB store laid
#: out as YCSB CoreWorkload's default record (10 fields of 100 bytes).
PAPER_NODES = 16
YCSB_RECORDS = 500_000
YCSB_FIELDS = 10
FIELD_WORDS = 25                 # 100 bytes of f32 words
PAPER_STEPS = 10
PAPER_FAILURES = {6: 5, 8: 11}   # step -> failed node
UPDATES_PER_FIELD = 5_000        # 50 000 field updates (10% of records)
SEED = 0
H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12       # f32 outside the tensor cores
OPS_PER_LANE_STORE = 6           # 2 max, 2 add, 2 compares per store
#: store_timeline's f32 operations per lane-store, by rule: the retire
#: max, its census compare, max(r, last) and the add; baseline's coh + tr,
#: parallel's max(coh, tr); proactive's two adds, two maxes and compare
TIMELINE_OPS_PER_STORE = {"wb": 4, "wt": 4, "baseline": 5, "parallel": 5,
                          "proactive": 9}
#: bytes of input a store_timeline lane reads per store, by rule: wb and
#: wt the arrivals (f32); baseline and parallel also coalesce (bool),
#: exposed and t_repl_i (f32); proactive also svc_i (f32)
TIMELINE_BYTES_PER_STORE = {"wb": 4, "wt": 4, "baseline": 13,
                            "parallel": 13, "proactive": 17}
#: the serial chain of the scan: c_i needs c_{i-1} through one f32 add and
#: one max, each ~4 cycles of dependent-issue latency on Hopper's f32 pipe
CHAIN_OPS_PER_STORE = 2
CHAIN_OP_CYCLES = 4
#: geomean_slowdowns(slowdown_table(n_stores=50_000)) of the JAX package
#: on the CPU: the port must give these exact values.
JAX_GEOMEANS_50K = {"wt": 7.800868352151868,
                    "baseline": 2.7793430928059646,
                    "parallel": 2.7555289788601542,
                    "proactive": 1.2559832132009918}
TOLERANCE = "== (max_abs_err 0.0): the scans are IEEE add and max only"
#: The scenario service of phases 13-14: logical shards and stream size.
SERVE_SHARDS = 4
SERVE_QUERIES = 500
LC_TOLERANCE = ("== on codes, scales and words (max_abs_err 0.0): IEEE "
                "round-to-nearest intrinsics, no FMA, no -ftz")


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)
    print(f"  ok  {what}")


def fields(r) -> tuple:
    return tuple(getattr(r, f.name) for f in dataclasses.fields(r)
                 if f.name != "meta")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card, from CUDA events, after
    one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def scan_bound_ms(n_stores: int, trace_idx, wv_idx) -> tuple:
    """Least time for one launch: unique rows read once (arrivals 4 B,
    w + v + p 9 B per store), indices and outputs; against the f32
    operations of every lane-store. Returns ``(ms, "bytes"|"operations")``."""
    lanes = len(trace_idx)
    nbytes = (len(set(trace_idx.tolist())) * 4 * n_stores
              + len(set(wv_idx.tolist())) * 9 * n_stores
              + lanes * (8 + 12))
    ops = OPS_PER_LANE_STORE * lanes * n_stores
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sm_clock_mhz(torch, fn) -> float:
    """The SM clock (MHz) that ``nvidia-smi --query-gpu=clocks.sm`` reads
    while ``fn()`` runs back to back on the card."""
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm",
                             "--format=csv,noheader,nounits"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    t0 = time.perf_counter()
    while proc.poll() is None and time.perf_counter() - t0 < 60:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    out, err = proc.communicate(timeout=60)
    if proc.returncode != 0:
        raise SmokeFailure(f"nvidia-smi clocks.sm failed: {err.strip()}")
    return float(out.strip().splitlines()[0])


def chain_floor_ms(n_stores: int, sm_mhz: float) -> float:
    """Least time of the scan's serial chain: n_stores x 2 dependent f32
    operations (add, max) x their latency, at the measured SM clock."""
    return n_stores * CHAIN_OPS_PER_STORE * CHAIN_OP_CYCLES / sm_mhz * 1e-3


def rings_used(op, fn):
    """Run ``fn()`` and return the ring instantiations of kernel op
    ``op`` (``bank_scan`` or ``store_timeline``) whose launch count
    moved."""
    before = dict(op.launches_by_ring)
    out = fn()
    return out, sorted(r for r, n in op.launches_by_ring.items()
                       if n != before[r])


def jax_fault_checks(name: str) -> tuple:
    """The JAX package's (newest_ts, downtime_ns) checks of one
    enumerated fault scenario."""
    if name.endswith("/double-failure"):
        return JAX_DOUBLE_FAILURE
    step = int(name.rsplit("@s", 1)[1])
    return ((step, JAX_FAULT_DOWNTIME_NS[step]),)


def compress_bound_ms(n_words: int) -> tuple:
    """Least time for one compress (or decompress) of ``n_words``
    padded words: 9 B per word (two f32 read and an int8 written, or an
    int8 and an f32 read and an f32 written) and 4 B of scale per
    256-word block, against ~10 f32 operations per word."""
    nbytes = 9 * n_words + 4 * (n_words // 256)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = 10 * n_words / H100_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def phase_build(libraries) -> dict:
    print("phase 1: build every kernel with nvcc for sm_90a, one nvcc per "
          "source, started together")
    t0 = time.perf_counter()
    # map re-raises the first build's error; the pool waits for every build
    with ThreadPoolExecutor(len(libraries)) as pool:
        list(pool.map(lambda lib: lib.load(), libraries))
    secs = time.perf_counter() - t0
    out = {"build_s": secs}
    for lib in libraries:
        path, nvcc_s, log = lib.last_build
        print(f"build: {path.name} (nvcc {nvcc_s:.3f} s)")
        ptxas = [line.strip() for line in log.splitlines()
                 if "Compiling entry" in line or "registers" in line
                 or "spill" in line or "smem" in line]
        for line in ptxas:
            print(f"  ptxas: {line}")
        out[f"nvcc_s/{lib.name}"] = nvcc_s
        out[f"ptxas/{lib.name}"] = ptxas
    print(f"  all built and loaded in {secs:.3f} s")
    return out


def ptxas_spills(log: str) -> dict:
    """``{function: (spill store bytes, spill load bytes)}`` of each
    function a ``ptxas -v`` log reports."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name is not None:
            out[name] = (int(m.group(1)), int(m.group(2)))
            name = None
    return out


def ptxas_log(lib) -> str:
    """The ``ptxas -v`` log of ``lib``: its build's or, when the library
    was built before this run, that of a compile of the same source and
    flags into a throwaway file."""
    log = lib.last_build[2]
    if log:
        return log
    from repro_torch.kernels import nvcc
    tmp = nvcc.BUILD_DIR / f"ptxas-{lib.name}-{os.getpid()}.so"
    try:
        proc = subprocess.run([nvcc.nvcc(), *nvcc.NVCC_FLAGS, "-o",
                               str(tmp), str(lib.source)],
                              capture_output=True, text=True, timeout=600)
    finally:
        tmp.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise SmokeFailure(f"nvcc failed on {lib.source}: {proc.stderr}")
    return proc.stdout + proc.stderr


def check_no_spills(lib, kernel: str, count: int,
                    most: tuple = (0, 0)) -> None:
    """ptxas compiled ``count`` instantiations of ``kernel`` in ``lib``,
    none with more than ``most`` (spill store, spill load) bytes: by
    default none with a byte."""
    log = ptxas_log(lib)
    entries = [e for e in re.findall(r"Compiling entry function '([^']+)'",
                                     log) if kernel in e]
    spills = ptxas_spills(log)
    check(len(entries) == count,
          f"{lib.name}: ptxas compiled {len(entries)} instantiations of "
          f"{kernel}, {count} expected")
    bad = {e: spills.get(e) for e in entries
           if spills.get(e) is None
           or any(n > m for n, m in zip(spills[e], most))}
    check(not bad, f"{lib.name}: at most {most[0]} / {most[1]} bytes of "
          f"spill stores / loads in each of them"
          + (f" (spills: {bad})" if bad else ""))


def phase_kernel_vs_plain(torch, S, Sc, ops, ref) -> float:
    print("phase 2: kernel against the plain version on the card")
    dev = torch.device(DEVICE)
    specs = Sc.sweep_grid(workloads=("ycsb", "canneal", "raytrace", "barnes"))
    max_err = 0.0
    for n in (2003, 1):
        bank = S.get_trace_bank(specs, n, S.PAPER_CLUSTER)
        rows = [bank.rows_for(s) for s in specs]
        # padded lanes repeat lane 0, as the engines pad their tiles
        rows += [rows[0]] * (-len(rows) % 32 + 3)
        tr = torch.tensor([r[0] for r in rows], dtype=torch.int32,
                          device=dev)
        wv = torch.tensor([r[1] for r in rows], dtype=torch.int32,
                          device=dev)
        _, cols = bank.device_args(device=dev)
        _, sub = bank.sub_device_args(1, device=dev)
        sub_view = (sub[0], sub[1][0], sub[2][0], sub[3][0])
        for sb in (1, 7, 24, 48, 72, 200, 500):
            for name, banks in (("columns", cols), ("sub[0]", sub_view)):
                got, rings = rings_used(ops.bank_scan, lambda: ops.bank_scan(
                    *banks, tr, wv, chunk=sb, sb=sb))
                want = ref.bank_scan_ref(*banks, tr, wv, chunk=sb, sb=sb)
                torch.cuda.synchronize()
                same = all(torch.equal(g, w) for g, w in zip(got, want))
                err = float((got[0] - want[0]).abs().max())
                max_err = max(max_err, err)
                check(same, f"n={n} sb={sb} {name} lanes={len(rows)}, "
                      f"{'/'.join(rings)} ring: kernel == plain "
                      f"(max_abs_err {err})")
                if sb in (48, 72):
                    check(rings == ["register"], f"sb={sb} ran on the "
                          f"register ring")
        if n > 1:
            max_err = max(max_err, check_multi_shard(torch, S, ops, ref, bank,
                                                     specs, cols))
    check_bad_index(torch, ops, cols)
    return max_err


def check_multi_shard(torch, S, ops, ref, bank, specs, cols) -> float:
    """The kernel on a logical-shard sub-bank as the sharded tiers place
    it: a 4-shard, k_replicas = 2 stack, contiguous on the card, whose
    replica blocks and capacity tail are NaN, gathered through flat rows
    ``owner * k * cap + local`` by lanes of every shard. ``==`` the plain
    version on the same stack and on the plain columns, NaN-free: a
    gather from the wrong block or the tail would show."""
    import numpy as np
    n_shards, k = 4, 2
    n = bank.n_stores
    cap = S.sub_bank_rows(bank.wv_rows, n_shards) + 5     # capacity tail
    stacks = []
    for col in (bank.w, bank.v, bank.pr_nc):
        out = np.zeros((n_shards, k * cap, n), col.dtype)
        if col.dtype != bool:
            out[:] = np.nan
        for s in range(n_shards):
            rows = col[s::n_shards]
            out[s, :rows.shape[0]] = rows
        stacks.append(torch.from_numpy(out).to(DEVICE).view(-1, n))
    rows = [bank.rows_for(s) for s in specs]
    check({r[1] % n_shards for r in rows} == set(range(n_shards)),
          f"lanes of all {n_shards} shards")
    tr = torch.tensor([r[0] for r in rows], dtype=torch.int32, device=DEVICE)
    flat = torch.tensor([(r[1] % n_shards) * k * cap + r[1] // n_shards
                         for r in rows], dtype=torch.int32, device=DEVICE)
    wv = torch.tensor([r[1] for r in rows], dtype=torch.int32, device=DEVICE)
    max_err = 0.0
    for sb in (48, 72, 200):
        got, rings = rings_used(ops.bank_scan, lambda: ops.bank_scan(
            cols[0], *stacks, tr, flat, chunk=sb, sb=sb))
        same_stack = ref.bank_scan_ref(cols[0], *stacks, tr, flat, chunk=sb,
                                       sb=sb)
        plain = ref.bank_scan_ref(*cols, tr, wv, chunk=sb, sb=sb)
        torch.cuda.synchronize()
        err = float((got[0] - plain[0]).abs().max())
        max_err = max(max_err, err)
        check(not bool(torch.isnan(got[0]).any())
              and all(torch.equal(g, w) for g, w in zip(got, same_stack))
              and all(torch.equal(g, w) for g, w in zip(got, plain)),
              f"n={n} sb={sb} {n_shards}-shard k={k} stack (NaN replica "
              f"blocks and tail), {len(rows)} lanes, {'/'.join(rings)} ring: "
              f"kernel == plain on the stack and on the columns "
              f"(max_abs_err {err})")
    return max_err


def check_bad_index(torch, ops, cols) -> None:
    bad = torch.tensor([0, 10**6], dtype=torch.int32, device=cols[0].device)
    c, ah, sf = ops.bank_scan(*cols, bad, bad.clone(), chunk=1, sb=1)
    check(bool(torch.isnan(c[1])) and int(ah[1]) == -1
          and int(sf[1]) == -1 and not bool(torch.isnan(c[0])),
          "an out-of-range row index gives NaN / -1, not a fault")


def phase_fig10(torch, S, E, Sc, C, ops, ref) -> dict:
    print("phase 3: Fig. 10 grid at n_stores=50 000 (blocked tier)")
    specs = Sc.fig10_grid()
    ops.bank_scan.launches = 0
    t0 = time.perf_counter()
    res = Sc.run_sweep(specs, n_stores=N_STORES)
    cold_s = time.perf_counter() - t0
    launches = ops.bank_scan.launches
    check(launches == 1, f"one bank_scan launch on the blocked tier "
          f"(counted {launches})")
    check(all(r.meta["engine"] == "blocked" for r in res),
          "every cell ran on the blocked tier")
    t0 = time.perf_counter()
    warm = Sc.run_sweep(specs, n_stores=N_STORES)
    warm_s = time.perf_counter() - t0
    check([fields(r) for r in warm] == [fields(r) for r in res],
          "warm run == cold run")

    # every lane against the plain version on CPU tensors of the bank
    (_, _, n_lanes, tr, wv, sb_arr, _, _, _) = S._banked_inputs(
        tuple(specs), N_STORES, S.PAPER_CLUSTER)
    bank = Sc.grid_bank(specs, n_stores=N_STORES)
    sb = int(sb_arr[0])
    check(bool((sb_arr == sb).all()), f"uniform SB {sb} over "
          f"{len(tr)} padded lanes ({n_lanes} real)")
    _, cpu_cols = bank.device_args(device="cpu")
    _, dev_cols = bank.device_args()
    tr_c, wv_c = torch.from_numpy(tr), torch.from_numpy(wv)
    chunk = res[0].meta["chunk"]
    want = ref.bank_scan_ref(*cpu_cols, tr_c, wv_c, chunk=chunk, sb=sb)
    tr_d, wv_d = tr_c.to(DEVICE), wv_c.to(DEVICE)
    got = [x.cpu() for x in ops.bank_scan(*dev_cols, tr_d, wv_d,
                                          chunk=chunk, sb=sb)]
    err = float((got[0] - want[0]).abs().max())
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"all {len(tr)} lanes: kernel on the card == plain version on "
          f"CPU (max_abs_err {err})")
    cpu_res = Sc.run_sweep(specs, n_stores=N_STORES, device="cpu")
    check([fields(r) for r in cpu_res] == [fields(r) for r in res],
          "every SimResult field == the CPU run of the plain version")
    for spec in (specs[4], specs[17], specs[42]):
        t0 = time.perf_counter()
        o = C.serial_oracle(spec, n_stores=N_STORES)
        i = specs.index(spec)
        check(fields(o) == fields(res[i]),
              f"{spec.workload}/{spec.config} == serial per-store oracle "
              f"({time.perf_counter() - t0:.1f} s)")

    table = S.slowdowns_from_results(res)
    gm = S.geomean_slowdowns(table)
    print("  slowdown vs WB:")
    for w, row in table.items():
        print(f"    {w:14s} " + " ".join(f"{c}={row[c]:.4f}" for c in
                                          S.CONFIGS))
    print(f"  geomeans: {json.dumps(gm)}")
    check(6.0 <= gm["wt"] <= 9.5, "wt geomean in [6.0, 9.5]")
    check(2.3 <= gm["baseline"] <= 3.5, "baseline geomean in [2.3, 3.5]")
    check(1.1 <= gm["proactive"] <= 1.55, "proactive geomean in [1.1, 1.55]")
    check(0.0 <= 1.0 - gm["parallel"] / gm["baseline"] <= 0.10,
          "parallel within 10% below baseline")
    check(all(row["proactive"] <= row["parallel"] * 1.02
              and row["parallel"] <= row["baseline"] * 1.001
              and row["baseline"] <= row["wt"] * 1.001
              for row in table.values()), "per-workload ordering")
    check(all(gm[c] == v for c, v in JAX_GEOMEANS_50K.items()),
          "geomeans == the JAX package's at 50 000 stores")

    def launch():
        return ops.bank_scan(*dev_cols, tr_d, wv_d, chunk=chunk, sb=sb)

    kernel_ms = cuda_ms(launch, 10)
    sm_mhz = sm_clock_mhz(torch, launch)
    t0 = time.perf_counter()
    ref.bank_scan_ref(*dev_cols, tr_d, wv_d, chunk=chunk, sb=sb)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    bound_ms, bound_by = scan_bound_ms(N_STORES, tr, wv)
    floor_ms = chain_floor_ms(N_STORES, sm_mhz)
    print(f"  wall: cold {cold_s:.3f} s, warm {warm_s:.3f} s")
    print(f"  kernel {kernel_ms:.4f} ms for {len(tr)} lanes (CUDA events, "
          f"mean of 10); plain version on the card {plain_ms:.1f} ms; "
          f"bound {bound_ms:.5f} ms ({bound_by}); chain floor "
          f"{floor_ms:.4f} ms ({N_STORES} stores x {CHAIN_OPS_PER_STORE} "
          f"dependent f32 ops x {CHAIN_OP_CYCLES} cycles at clocks.sm "
          f"{sm_mhz:.0f} MHz, read during the launches)")
    return {"launches": launches, "cold_s": cold_s, "warm_s": warm_s,
            "lanes": len(tr), "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "chain_floor_ms": floor_ms, "sm_mhz": sm_mhz,
            "max_abs_err": err, "geomeans": gm}


def phase_mega(torch, S, E, Sc, T, ops, ref) -> dict:
    print("phase 4: mega-grid at n_stores=50 000 (stream tier)")
    import numpy as np
    specs = Sc.mega_grid()
    ops.bank_scan.launches = 0
    with T.recording() as rec:
        t0 = time.perf_counter()
        res = Sc.run_sweep(specs, n_stores=N_STORES)
        wall_s = time.perf_counter() - t0
    launches = ops.bank_scan.launches
    stats = E.bank_stats()
    summ = stats.pop("telemetry")
    print(f"  wall {wall_s:.3f} s; bank_stats: {json.dumps(stats)}")
    check(stats["trace_rows"] == 27 and stats["wv_rows"] == 1298,
          "bank holds 27 + 1 298 rows")
    check(stats["scan_lanes"] == 2700, "2 700 scan lanes")
    check(stats["tiles"] == MEGA_TILES,
          f"{MEGA_TILES} tiles (got {stats['tiles']})")
    check(launches == stats["tiles"],
          f"one launch per tile ({launches} launches)")
    tile_lanes = -(-E._default_tile_cells(N_STORES) // 8) * 8
    check(all(r.meta["engine"] == "streamed"
              and r.meta["tile_cells"] == tile_lanes for r in res),
          f"every cell streamed in {tile_lanes}-lane tiles")

    # the lanes, in the engine's order, and the tiles over them
    lane_of, lanes = {}, []
    for i, s in enumerate(specs):
        sb = s.sb_size if s.sb_size is not None else 72
        key = (sb,) + S._plane_keys(s, S.PAPER_CLUSTER)
        if key not in lane_of:
            lane_of[key] = len(lanes)
            lanes.append(i)
    bank = Sc.grid_bank(specs, n_stores=N_STORES)
    _, cpu_cols = bank.device_args(device="cpu")
    rng = np.random.default_rng(0)
    max_err = 0.0
    for sb in (72, 48):
        group = [i for i in lanes if specs[i].sb_size == sb]
        pick = sorted(rng.choice(len(group), 32, replace=False))
        idx = [group[j] for j in pick]
        rows = [bank.rows_for(specs[i]) for i in idx]
        tr = torch.tensor([r[0] for r in rows], dtype=torch.int32)
        wv = torch.tensor([r[1] for r in rows], dtype=torch.int32)
        c, ah, sf = ref.bank_scan_ref(*cpu_cols, tr, wv, chunk=sb, sb=sb)
        for j, i in enumerate(idx):
            cell = S._prepare_cell(specs[i], S._trace_cached(
                specs[i].workload, N_STORES, specs[i].seed,
                S.PAPER_CLUSTER), N_STORES, S.PAPER_CLUSTER)
            want = S._finish_result(cell, c.numpy()[j], int(ah[j]),
                                    int(sf[j]))
            max_err = max(max_err, abs(want.exec_time_ns
                                       - res[i].exec_time_ns))
            if fields(want) != fields(res[i]):
                raise SmokeFailure(f"lane of cell {i} (sb={sb}) differs "
                                   f"from the plain version")
        print(f"  ok  32 sampled sb={sb} lanes == plain version on CPU")

    spans = summ["spans"]
    split = {k: spans.get(k, {}).get("total", 0.0) for k in
             ("bank/build", "bank/place", "tile/prep", "tile/h2d",
              "tile/dispatch", "tile/drain")}
    print(f"  telemetry (ms, spans; tile/prep runs on the prefetch "
          f"thread): {json.dumps(split)}")

    # per-tile kernel time (CUDA events) against its bound
    _, sub = bank.sub_device_args(1)
    sub_view = (sub[0], sub[1][0], sub[2][0], sub[3][0])
    lane_specs = [specs[i] for i in lanes]
    tiles = E.plan_tiles(lane_specs, n_stores=N_STORES,
                         tile_cells=E._default_tile_cells(N_STORES),
                         small_pad=False)
    check(len(tiles) == MEGA_TILES, "the engine's tiles, re-planned")
    per_tile = []
    for tile in tiles:
        tr = np.zeros(tile.sig.b_pad, np.int32)
        wv = np.zeros(tile.sig.b_pad, np.int32)
        for pos, s in enumerate(tile.specs):
            tr[pos], wv[pos] = bank.rows_for(s)
        tr_d = torch.from_numpy(tr).to(DEVICE)
        wv_d = torch.from_numpy(wv).to(DEVICE)
        ms = cuda_ms(lambda: ops.bank_scan(*sub_view, tr_d, wv_d,
                                           chunk=tile.sig.chunk,
                                           sb=tile.sig.sb_uniform), 3)
        bound, by = scan_bound_ms(N_STORES, tr, wv)
        per_tile.append((ms, bound, by))
    kernel_total = sum(t[0] for t in per_tile)
    ms_mean = kernel_total / len(per_tile)
    bound_mean = sum(t[1] for t in per_tile) / len(per_tile)
    sm_mhz = sm_clock_mhz(torch, lambda: ops.bank_scan(
        *sub_view, tr_d, wv_d, chunk=tile.sig.chunk,
        sb=tile.sig.sb_uniform))
    floor_ms = chain_floor_ms(N_STORES, sm_mhz)
    print(f"  per tile: kernel {ms_mean:.4f} ms mean (min "
          f"{min(t[0] for t in per_tile):.4f}, max "
          f"{max(t[0] for t in per_tile):.4f}), bound {bound_mean:.5f} ms "
          f"({per_tile[0][2]}), chain floor {floor_ms:.4f} ms (clocks.sm "
          f"{sm_mhz:.0f} MHz during the launches); kernel total "
          f"{kernel_total:.2f} ms of {wall_s * 1e3:.1f} ms wall")
    t0 = time.perf_counter()
    ref.bank_scan_ref(*sub_view, tr_d, wv_d, chunk=tile.sig.chunk,
                      sb=tile.sig.sb_uniform)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    print(f"  plain version on the card, one tile: {plain_ms:.1f} ms")
    return {"results": res,
            "launches": launches, "wall_s": wall_s, "bank_stats": stats,
            "telemetry_ms": split, "tile_kernel_ms": [t[0] for t in per_tile],
            "tile_bound_ms": [t[1] for t in per_tile], "kernel_ms": ms_mean,
            "kernel_total_ms": kernel_total, "bound_ms": bound_mean,
            "bound_by": per_tile[0][2], "chain_floor_ms": floor_ms,
            "sm_mhz": sm_mhz, "plain_ms": plain_ms, "max_abs_err": max_err}


def phase_compress_vs_plain(torch, lc, lc_ref) -> float:
    print("phase 5: compress / decompress kernels against the plain "
          "version on the card")
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    max_err = 0.0
    for n in (1, 256, 12345, 1 << 20):
        for bits in (8, 4):
            for kind in ("dense", "zero-rows", "subnormal"):
                v = torch.randn(n, generator=gen, device=dev)
                b = v + torch.randn(n, generator=gen, device=dev) * 0.02
                if kind == "zero-rows":          # every other row unchanged
                    rows = b[:n // 256 * 256].view(-1, 256)
                    rows[::2] = v[:n // 256 * 256].view(-1, 256)[::2]
                    b[n // 256 * 256:] = v[n // 256 * 256:]
                elif kind == "subnormal":
                    b = v * 1e-39
                    v = b + torch.randn(n, generator=gen, device=dev) * 1e-41
                err = compare_compress(torch, lc, lc_ref, v, b, bits,
                                       f"n={n} bits={bits} {kind}")
                max_err = max(max_err, err)
    v = torch.full((3000,), 1e-40, device=dev)
    codes, scales = lc.compress(v, v)
    rec = lc.decompress(codes, scales, v, 3000)
    check(torch.equal(rec, v) and float(rec[0]) != 0.0,
          "subnormal v: decompress(compress(v, v)) == v")
    check_nan_word(torch, lc, torch.randn(4096, generator=gen, device=dev))
    return max_err


def check_nan_word(torch, lc, v) -> None:
    """Non-finite input is outside the kernel's contract; a NaN word must
    neither fault nor hang, and gets the code its source documents."""
    v[5] = float("nan")
    codes, scales = lc.compress(v, torch.zeros_like(v))
    torch.cuda.synchronize()
    check(int(codes.reshape(-1)[5]) == -127
          and bool(torch.isfinite(scales).all()),
          "a NaN word gives code -qmax and finite scales, no fault")


def compare_compress(torch, lc, lc_ref, v, b, bits, what) -> float:
    """Kernel against the plain version on the same card tensors; ``==``
    on codes, scales and decompressed words. Returns max_abs_err."""
    n = v.numel()
    codes, scales = lc.compress(v, b, bits=bits)
    rec = lc.decompress(codes, scales, b, n)
    v2, _ = lc.ops._pad_to_blocks(v.reshape(-1).float(), lc.ops.BLOCK)
    b2, _ = lc.ops._pad_to_blocks(b.reshape(-1).float(), lc.ops.BLOCK)
    want_c, want_s = lc_ref.compress_ref(v2, b2, bits=bits)
    want_r = lc_ref.decompress_ref(want_c, want_s, b2).reshape(-1)[:n]
    torch.cuda.synchronize()
    err = float((rec - want_r).abs().max())
    same = (torch.equal(codes, want_c) and torch.equal(scales, want_s)
            and torch.equal(rec, want_r))
    check(same, f"{what}: kernel == plain (max_abs_err {err}, "
          f"{int((codes != want_c).sum())} codes and "
          f"{int((scales != want_s).sum())} scales differ)")
    return err


def phase_fault_scenarios(Sc) -> dict:
    print("phase 6: the 51 enumerated fault scenarios on the card")
    t0 = time.perf_counter()
    scns = Sc.enumerate_fault_scenarios()
    n_checks = 0
    for scn in scns:
        out = Sc.run_fault_scenario(scn)
        got = tuple((c.newest_ts, c.downtime_ns) for c in out.checks)
        if not out.all_invariants_hold:
            raise SmokeFailure(f"{scn.name}: an invariant fails")
        if got != jax_fault_checks(scn.name):
            raise SmokeFailure(f"{scn.name}: checks {got} != the JAX "
                               f"package's {jax_fault_checks(scn.name)}")
        n_checks += len(got)
    secs = time.perf_counter() - t0
    check(len(scns) == 51, f"{len(scns)} scenarios, {n_checks} recoveries: "
          f"every invariant holds, newest_ts and downtime == the JAX "
          f"package's ({secs:.2f} s)")
    return {"scenarios": len(scns), "recoveries": n_checks, "wall_s": secs}


def ycsb_update(torch, fields, gen) -> None:
    """One step of YCSB updates: in each field, a seeded set of records
    is rewritten with new values (UPDATES_PER_FIELD per field)."""
    for f in fields:
        rows = torch.randint(0, YCSB_RECORDS, (UPDATES_PER_FIELD,),
                             generator=gen, device=f.device)
        f[rows] = torch.rand((UPDATES_PER_FIELD, FIELD_WORDS), generator=gen,
                             device=f.device)


def phase_paper_width(torch, lc, lc_ref) -> dict:
    print(f"phase 7: paper width -- {PAPER_NODES} CNs, N_r = 3, the YCSB "
          f"store of {YCSB_RECORDS} records x {YCSB_FIELDS} fields")
    from repro_torch.config import ReplicationConfig
    from repro_torch.core.recovery import reassemble_shard, recover_node
    from repro_torch.core.replication import ReplicationEngine
    from repro_torch.core.scenarios import estimate_scenario_downtime
    from repro_torch.distributed.context import P, make_context

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    store = torch.rand((YCSB_FIELDS, YCSB_RECORDS, FIELD_WORDS),
                       generator=gen, device=dev)
    base = store.clone()                 # the last dump: the step-0 state
    state = {f"field{i}": store[i] for i in range(YCSB_FIELDS)}
    specs = {k: P("data", None) for k in state}
    ctx = make_context((PAPER_NODES,), ("data",))
    engine = ReplicationEngine(ReplicationConfig(log_dtype="float32"), ctx,
                               specs, state)
    lay = engine.layout
    rows = YCSB_RECORDS // PAPER_NODES
    # 10 equal leaves in 8 buckets: at most two leaves per bucket
    check(lay.n_buckets == 8 and lay.bucket_len == 2 * rows * FIELD_WORDS,
          f"layout: {lay.n_buckets} buckets of {lay.bucket_len} words")
    logs = engine.init_logs()
    ring_bytes = sum(t.numel() * t.element_size() for t in logs.values())
    check(logs["values"].numel() * 4
          == PAPER_NODES * 3 * 8 * 8 * lay.bucket_len * 4,
          f"log ring {ring_bytes} bytes on the card "
          f"({tuple(logs['values'].shape)} f32 values + ts + valid)")
    # the engine coalesces, so the directory names its actual targets
    directory = engine.shard_directory()
    lc.compress.launches = lc.decompress.launches = 0
    update_ms, step_ms, recoveries = [], [], []
    torch.cuda.synchronize()
    t_loop = time.perf_counter()
    for t in range(PAPER_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        ycsb_update(torch, list(state.values()), gen)
        ev[1].record()
        logs, state = engine.replicate(state, logs, t, state)
        ev[2].record()
        torch.cuda.synchronize()
        update_ms.append(ev[0].elapsed_time(ev[1]))
        step_ms.append(ev[1].elapsed_time(ev[2]))
        if t < min(PAPER_FAILURES):
            directory.record_commit(t)
        if t not in PAPER_FAILURES:
            continue
        node = PAPER_FAILURES[t]
        t0 = time.perf_counter()
        res = recover_node(engine, logs, directory, failed_coord=(node,))
        got = engine.unflatten(reassemble_shard(engine, res)[0])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        exact = res.stats.unrecoverable == 0 and all(
            torch.equal(got[k], v[rows * node:rows * (node + 1)])
            for k, v in state.items())
        newest = max(s.ts for s in res.shards.values())
        n_versions = sum(m[1].get("n_versions", 0) for m in res.message_log)
        est = estimate_scenario_downtime(engine, res)
        check(exact and newest == t,
              f"node {node} failed at step {t}: {len(res.shards)} buckets "
              f"recovered == the truth, newest ts {newest}, "
              f"{n_versions} versions walked; recover + reassemble "
              f"{wall_ms:.3f} ms wall; SS VII-E downtime estimate "
              f"{est.total_ms:.4f} ms")
        recoveries.append({"step": t, "node": node, "wall_ms": wall_ms,
                           "n_versions": n_versions,
                           "downtime_ms": est.total_ms})
    loop_ms = (time.perf_counter() - t_loop) * 1e3
    rec_ms = sum(r["wall_ms"] for r in recoveries)
    print(f"  replicate: {json.dumps([round(x, 4) for x in step_ms])} ms "
          f"per step (CUDA events); mean of steps 1-9 "
          f"{sum(step_ms[1:]) / (len(step_ms) - 1):.4f} ms")
    print(f"  10-step loop {loop_ms:.2f} ms wall: replicate "
          f"{sum(step_ms):.2f} ms, YCSB updates {sum(update_ms):.2f} ms "
          f"(CUDA events), recoveries {rec_ms:.2f} ms (host clock), rest "
          f"{loop_ms - sum(step_ms) - sum(update_ms) - rec_ms:.2f} ms")

    # the log dump: the 500 MB state against its base, through the kernels
    values, flat_base = store.reshape(-1), base.reshape(-1)
    n = values.numel()
    dumps = {}
    for bits in (8, 4):
        codes, scales = lc.compress(values, flat_base, bits=bits)
        rec = lc.decompress(codes, scales, flat_base, n)
        dumps[bits] = (codes, scales, rec)
    launches = (lc.compress.launches, lc.decompress.launches)
    check(launches == (2, 2), f"the dump launched compress {launches[0]} "
          f"and decompress {launches[1]} times")
    out = {"ring_bytes": ring_bytes, "step_ms": step_ms,
           "update_ms": update_ms, "loop_ms": loop_ms,
           "recoveries": recoveries, "launches": launches, "dump": {}}
    for bits, (codes, scales, rec) in dumps.items():
        v2 = values.view(-1)
        err_rows = block_max(lc, (rec - v2).abs())
        ok = bool((err_rows <= scales[:, 0] * 0.51).all())
        stored = codes.numel() * codes.element_size() + scales.numel() * 4
        factor = n * 4 / stored
        check(ok, f"bits={bits}: round-trip error <= 0.51 x scale in every "
              f"block; stored {stored} B for {n * 4} B: {factor:.4f}x "
              f"(compression_factor {lc.compression_factor(bits):.4f}x)")
        out["dump"][bits] = {"stored_bytes": stored, "factor": factor}
    out["max_abs_err"] = max(
        compare_compress(torch, lc, lc_ref, values, flat_base, bits,
                         f"paper-width state, bits={bits}")
        for bits in (8, 4))

    # times of one launch at this width, against the plain version
    v2, _ = lc.ops._pad_to_blocks(values, lc.ops.BLOCK)
    b2, _ = lc.ops._pad_to_blocks(flat_base, lc.ops.BLOCK)
    codes, scales, _ = dumps[8]
    kernel = lc.ops.kernel
    out["compress_ms"] = cuda_ms(lambda: kernel.launch_compress(v2, b2, 8), 10)
    out["decompress_ms"] = cuda_ms(
        lambda: kernel.launch_decompress(codes, scales, b2), 10)
    out["compress_plain_ms"] = cuda_ms(lambda: lc_ref.compress_ref(v2, b2), 3)
    out["decompress_plain_ms"] = cuda_ms(
        lambda: lc_ref.decompress_ref(codes, scales, b2), 3)
    # torch.addcmul takes the int8 codes (type promotion to f32)
    out["decompress_library_ms"] = cuda_ms(
        lambda: torch.addcmul(b2, codes, scales), 3)
    out["bound_ms"], out["bound_by"] = compress_bound_ms(v2.numel())
    # the dump as a caller sees it: the public ops on the flat state, which
    # pad values and base to whole tiles before the launch
    out["compress_op_ms"] = cuda_ms(lambda: lc.compress(values, flat_base),
                                    10)
    out["decompress_op_ms"] = cuda_ms(
        lambda: lc.decompress(codes, scales, flat_base, n), 10)
    print(f"  compress {out['compress_ms']:.4f} ms, decompress "
          f"{out['decompress_ms']:.4f} ms for {v2.numel()} words (kernel "
          f"launch on padded rows; CUDA events, mean of 10); through the "
          f"public ops, padding included: {out['compress_op_ms']:.4f} / "
          f"{out['decompress_op_ms']:.4f} ms; plain "
          f"{out['compress_plain_ms']:.4f} / "
          f"{out['decompress_plain_ms']:.4f} ms; torch.addcmul "
          f"{out['decompress_library_ms']:.4f} ms; bound "
          f"{out['bound_ms']:.5f} ms ({out['bound_by']})")
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    print(f"  peak device memory {out['peak_bytes']} bytes")
    return out


def block_max(lc, err):
    """Per-256-word-block max of ``err`` (padded with zeros)."""
    rows, _ = lc.ops._pad_to_blocks(err, lc.ops.BLOCK)
    return rows.amax(dim=1)


#: tests/test_kernels.py's cases: (b, sq, skv, h, kh, d, causal, dtype) and
#: (b, l, h, p, n, chunk, dtype), plus hymba-1.5b's per-layer shapes; each
#: f32 attention case also in bf16 (the tensor-core kernel), and head dim 16.
ATTN_CASES = [
    (2, 256, 256, 4, 2, 64, True, "float32"),
    (1, 128, 128, 8, 8, 32, True, "float32"),      # MHA
    (1, 128, 128, 8, 1, 64, True, "float32"),      # MQA
    (2, 192, 192, 6, 2, 64, True, "bfloat16"),     # bf16 + unaligned
    (1, 64, 320, 4, 2, 64, True, "float32"),       # kv longer (decode-ish)
    (1, 256, 256, 4, 4, 128, False, "float32"),    # non-causal
]
ATTN_CASES += [c[:7] + ("bfloat16",) for c in ATTN_CASES
               if c[7] == "float32"]
ATTN_CASES.append((1, 128, 128, 4, 2, 16, True, "bfloat16"))   # head dim 16
#: unmasked, Skv not a multiple of the kernel's 64-key tile, Sq != Skv (the
#: cross-attention's form), in both dtypes
ATTN_CASES += [(1, 100, 1500, 16, 16, 64, False, dt)
               for dt in ("float32", "bfloat16")]
ATTN_CASES += [(2, 1500, 1500, 16, 16, 64, False, dt)
               for dt in ("float32", "bfloat16")]
#: per-layer attention shapes timed against SDPA, (name, B, Sq, Skv, H, K,
#: D, causal), in bf16 (the tensor-core kernel); stablelm-12b's also in
#: f32 (the CUDA-core kernel), its head dim 160. All but qwen3-0.6b's
#: are serving shapes whose query rows phase 8 also holds one by one:
#: whisper-medium's encoder, cross- and decoder self-attention at phase
#: 18's batch 8, 1 500 frames and 224-token prompts, and internvl2-26b's
#: at phase 19's batch 4 and 1 024 positions.
ATTN_TIMED = [("hymba-1.5b", 4, 4096, 4096, 25, 5, 64, True),
              ("qwen3-0.6b", 4, 4096, 4096, 16, 8, 128, True),
              ("moonshot-v1-16b-a3b", 4, 2048, 2048, 16, 16, 128, True),
              ("stablelm-12b", 1, 2048, 2048, 32, 8, 160, True),
              ("whisper-medium encoder", 8, 1500, 1500, 16, 16, 64, False),
              ("whisper-medium cross", 8, 224, 1500, 16, 16, 64, False),
              ("whisper-medium decoder", 8, 224, 224, 16, 16, 64, True),
              ("internvl2-26b", 4, 1024, 1024, 48, 8, 128, True)]
ATTN_TIMED_F32 = [("stablelm-12b", 1, 2048, 2048, 32, 8, 160, True)]
SSD_CASES = [
    (2, 128, 4, 16, 32, 32, "float32"),
    (1, 96, 2, 64, 128, 32, "float32"),            # unaligned l
    (2, 64, 3, 32, 16, 64, "float32"),
    (1, 128, 2, 32, 32, 32, "bfloat16"),
]
#: shapes the tensor-core passes must also take, beside hymba's
SSD_MMA_CASES = [
    (2, 512, 4, 64, 128, 256, "bfloat16"),         # mamba2-2.7b's p, n
    (2, 256, 4, 32, 8, 64, "bfloat16"),            # n not a multiple of 16
    (2, 300, 3, 64, 16, 128, "bfloat16"),          # ragged last chunk
]
#: a decay weak enough (A = -0.05) that the state carries across all 16
#: chunks of 256 positions: a fault in passing it reads large here
SSD_WEAK_DECAY = [(1, 4096, 4, 64, 16, 256, dt)
                  for dt in ("bfloat16", "float32")]
SERVE_ARCH = "hymba-1.5b"
SERVE_REDUCED = False            # the published config, full width
SERVE_BATCH = 4                  # the JAX launcher's --batch
SERVE_PROMPT = 4096              # the JAX package's BLOCKWISE_THRESHOLD
SERVE_GEN = 32                   # the JAX launcher's --gen
#: decode steps whose logits are held against a fresh prefill
CONSISTENCY_STEPS = (1, SERVE_GEN - 1)
H100_BF16_OPS_PER_S = 989e12     # dense bf16 tensor-core rate
ATTN_TOLERANCE = ("tests/test_kernels.py's: allclose atol = rtol = 2e-2 in "
                  "bf16, 2e-5 in f32 (summation order, bf16 rounding of p)")
#: at hymba's shape a row's output is ~sqrt(1/n) small, below the absolute
#: 2e-2 above; each query row is also held to its own largest |value|:
#: against an f32 oracle at 2^-6 of it (2 to 4 bf16 ulps of the row's top
#: binade), against the plain version, which rounds its scores to bf16
#: before the softmax, at 2^-5
ATTN_ROW_TOLERANCE = {"f32 oracle": 2.0 ** -6, "plain": 2.0 ** -5}
ATTN_TOLERANCE = ("tests/test_kernels.py's: allclose atol = rtol = 2e-2 in "
                  "bf16, 2e-5 in f32 (summation order, bf16 rounding of p); "
                  "at the serving shapes (hymba's, moonshot's, stablelm's, "
                  "whisper-medium's encoder, cross and decoder, "
                  "internvl2-26b's) also max|err| of each query row within "
                  "2^-6 of that row's max|value| against an f32 oracle, "
                  "2^-5 against the plain version (bf16 scores)")
SSD_TOLERANCE = ("tests/test_kernels.py's: max|y - y_plain| < 3e-2 (bf16) / "
                 "1e-5 (f32) of max|y_plain|; the state held to its own scale "
                 "at the same limit, max|s - s_plain| < 3e-2 / 1e-5 of "
                 "max|s_plain| (the JAX test's absolute 10x limit exceeds a "
                 "bf16 state's whole scale) (cumsum order; in bf16 the "
                 "tensor-core passes round att, x*w, C*exp(seg) and the "
                 "prior state where the plain version does, but keep its "
                 "bf16-rounded S, y_intra and y_inter in f32; the CUDA-core "
                 "kernel keeps all in f32)")
#: bf16 logits of two computation orders over 32 layers, each rounding its
#: branch outputs to bf16 (ulp 2^-8 of the value), held to a share of the
#: largest |logit|: sound comparisons read 1.5-1.9% on the H100, the gated
#: planted faults of phase 9 6.2% and more
LOGIT_TOLERANCE = 3e-2
#: the same comparisons on an f32 copy of the served weights, where two
#: computation orders differ only by f32 rounding: sound comparisons read
#: 2.9e-6 on the H100, the planted faults 2.9e-3 and more
F32_LOGIT_TOLERANCE = 1e-4
#: the faults phase 9 plants, read through the same comparisons
FAULT_GQA = "attention: query head h reads kv head h % K"
FAULT_CHUNK = "ssd: state not carried from chunk to chunk"
FAULT_ZERO_STATE = "decode: the prefill's ssd state zeroed"
FAULT_KV_SHORT = "decode: kv cache length one short"
#: planted faults the bf16 comparisons read but do not gate, and why
BF16_UNGATED_FAULTS = {
    f: "in bf16 it reads within the rounding of 32 layers; the f32 copy "
       "gates it" for f in (FAULT_CHUNK, FAULT_ZERO_STATE)}


def rate_for(torch, dtype) -> float:
    return H100_BF16_OPS_PER_S if dtype == torch.bfloat16 \
        else H100_F32_OPS_PER_S


def bound(nbytes: float, ops: float, ops_per_s: float) -> tuple:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attn_bound_ms(torch, q, k, causal: bool) -> tuple:
    """q, k, v read once and out written once, against the exact causal
    work: 4 D operations (q.k and p.v) per allowed (query, key) pair."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    if causal:
        off = skv - sq
        pairs = sum(min(i + off + 1, skv) for i in range(sq))
    else:
        pairs = sq * skv
    return bound(nbytes, 4.0 * d * pairs * b * h, rate_for(torch, q.dtype))


def ssd_bound_ms(torch, x, B, chunk: int) -> tuple:
    """x, dt, A, B, C read once, y and the state written once, against the
    chunked algorithm's products: C.B^T on the causal half of each chunk,
    att.x on that half, C.state and the chunk summary."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    chunk = min(chunk, l)
    nc = -(-l // chunk)
    tri = chunk * (chunk + 1) / 2
    es = x.element_size()
    nbytes = (2 * x.numel() * es + b * l * h * 4 + h * 4
              + 2 * B.numel() * es + b * h * p * n * es)
    ops = b * nc * (2 * tri * n + h * (2 * tri * p + 4 * chunk * n * p))
    return bound(nbytes, ops, rate_for(torch, x.dtype))


def phase_model_kernels_vs_plain(torch, fa, ssd, attn, ssm_mod) -> dict:
    print("phase 8: flash_attn and ssd_scan kernels against their plain "
          "versions on the card (TF32 off: "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32})")
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype="float32", scale=1.0):
        t = torch.randn(shape, generator=gen, device=dev) * scale
        return t.to(getattr(torch, dtype))

    out = {"attn_err": 0.0, "ssd_err": 0.0, "attn_rows_by_shape": {}}
    hymba_attn = (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 25, 5, 64, True,
                  "bfloat16")
    # the serving shapes, each query row also held to its own scale
    serving = {hymba_attn: "hymba-1.5b"}
    for name, *shape in ATTN_TIMED[2:]:
        serving[tuple(shape) + ("bfloat16",)] = name
    for name, *shape in ATTN_TIMED_F32:
        serving[tuple(shape) + ("float32",)] = name + " f32"
    for case in ATTN_CASES + list(serving):
        b, sq, skv, h, kh, d, causal, dt = case
        q = randn(b, sq, h, d, dtype=dt)
        k, v = randn(b, skv, kh, d, dtype=dt), randn(b, skv, kh, d, dtype=dt)
        tol = 2e-2 if dt == "bfloat16" else 2e-5
        before = dict(fa.ops.flash_attention.launches_by_kernel)
        got = fa.ops.flash_attention(q, k, v, causal=causal)
        which = "mma" if dt == "bfloat16" else "simt"
        moved = {n: c - before[n] for n, c in
                 fa.ops.flash_attention.launches_by_kernel.items()}
        check(moved == {"mma": int(which == "mma"),
                        "simt": int(which == "simt")},
              f"flash_attn {case}: one launch of the {which} kernel")
        plain = attn._blockwise_attention(q, k, v, causal)
        wants = {"plain": plain}
        if case not in serving:
            wants["attention_ref"] = fa.attention_ref(q, k, v, causal)
        torch.cuda.synchronize()
        for name, want in wants.items():
            err = float((got.float() - want.float()).abs().max())
            ok = bool(torch.allclose(got.float(), want.float(), atol=tol,
                                     rtol=tol))
            out["attn_err"] = max(out["attn_err"], err)
            check(ok, f"flash_attn {case}: kernel vs {name} max_abs_err "
                  f"{err:.3g} (tol {tol})")
        if case in serving:
            out["attn_rows_by_shape"][serving[case]] = check_attn_rows(
                torch, fa, attn, q, k, v, got, plain, serving[case], causal)
        del q, k, v, got, plain, wants
    out["attn_rows"] = out["attn_rows_by_shape"]["hymba-1.5b"]
    out["attn_timed"] = [time_attention(torch, fa, attn, randn, shape)
                         for shape in ATTN_TIMED]
    out["attn_timed"] += [time_attention(torch, fa, attn, randn, shape,
                                         "float32")
                          for shape in ATTN_TIMED_F32]
    hymba = out["attn_timed"][0]
    for key in ("ms", "library_ms", "simt_ms", "bound_ms", "bound_by",
                "plain_ms"):
        out[f"attn_{key}"] = hymba[key]

    hymba_ssd = (SERVE_BATCH, SERVE_PROMPT, 50, 64, 16, 256, "bfloat16")
    cases = [(c, None) for c in SSD_CASES + SSD_MMA_CASES + [hymba_ssd]]
    cases.append(((2, 200, 4, 64, 16, 64, "float32"), "init-state"))
    cases.append(((2, 200, 4, 64, 16, 64, "bfloat16"), "init-state"))
    cases.append(((1, 256, 2, 32, 16, 256, "float32"), "strong-decay"))
    cases.append(((1, 256, 2, 32, 16, 256, "bfloat16"), "strong-decay"))
    cases += [(c, "weak-decay") for c in SSD_WEAK_DECAY]
    for case, kind in cases:
        b, l, h, p, n, chunk, dt = case
        what = f"ssd_scan {case}{' ' + kind if kind else ''}"
        x = randn(b, l, h, p, dtype=dt, scale=0.5)
        dtt = torch.rand((b, l, h), generator=gen, device=dev) * 0.099 + 0.001
        A = -(torch.rand((h,), generator=gen, device=dev) * 1.5 + 0.5)
        if case == hymba_ssd:                  # hymba's A = -exp(A_log)
            A = -torch.arange(1, h + 1, dtype=torch.float32, device=dev)
        if kind == "strong-decay":             # exp(seg_i - seg_j) overflows
            A = torch.tensor([-50.0, -1.0], device=dev)
            dtt = torch.full_like(dtt, 0.1)
        if kind == "weak-decay":
            A = torch.full((h,), -0.05, device=dev)
        B, C = randn(b, l, n, dtype=dt, scale=0.3), randn(b, l, n, dtype=dt,
                                                          scale=0.3)
        s0 = randn(b, h, p, n, scale=0.1) if kind == "init-state" else None
        tol = 3e-2 if dt == "bfloat16" else 1e-5
        before = dict(ssd.ops.ssd_scan.launches_by_kernel)
        y, s = ssd.ops.ssd_scan(x, dtt, A, B, C, chunk=chunk, init_state=s0)
        which = "mma" if dt == "bfloat16" else "simt"
        moved = {k: c - before[k] for k, c in
                 ssd.ops.ssd_scan.launches_by_kernel.items()}
        check(moved == {"mma": int(which == "mma"),
                        "simt": int(which == "simt")},
              f"{what}: one call of the {which} kernel")
        wants = {"plain": ssm_mod.ssd_chunked(x, dtt, A, B, C, chunk, s0),
                 "ssd_ref": ssd.ssd_ref(x, dtt, A, B, C, s0)}
        torch.cuda.synchronize()
        check(bool(torch.isfinite(y.float()).all()
                   and torch.isfinite(s.float()).all()),
              f"{what}: finite y and state")
        for name, (yw, sw) in wants.items():
            err = float((y.float() - yw.float()).abs().max())
            yrel, srel = max_rel(y.float(), yw.float()), max_rel(
                s.float(), sw.float())
            out["ssd_err"] = max(out["ssd_err"], err)
            out["ssd_state_rel"] = max(out.get("ssd_state_rel", 0.0), srel)
            check(yrel < tol and srel < tol,
                  f"{what}: kernel vs {name} y err {yrel:.3g} of max|y|, "
                  f"state err {srel:.3g} of max|state| (tol {tol})")
        if case == hymba_ssd:
            hx = (x, dtt, A, B, C, chunk)
            out["ssd_planted_state_rel"] = check_ssd_state_planted(
                torch, ssd, hx, wants["plain"][1], tol)
        if kind == "weak-decay" and dt == "bfloat16":
            out["ssd_planted_prior_rel"] = check_ssd_prior_planted(
                torch, ssm_mod, (x, dtt, A, B, C, chunk), wants["plain"][0],
                tol)
    del x, y, s, B, C, wants
    out.update(time_ssd(torch, ssd, ssm_mod, hx))
    return out


def time_ssd(torch, ssd, ssm_mod, hx) -> dict:
    """At hymba's per-layer shape (bf16): the tensor-core passes and the
    CUDA-core kernel run on the same bf16 inputs, timed in turns (passes,
    CUDA cores, then the reverse; CUDA events, mean of 10 calls, 3 for the
    CUDA-core kernel); the three passes' split from ``torch.profiler``;
    the plain version; the CUDA-core kernel on an f32 copy of the inputs;
    against the bound."""
    x, dtt, A, B, C, chunk = hx
    runs = {
        "ssd_ms": (lambda: ssd.ops.ssd_scan(x, dtt, A, B, C, chunk=chunk),
                   10),
        "ssd_simt_ms": (lambda: ssd.kernel.launch(x, dtt, A, B, C, chunk,
                                                  None, "simt"), 3)}
    turns = {key: [] for key in runs}
    for order in (list(runs), list(runs)[::-1]):
        for key in order:
            fn, reps = runs[key]
            turns[key].append(cuda_ms(fn, reps))
    out = {key: sum(ts) / len(ts) for key, ts in turns.items()}
    out["ssd_turns"] = turns
    out["ssd_passes_ms"] = ssd_pass_split(torch, runs["ssd_ms"][0], 5)
    out["ssd_plain_ms"] = cuda_ms(
        lambda: ssm_mod.ssd_chunked(x, dtt, A, B, C, chunk), 3)
    x32, B32, C32 = x.float(), B.float(), C.float()
    out["ssd_f32_ms"] = cuda_ms(
        lambda: ssd.ops.ssd_scan(x32, dtt, A, B32, C32, chunk=chunk), 3)
    del x32, B32, C32
    out["ssd_bound_ms"], out["ssd_bound_by"] = ssd_bound_ms(torch, x, B,
                                                            chunk)
    print(f"  ssd_scan at hymba's per-layer shape {tuple(x.shape)}, n "
          f"{B.shape[-1]}, chunk {chunk}, bf16: tensor-core passes "
          f"{out['ssd_ms']:.4f} ms (per pass, profiler, mean of 5: "
          f"{json.dumps(out['ssd_passes_ms'])}), CUDA-core kernel "
          f"{out['ssd_simt_ms']:.4f} ms (in turns: {json.dumps(turns)}); "
          f"plain {out['ssd_plain_ms']:.4f} ms (mean of 3); the CUDA-core "
          f"kernel on an f32 copy {out['ssd_f32_ms']:.4f} ms (mean of 3); "
          f"no single PyTorch call computes the scan; bound "
          f"{out['ssd_bound_ms']:.5f} ms ({out['ssd_bound_by']})")
    return out


def ssd_pass_split(torch, fn, reps: int):
    """Mean device ms per call of each ssd_scan kernel over ``reps`` calls
    of ``fn()`` under ``torch.profiler``, by kernel name; ``None`` where
    the profiler reports no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for evt in prof.key_averages():
        name = re.search(r"ssd_scan\w*", evt.key)
        if evt.device_type == DeviceType.CUDA and name:
            split[name.group(0)] = (split.get(name.group(0), 0.0)
                                    + evt.device_time_total / 1e3)
    return {k: v / reps for k, v in split.items()} or None


def time_attention(torch, fa, attn, randn, shape, dtype="bfloat16") -> dict:
    """At one per-layer shape: the kernel of ``dtype`` and SDPA, and in
    bf16 also the CUDA-core kernel run on bf16, timed in turns (kernel,
    SDPA, CUDA cores, then the reverse; CUDA events, mean of 10 launches,
    3 for the CUDA-core kernel on bf16); the plain version (mean of 3);
    against the bound. SDPA's causal mask is aligned to the top left,
    the kernel's to the bottom right: the causal shapes here have Sq =
    Skv, where the two agree."""
    name, b, sq, skv, h, kh, d, causal = shape
    q = randn(b, sq, h, d, dtype=dtype)
    k, v = (randn(b, skv, kh, d, dtype=dtype) for _ in range(2))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    which = fa.kernel.kernel_for(q.dtype)
    runs = {
        "ms": (lambda: fa.kernel.launch(q, k, v, causal, which), 10),
        "library_ms": (lambda: sdpa(qt, kt, vt, is_causal=causal,
                                    enable_gqa=True), 10)}
    if which == "mma":
        runs["simt_ms"] = (lambda: fa.kernel.launch(q, k, v, causal,
                                                    "simt"), 3)
    times = {key: [] for key in runs}
    for order in (list(runs), list(runs)[::-1]):
        for key in order:
            fn, reps = runs[key]
            times[key].append(cuda_ms(fn, reps))
    out = {key: sum(ts) / len(ts) for key, ts in times.items()}
    out.setdefault("simt_ms", None)
    out["turns"] = times
    out["plain_ms"] = cuda_ms(
        lambda: attn._blockwise_attention(q, k, v, causal), 3)
    lib_err = float((sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
                     .transpose(1, 2).float()
                     - fa.kernel.launch(q, k, v, causal, which).float())
                    .abs().max())
    out["bound_ms"], out["bound_by"] = attn_bound_ms(torch, q, k, causal)
    out["shape"] = shape
    out["dtype"] = dtype
    simt = ("" if which == "simt" else
            f", CUDA-core kernel {out['simt_ms']:.4f} ms")
    print(f"  flash_attn at {name}'s per-layer shape (B {b}, Sq {sq}, Skv "
          f"{skv}, H {h}, K {kh}, D {d}, {dtype}, "
          f"{'causal' if causal else 'no mask'}): {which} kernel "
          f"{out['ms']:.4f} ms, SDPA {out['library_ms']:.4f} ms (max_abs_err "
          f"vs the kernel {lib_err:.3g}){simt} (in turns: "
          f"{json.dumps(times)}); plain {out['plain_ms']:.4f} ms (mean of "
          f"3); bound {out['bound_ms']:.5f} ms ({out['bound_by']})")
    return out


def row_rel(got, want) -> float:
    """The largest, over query rows, of a row's max|got - want| over that
    row's max|want|."""
    g, w = got.float(), want.float()
    return float(((g - w).abs().amax(-1)
                  / w.abs().amax(-1).clamp_min(1e-30)).max())


def check_attn_rows(torch, fa, attn, q, k, v, got, plain, shape,
                    causal=True) -> dict:
    """At a serving shape, each query row against its own scale: vs the
    plain version, and vs an f32 oracle for the first and the last kv group
    of request 0. A planted fault -- the last q tile without its last kv
    tile (the one that holds the diagonal, when causal) -- must land above
    the limit."""
    r = {"vs_plain": row_rel(got, plain)}
    g = q.shape[2] // k.shape[2]
    for name, kv in (("first", 0), ("last", k.shape[2] - 1)):
        hs = slice(kv * g, (kv + 1) * g)
        want = fa.attention_ref(q[:1, :, hs].float(),
                                k[:1, :, kv:kv + 1].float(),
                                v[:1, :, kv:kv + 1].float(), causal)
        r[f"vs_f32_{name}_group"] = row_rel(got[:1, :, hs], want)
        del want
    t = 64
    bad = attn._blockwise_attention(q[:, -t:], k[:, :-t], v[:, :-t], False)
    r["planted"] = row_rel(bad, got[:, -t:])
    r["planted_abs"] = float((bad.float() - got[:, -t:].float()).abs().max())
    print(f"  flash_attn at {shape}'s serving shape, row errors over the "
          f"row's max|value|: {r}")
    oracle_tol = ATTN_ROW_TOLERANCE["f32 oracle"]
    for name, limit in (("vs_plain", ATTN_ROW_TOLERANCE["plain"]),
                        ("vs_f32_first_group", oracle_tol),
                        ("vs_f32_last_group", oracle_tol)):
        check(r[name] <= limit,
              f"flash_attn at {shape}'s serving shape, kernel {name}: largest "
              f"row error {r[name]:.4g} of the row's max|value| (tol "
              f"{limit:.4g})")
    check(r["planted"] > max(ATTN_ROW_TOLERANCE.values()),
          f"{shape}: planted fault (the last q tile without its last kv "
          f"tile) reads "
          f"{r['planted']:.4g} of the row's max|value|, above the row limits "
          f"(its max_abs_err {r['planted_abs']:.3g}, against the absolute "
          f"2e-2)")
    return r


def check_ssd_state_planted(torch, ssd, hx, s_plain, tol) -> float:
    """A planted fault at the serving shape: the final state of a scan that
    skips the last chunk's update must land above the state limit."""
    x, dtt, A, B, C, chunk = hx
    _, s_bad = ssd.ops.ssd_scan(*(t[:, :-chunk].contiguous()
                                  for t in (x, dtt)), A,
                                *(t[:, :-chunk].contiguous() for t in (B, C)),
                                chunk=chunk)
    rel = max_rel(s_bad.float(), s_plain.float())
    check(rel > tol, f"planted fault (the state without the last chunk's "
          f"update) reads {rel:.4g} of max|state|, above the limit {tol}")
    return rel


def shifted_prior_ssd(torch, ssm_mod, x, dt, A, B, C, chunk):
    """A planted fault: chunk c reads its own output state, the state after
    chunk c, in place of its prior state."""
    state, ys = None, []
    for c in range(0, x.shape[1], chunk):
        part = [t[:, c:c + chunk] for t in (x, dt, B, C)]
        _, state = ssm_mod.ssd_chunked(part[0], part[1], A, part[2],
                                       part[3], chunk, state)
        state = state.float()
        y, _ = ssm_mod.ssd_chunked(part[0], part[1], A, part[2], part[3],
                                   chunk, state)
        ys.append(y)
    return torch.cat(ys, dim=1)


def check_ssd_prior_planted(torch, ssm_mod, args, y_plain, tol) -> float:
    """A planted state-passing fault in the weak-decay case must land
    above the y limit."""
    rel = max_rel(shifted_prior_ssd(torch, ssm_mod, *args).float(),
                  y_plain.float())
    check(rel > tol, f"planted fault (each chunk reads its own output state "
          f"as its prior) reads {rel:.4g} of max|y|, above the limit {tol}")
    return rel


def plain_attention(attn):
    return (lambda q, k, v, causal=True, **kw:
            attn._blockwise_attention(q, k, v, causal))


def plain_ssd(ssm_mod):
    return (lambda x, dt, A, B, C, chunk=256, init_state=None:
            ssm_mod.ssd_chunked(x, dt, A, B, C, chunk, init_state))


def gqa_tiled_attention(attn):
    """A planted fault: query head h reads kv head h % K (the kv heads
    tiled, where the model repeats each)."""
    def fn(q, k, v, causal=True, **kw):
        g = q.shape[2] // k.shape[2]
        return attn._blockwise_attention(q, k.repeat(1, 1, g, 1),
                                         v.repeat(1, 1, g, 1), causal)
    return fn


def chunk_local_ssd(torch, ssm_mod):
    """A planted fault: the state is not carried from chunk to chunk."""
    def fn(x, dt, A, B, C, chunk=256, init_state=None):
        ys = []
        for c in range(0, x.shape[1], chunk):
            y, s = ssm_mod.ssd_chunked(x[:, c:c + chunk], dt[:, c:c + chunk],
                                       A, B[:, c:c + chunk],
                                       C[:, c:c + chunk], chunk, None)
            ys.append(y)
        return torch.cat(ys, dim=1), s
    return fn


def last_logits_with(model, params, prompts, fa_ops, ssd_ops, attn_fn,
                     ssd_fn):
    """The prefill's last-position logits with the two kernel ops swapped
    for ``attn_fn`` / ``ssd_fn``, on the same card tensors."""
    saved = (fa_ops.flash_attention, ssd_ops.ssd_scan)
    fa_ops.flash_attention, ssd_ops.ssd_scan = attn_fn, ssd_fn
    try:
        logits, _ = model.prefill(params, {"tokens": prompts})
    finally:
        fa_ops.flash_attention, ssd_ops.ssd_scan = saved
    return logits[:, -1].float()


def max_rel(got, want) -> float:
    return float((got - want).abs().max()) / float(want.abs().max())


def profile_split(torch, fn, ranges=()) -> dict:
    """Run ``fn()`` once under ``torch.profiler`` and split the device
    time by kernel: the attention and SSD kernels, GEMMs (cuBLAS / CUTLASS,
    the projections, MLP and unembedding), and everything else
    (normalisations, RoPE, convolution, elementwise, copies, the decode
    path's plain attention). ``ranges`` names ``record_function`` ranges
    (the MoE's routing, dispatch and combine, which launch no GEMM) whose
    kernels' device time becomes a bucket of its own, "moe_dispatch",
    taken out of "other". ``busy`` is the kernels' sum over the wall of
    the window (host clock, ending in a synchronise); the profiler's own
    cost is inside that wall. All ms; ``None`` where the profiler reports
    no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    split = {"flash_attn": 0.0, "ssd_scan": 0.0, "gemm": 0.0, "other": 0.0}
    launches, rows = 0, []
    # a range's CPU row sums its kernels' time; its GPU row (if the
    # profiler makes one) spans them on the device's timeline
    in_ranges = {"cpu": 0.0, "gpu": 0.0}
    for evt in prof.key_averages():
        if evt.key in ranges:
            side = "gpu" if evt.device_type == DeviceType.CUDA else "cpu"
            in_ranges[side] += evt.device_time_total / 1e3
            continue
        # kernel rows only: a CPU op's row repeats its kernels' time
        if evt.device_type != DeviceType.CUDA:
            continue
        us = evt.device_time_total
        name = evt.key.lower()
        key = ("flash_attn" if "flash_attn" in name else
               "ssd_scan" if "ssd_scan" in name else
               "gemm" if any(w in name for w in ("gemm", "xmma", "cutlass",
                                                 "cublas", "nvjet", "sm90_"))
               else "other")
        split[key] += us / 1e3
        launches += evt.count
        rows.append((us / 1e3, evt.count, evt.key[:70]))
    if ranges:
        moe_ms = in_ranges["cpu"] or in_ranges["gpu"]
        split["moe_dispatch"] = min(moe_ms, split["other"])
        split["other"] -= split["moe_dispatch"]
    total = sum(split.values())
    if total == 0.0:
        return {"wall_ms": wall_ms, "device_ms": None}
    return {"wall_ms": wall_ms, "device_ms": total, "split_ms": split,
            "busy": total / wall_ms, "kernel_launches": launches,
            "top": sorted(rows, reverse=True)[:12]}


def print_profile(what, prof) -> None:
    if prof["device_ms"] is None:
        print(f"  {what} under torch.profiler: {prof['wall_ms']:.1f} ms "
              f"wall; device time not measured (the profiler reported "
              f"none)")
        return
    parts = ", ".join(f"{k} {v:.1f}" for k, v in prof["split_ms"].items())
    print(f"  {what} under torch.profiler: {prof['wall_ms']:.1f} ms wall, "
          f"kernels {prof['device_ms']:.1f} ms ({parts}); device busy "
          f"{prof['busy']:.3f}, {prof['kernel_launches']} kernel launches")
    for ms, count, name in prof["top"]:
        print(f"    {ms:9.3f} ms {count:6d}x  {name}")


def to_f32(torch, tree):
    """A copy of a parameter tree with every floating tensor in f32."""
    if isinstance(tree, dict):
        return {k: to_f32(torch, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_f32(torch, v) for v in tree]
    return tree.float() if tree.is_floating_point() else tree


def logit_checks(torch, model, params, prompts, gen_toks, first, cache, fa,
                 ssd, attn, ssm_mod, tol, ungated) -> dict:
    """Hold the served logits, ``first`` (the last position of a prefill
    that left ``cache``), with the share ``tol`` of max|logit|: request 0
    through the kernels against the plain versions, and decode steps
    CONSISTENCY_STEPS against fresh prefills. Then plant faults and read
    them through the same two comparisons: each must land above ``tol``,
    except those in ``ungated``, which are only printed, with the reason
    the comparison cannot see them."""
    out = {}
    check(bool(torch.isfinite(first).all()), "prefill logits finite (no NaN)")
    plain = last_logits_with(model, params, prompts[:1], fa.ops, ssd.ops,
                             plain_attention(attn), plain_ssd(ssm_mod))
    out["kernel_vs_plain_rel"] = max_rel(first[:1], plain)
    check(out["kernel_vs_plain_rel"] <= tol,
          f"request 0's last-position logits through the kernels vs the "
          f"plain versions on the card: max|diff| "
          f"{out['kernel_vs_plain_rel']:.4g} of max|logit| (tol {tol})")
    decode_logits = {}
    for t in range(1, max(CONSISTENCY_STEPS) + 1):
        step, cache = model.decode_step(params, cache, gen_toks[:, t - 1])
        if t in CONSISTENCY_STEPS:
            decode_logits[t] = step.float()
            check(bool(torch.isfinite(decode_logits[t]).all()),
                  f"decode step {t}: finite logits")
    del cache
    out["consistency"], fresh_logits = {}, {}
    for t, dec in decode_logits.items():
        toks = torch.cat([prompts, gen_toks[:, :t]], dim=1)
        fresh, _ = model.prefill(params, {"tokens": toks})
        fresh_logits[t] = fresh = fresh[:, -1].float()
        rel = max_rel(dec, fresh)
        agree = float((dec.argmax(-1) == fresh.argmax(-1)).float().mean())
        out["consistency"][t] = {"rel": rel, "argmax_agree": agree}
        check(rel <= tol,
              f"decode step {t} vs a fresh prefill of {SERVE_PROMPT + t} "
              f"tokens, last position: max|diff| {rel:.4g} of max|logit| "
              f"(tol {tol}); argmax agrees for {agree:.2f} of the requests")

    readings = {}

    def kernel_fault(name, attn_fn, ssd_fn):
        bad = last_logits_with(model, params, prompts[:1], fa.ops, ssd.ops,
                               attn_fn, ssd_fn)
        readings[name] = max_rel(bad, plain)

    def decode_fault(name, fault):
        _, cache = model.prefill(params, {"tokens": prompts},
                                 max_len=SERVE_PROMPT + SERVE_GEN)
        fault(cache)
        step, _ = model.decode_step(params, cache, gen_toks[:, 0])
        readings[name] = max_rel(step.float(), fresh_logits[1])

    kernel_fault(FAULT_GQA, gqa_tiled_attention(attn), plain_ssd(ssm_mod))
    kernel_fault(FAULT_CHUNK, plain_attention(attn),
                 chunk_local_ssd(torch, ssm_mod))
    decode_fault(FAULT_ZERO_STATE, lambda c: c["ssd"].zero_())
    decode_fault(FAULT_KV_SHORT, lambda c: c.update(length=c["length"] - 1))
    out["planted"] = readings
    for name, rel in readings.items():
        print(f"  planted fault, {name}: max|diff| {rel:.4g} of max|logit|"
              + (f"; not gated: {ungated[name]}" if name in ungated else ""))
    for name, rel in readings.items():
        if name not in ungated:
            check(rel > tol, f"planted fault, {name}: {rel:.4g} of "
                  f"max|logit|, above the limit {tol}")
    return out


def phase_serve(torch, serve_mod, fa, ssd, attn, ssm_mod) -> dict:
    print(f"phase 9: serve {SERVE_ARCH} at full width -- {SERVE_BATCH} "
          f"prompts of {SERVE_PROMPT} tokens, {SERVE_GEN} greedy tokens each")
    from repro_torch.models import build_model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.ops.reset_counts()
    ssd.ops.reset_counts()
    t0 = time.perf_counter()
    res = serve_mod.serve(SERVE_ARCH, reduced=SERVE_REDUCED,
                          batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                          gen=SERVE_GEN, seed=SEED)
    wall_s = time.perf_counter() - t0
    launches = {"flash_attn": fa.ops.flash_attention.launches,
                "ssd_scan": ssd.ops.ssd_scan.launches}
    by_kernel = dict(fa.ops.flash_attention.launches_by_kernel)
    ssd_by_kernel = dict(ssd.ops.ssd_scan.launches_by_kernel)
    peak = torch.cuda.max_memory_allocated()
    cfg = res.cfg
    out = {"prefill_s": res.prefill_s, "decode_s": res.decode_s,
           "decode_ms_per_step": res.decode_s / res.decode_steps * 1e3,
           "decode_tok_per_s": res.decode_tok_per_s, "launches": launches,
           "attn_launches_by_kernel": by_kernel,
           "ssd_launches_by_kernel": ssd_by_kernel,
           "peak_bytes": peak, "wall_s": wall_s,
           "params": cfg.param_count(), "tokens_seq0": res.tokens[0].tolist()}
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.param_count()} parameters ({cfg.dtype}); prefill "
          f"{res.prefill_s * 1e3:.1f} ms wall; {res.decode_steps} decode "
          f"steps {out['decode_ms_per_step']:.3f} ms each "
          f"({res.decode_tok_per_s:.1f} tok/s); peak device memory {peak} "
          f"bytes; serve() {wall_s:.1f} s with init")
    print(f"  sample generation (seq 0): {res.tokens[0].tolist()}")
    check(launches == {"flash_attn": cfg.n_layers, "ssd_scan": cfg.n_layers},
          f"the prefill launched flash_attn {launches['flash_attn']} and "
          f"ssd_scan {launches['ssd_scan']} times ({cfg.n_layers} layers)")
    check(by_kernel == {"mma": cfg.n_layers, "simt": 0},
          f"all {cfg.n_layers} attention launches of the bf16 prefill went "
          f"through the tensor-core kernel ({by_kernel})")
    check(ssd_by_kernel == {"mma": cfg.n_layers, "simt": 0},
          f"all {cfg.n_layers} ssd_scan calls of the bf16 prefill went "
          f"through the tensor-core passes ({ssd_by_kernel})")
    check(tuple(res.tokens.shape) == (SERVE_BATCH, SERVE_GEN)
          and int(res.tokens.min()) >= 0
          and int(res.tokens.max()) < cfg.vocab_size,
          f"{SERVE_BATCH} x {SERVE_GEN} tokens, all in [0, {cfg.vocab_size})")

    model = build_model(cfg)
    params, prompts = res.params, res.prompts
    gen_toks = res.tokens.to(prompts.device)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": prompts},
                                      max_len=SERVE_PROMPT + SERVE_GEN)
        torch.cuda.synchronize()
        out["warm_prefill_s"] = time.perf_counter() - t0
        print(f"  a second (warm) prefill: {out['warm_prefill_s'] * 1e3:.1f} "
              f"ms wall")
        first = logits[:, -1].float()
        check(torch.equal(first.argmax(-1).to(torch.int32).cpu(),
                          res.tokens[:, 0]),
              "a second prefill gives serve()'s first tokens")
        del logits
        out["bf16"] = logit_checks(torch, model, params, prompts, gen_toks,
                                   first, cache, fa, ssd, attn, ssm_mod,
                                   LOGIT_TOLERANCE, BF16_UNGATED_FAULTS)
        del cache, first
        print(f"  the same weights in f32, request 0 ({cfg.name} with dtype "
              f"float32, the kernels' f32 instantiations):")
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        model32, params32 = build_model(cfg32), to_f32(torch, params)
        fa.ops.reset_counts()
        ssd.ops.reset_counts()
        logits, cache = model32.prefill(params32, {"tokens": prompts[:1]},
                                        max_len=SERVE_PROMPT + SERVE_GEN)
        by_kernel = dict(fa.ops.flash_attention.launches_by_kernel)
        ssd_by_kernel = dict(ssd.ops.ssd_scan.launches_by_kernel)
        check(by_kernel == {"mma": 0, "simt": cfg.n_layers},
              f"all {cfg.n_layers} attention launches of the f32 prefill "
              f"went through the CUDA-core kernel ({by_kernel})")
        check(ssd_by_kernel == {"mma": 0, "simt": cfg.n_layers},
              f"all {cfg.n_layers} ssd_scan calls of the f32 prefill went "
              f"through the CUDA-core kernel ({ssd_by_kernel})")
        first = logits[:, -1].float()
        del logits
        out["f32"] = logit_checks(torch, model32, params32, prompts[:1],
                                  gen_toks[:1], first, cache, fa, ssd, attn,
                                  ssm_mod, F32_LOGIT_TOLERANCE, {})
        del cache, first, params32
        torch.cuda.empty_cache()

        # where the time goes: one prefill and 8 decode steps, profiled
        def prefill_once():
            nonlocal cache
            _, cache = model.prefill(params, {"tokens": prompts},
                                     max_len=SERVE_PROMPT + SERVE_GEN)

        def decode_8():
            nonlocal cache
            for t in range(8):
                _, cache = model.decode_step(params, cache, gen_toks[:, t])

        cache = None
        out["prefill_profile"] = profile_split(torch, prefill_once)
        out["decode_profile"] = profile_split(torch, decode_8)
        del cache
    for what, prof in (("prefill", out["prefill_profile"]),
                       ("8 decode steps", out["decode_profile"])):
        print_profile(what, prof)
    prof = out["prefill_profile"]
    if prof["device_ms"] is not None:
        check(prof["split_ms"]["ssd_scan"] > 0.0,
              f"the prefill profile counts the ssd_scan kernels' device "
              f"time ({prof['split_ms']['ssd_scan']:.3f} ms)")
    return out


#: phase 15: moonshot-v1-16b-a3b served whole (its published config)
MOE_ARCH = "moonshot-v1-16b-a3b"
MOE_BATCH = 4
MOE_PROMPT = 2048
MOE_GEN = 32
#: decode steps of request 0 held against fresh prefills
MOE_CONSISTENCY_STEPS = (1, MOE_GEN - 1)
#: tests/test_archs_smoke.py's no-drop capacity for decode consistency:
#: at the default 1.25 a decode step of batch 1 has capacity 1 and a
#: prefill of 2 048 tokens 240, so the two drop other pairs by design
MOE_NO_DROP_CF = 16.0
#: the f32 copy's depth: 4 of the 48 layers at full width (~12 GB)
MOE_F32_LAYERS = 4
#: phase 16: the other configs at full width, cut in depth
CUT_ARCHS = ("grok-1-314b", "deepseek-67b", "stablelm-12b", "starcoder2-15b")
CUT_LAYERS = 2
CUT_BATCH = 1
CUT_PROMPT = 512
CUT_GEN = 5                      # the prefill's token and 4 decode steps
FAULT_NO_RENORM = "moe: gates not renormalized after top-k"
FAULT_NO_SHARED = "moe: shared experts left out"
#: the MoE's routing, dispatch and combine as profiler ranges
MOE_RANGES = {"top_k_gates": "moe.route", "dispatch": "moe.dispatch",
              "combine": "moe.combine"}
FLIP_POLICY = ("two runs whose routing flipped (a token whose top-k set "
               "differs: O(1) in its FFN output, not rounding) are compared "
               "with the second run pinned to the first run's expert "
               "indices, at the same limit; the unpinned reading is "
               "printed beside it")


class RoutingTape:
    """Swaps ``models/moe.py``'s ``top_k_gates`` for the length of a
    ``with``, as ``last_logits_with`` swaps kernel ops: ``record()``
    keeps each call's (expert indices, top-k margin) in call order (the
    margin is the k-th minus the (k+1)-th probability); ``pin(calls)``
    makes each call take the recorded indices, its gates its own
    probabilities there, renormalized (detached from the graph with
    ``detach_gates``, a planted fault), and ``queue`` holds the calls
    not yet taken; a call past the tape's end raises; ``swap(fn)`` puts
    ``fn`` in."""

    def __init__(self, torch, moe):
        self.torch, self.moe, self.own = torch, moe, moe.top_k_gates

    @contextlib.contextmanager
    def swap(self, fn):
        self.moe.top_k_gates = fn
        try:
            yield
        finally:
            self.moe.top_k_gates = self.own

    @contextlib.contextmanager
    def record(self):
        calls = []

        def recording(probs, k):
            gate, idx = self.own(probs, k)
            top = probs.sort(dim=-1, descending=True).values
            margin = (top[:, k - 1] - top[:, k] if top.shape[1] > k
                      else self.torch.full_like(top[:, 0], float("inf")))
            calls.append((idx, margin))
            return gate, idx

        with self.swap(recording):
            yield calls

    def pin(self, calls, detach_gates: bool = False):
        queue = self.queue = [idx for idx, _ in calls]

        def pinned(probs, k):
            if not queue:
                raise SmokeFailure(f"routing tape of {len(calls)} calls "
                                   f"exhausted: the pinned run makes more "
                                   f"top_k_gates calls than the recorded one")
            idx = queue.pop(0)
            gate = probs.gather(-1, idx)
            gate = gate / gate.sum(dim=-1, keepdim=True)
            return (gate.detach() if detach_gates else gate), idx

        return self.swap(pinned)


def unnormalized_top_k(torch):
    """A planted fault: the top-k gates not renormalized."""
    def fn(probs, k):
        vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        return vals[:, :k], idx[:, :k]
    return fn


def without_shared_experts(params):
    """A planted fault: every layer's shared experts left out."""
    return {**params, "layers": [
        {**lp, "moe": {k: v for k, v in lp["moe"].items() if k != "shared"}}
        for lp in params["layers"]]}


def route_flips(a_calls, b_calls) -> dict:
    """Over (layer, token) pairs, where two runs' top-k expert sets differ:
    the count, the share, and the first flip (lowest layer, then token)
    with its router margin in each run."""
    pairs = flips = 0
    first = None
    for layer, ((ia, ma), (ib, mb)) in enumerate(zip(a_calls, b_calls)):
        diff = (ia.sort(dim=-1).values != ib.sort(dim=-1).values).any(-1)
        pairs += diff.numel()
        n = int(diff.sum())
        flips += n
        if n and first is None:
            tok = int(diff.nonzero()[0, 0])
            first = {"layer": layer, "token": tok,
                     "margin_first_run": float(ma[tok]),
                     "margin_second_run": float(mb[tok])}
    return {"pairs": pairs, "flips": flips,
            "share": flips / pairs if pairs else 0.0, "first": first}


def decode_path_routes(torch, calls, n_layers: int, t: int):
    """Per layer, the routing of a prefill and its first ``t`` decode steps
    (recorded in call order) as one full-sequence call, to compare with
    or pin a fresh prefill of the same tokens."""
    out = []
    for layer in range(n_layers):
        parts = [calls[layer]] + [calls[n_layers * s + layer]
                                  for s in range(1, t + 1)]
        out.append((torch.cat([p[0] for p in parts]),
                    torch.cat([p[1] for p in parts])))
    return out


def hold_with_flips(name, rel, flips, pinned_rel, tol) -> dict:
    """Gate one comparison of two runs at ``tol`` under FLIP_POLICY: with
    no routing flip the runs are compared as they are; with flips,
    ``pinned_rel()`` reads the comparison again with the second run pinned
    to the first run's experts, and that reading is gated."""
    out = {"rel": rel, "flips": flips}
    print(f"  {name}: max|diff| {rel:.4g} of max|logit|; routing flips "
          f"{flips['flips']} of {flips['pairs']} (layer, token) pairs "
          f"({flips['share']:.3g}), the first {flips['first']}")
    if not flips["flips"]:
        check(rel <= tol, f"{name}: {rel:.4g} of max|logit| (tol {tol})")
        return out
    out["pinned_rel"] = pinned_rel()
    check(out["pinned_rel"] <= tol,
          f"{name}: {rel:.4g} unpinned with {flips['flips']} routing flips "
          f"(the first at layer {flips['first']['layer']}, token "
          f"{flips['first']['token']}, router margin "
          f"{flips['first']['margin_first_run']:.3g} / "
          f"{flips['first']['margin_second_run']:.3g}); pinned to the first "
          f"run's experts {out['pinned_rel']:.4g} of max|logit| (tol {tol})")
    return out


def served_checks(torch, model, params, prompt, gen_toks, fa, ssd, attn,
                  tape, tol, steps, faults) -> dict:
    """Request 0 (``prompt``, batch 1) of a served model: its last-position
    logits through the kernel against the plain attention; decode steps
    ``steps`` against fresh prefills (for MoE at MOE_NO_DROP_CF); the
    planted faults when ``faults``, each read through the same comparison
    and each above ``tol``. Routing flips under FLIP_POLICY."""
    from repro_torch.models import build_model
    cfg = model.cfg
    out = {}

    def last(p=params, toks=prompt, m=model,
             attn_fn=fa.ops.flash_attention):
        return last_logits_with(m, p, toks, fa.ops, ssd.ops, attn_fn,
                                ssd.ops.ssd_scan)

    fa.ops.reset_counts()
    with tape.record() as k_calls:
        kern = last()
    which = fa.kernel.kernel_for(getattr(torch, cfg.dtype))
    by_kernel = dict(fa.ops.flash_attention.launches_by_kernel)
    check(by_kernel == {"mma": cfg.n_layers * (which == "mma"),
                        "simt": cfg.n_layers * (which == "simt")},
          f"{cfg.name} ({cfg.dtype}), request 0: {cfg.n_layers} "
          f"{which} launches of flash_attn in its prefill ({by_kernel})")
    check(bool(torch.isfinite(kern).all()), "prefill logits finite")
    plain_attn = plain_attention(attn)
    with tape.record() as p_calls:
        plain = last(attn_fn=plain_attn)
    pinned = {}

    def pinned_plain():
        with tape.pin(k_calls):
            pinned["logits"] = last(attn_fn=plain_attn)
        return max_rel(kern, pinned["logits"])

    out["kernel_vs_plain"] = hold_with_flips(
        f"{cfg.name}, request 0's last-position logits through the kernel "
        f"vs the plain attention", max_rel(kern, plain),
        route_flips(k_calls, p_calls), pinned_plain, tol)
    reference = pinned.get("logits", plain)
    readings = {}
    if faults:
        with tape.swap(unnormalized_top_k(torch)):
            readings[FAULT_NO_RENORM] = max_rel(last(), reference)
        readings[FAULT_NO_SHARED] = max_rel(
            last(p=without_shared_experts(params)), reference)
    del k_calls, p_calls, plain, pinned
    if steps:
        m = (build_model(dataclasses.replace(cfg,
                                             capacity_factor=MOE_NO_DROP_CF))
             if cfg.is_moe else model)
        max_len = prompt.shape[1] + max(steps) + 1
        with tape.record() as d_calls:
            _, cache = m.prefill(params, {"tokens": prompt}, max_len=max_len)
            dec = {}
            for t in range(1, max(steps) + 1):
                step, cache = m.decode_step(params, cache, gen_toks[:, t - 1])
                if t in steps:
                    dec[t] = step.float()
        del cache
        out["consistency"], fresh = {}, {}
        for t in steps:
            toks = torch.cat([prompt, gen_toks[:, :t]], dim=1)
            with tape.record() as f_calls:
                fresh[t] = last(toks=toks, m=m)
            path = decode_path_routes(torch, d_calls, cfg.n_layers, t) \
                if cfg.is_moe else []

            def pinned_fresh(toks=toks, path=path):
                with tape.pin(path):
                    fresh[t] = last(toks=toks, m=m)
                return max_rel(dec[t], fresh[t])

            out["consistency"][t] = hold_with_flips(
                f"{cfg.name}, decode step {t} vs a fresh prefill of "
                f"{toks.shape[1]} tokens (capacity factor "
                f"{m.cfg.capacity_factor})", max_rel(dec[t], fresh[t]),
                route_flips(path, f_calls), pinned_fresh, tol)
        if faults:
            _, cache = m.prefill(params, {"tokens": prompt}, max_len=max_len)
            cache["length"] -= 1
            step, _ = m.decode_step(params, cache, gen_toks[:, 0])
            readings[FAULT_KV_SHORT] = max_rel(step.float(), fresh[1])
            del cache
    out["planted"] = readings
    for name, rel in readings.items():
        check(rel > tol, f"planted fault, {name}: {rel:.4g} of max|logit|, "
              f"above the limit {tol}")
    return out


@contextlib.contextmanager
def moe_ranges(torch, moe):
    """``models/moe.py``'s routing, dispatch and combine, each inside a
    ``record_function`` range of MOE_RANGES for the profiler."""
    saved = {fn: getattr(moe, fn) for fn in MOE_RANGES}

    def ranged(name, fn):
        def call(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return call

    for fn, name in MOE_RANGES.items():
        setattr(moe, fn, ranged(name, saved[fn]))
    try:
        yield
    finally:
        for fn, f in saved.items():
            setattr(moe, fn, f)


def phase_serve_moe(torch, serve_mod, fa, ssd, attn, moe) -> dict:
    print(f"phase 15: serve {MOE_ARCH} at full width and depth -- "
          f"{MOE_BATCH} prompts of {MOE_PROMPT} tokens, {MOE_GEN} greedy "
          f"tokens each")
    from repro_torch.models import build_model
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(f"  device memory held before the phase: "
          f"{torch.cuda.memory_allocated()} bytes; routing-flip policy: "
          f"{FLIP_POLICY}")
    fa.ops.reset_counts()
    t0 = time.perf_counter()
    res = serve_mod.serve(MOE_ARCH, batch=MOE_BATCH, prompt_len=MOE_PROMPT,
                          gen=MOE_GEN, seed=SEED)
    wall_s = time.perf_counter() - t0
    by_kernel = dict(fa.ops.flash_attention.launches_by_kernel)
    peak = torch.cuda.max_memory_allocated()
    cfg = res.cfg
    out = {"prefill_s": res.prefill_s, "decode_s": res.decode_s,
           "decode_ms_per_step": res.decode_s / res.decode_steps * 1e3,
           "decode_tok_per_s": res.decode_tok_per_s,
           "flip_policy": FLIP_POLICY,
           "launches": fa.ops.flash_attention.launches,
           "attn_launches_by_kernel": by_kernel, "peak_bytes": peak,
           "wall_s": wall_s, "params": cfg.param_count(),
           "tokens_seq0": res.tokens[0].tolist()}
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_experts} experts top-{cfg.top_k} + {cfg.n_shared_experts}"
          f" shared, {cfg.param_count()} parameters ({cfg.dtype}); prefill "
          f"{res.prefill_s * 1e3:.1f} ms wall; {res.decode_steps} decode "
          f"steps {out['decode_ms_per_step']:.3f} ms each "
          f"({res.decode_tok_per_s:.1f} tok/s); peak device memory {peak} "
          f"bytes; serve() {wall_s:.1f} s with init")
    print(f"  sample generation (seq 0): {res.tokens[0].tolist()}")
    check((cfg.n_layers, cfg.d_model, cfg.n_experts, cfg.top_k,
           cfg.n_shared_experts) == (48, 2048, 64, 6, 2),
          "the published config: 48 layers, d_model 2048, 64 experts, "
          "top-6, 2 shared")
    check(by_kernel == {"mma": cfg.n_layers, "simt": 0},
          f"the prefill launched the tensor-core flash_attn kernel "
          f"{cfg.n_layers} times, the CUDA-core one none ({by_kernel})")
    check(tuple(res.tokens.shape) == (MOE_BATCH, MOE_GEN)
          and int(res.tokens.min()) >= 0
          and int(res.tokens.max()) < cfg.vocab_size,
          f"{MOE_BATCH} x {MOE_GEN} tokens, all in [0, {cfg.vocab_size})")

    model = build_model(cfg)
    params, prompts = res.params, res.prompts
    gen_toks = res.tokens.to(prompts.device)
    del res
    tape = RoutingTape(torch, moe)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": prompts},
                                      max_len=MOE_PROMPT + MOE_GEN)
        torch.cuda.synchronize()
        out["warm_prefill_s"] = time.perf_counter() - t0
        check(torch.equal(logits[:, -1].argmax(-1).to(torch.int32).cpu(),
                          gen_toks[:, 0].cpu()),
              f"a second (warm) prefill, {out['warm_prefill_s'] * 1e3:.1f} "
              f"ms wall, gives serve()'s first tokens")
        del logits, cache
        out["bf16"] = served_checks(torch, model, params, prompts[:1],
                                    gen_toks[:1], fa, ssd, attn, tape,
                                    LOGIT_TOLERANCE, MOE_CONSISTENCY_STEPS,
                                    faults=True)
        print(f"  an f32 copy of the served weights at full width, cut to "
              f"{MOE_F32_LAYERS} of {cfg.n_layers} layers, request 0 (the "
              f"CUDA-core kernel):")
        cfg32 = dataclasses.replace(cfg, dtype="float32",
                                    n_layers=MOE_F32_LAYERS)
        params32 = to_f32(torch, {**params,
                                  "layers": params["layers"][:MOE_F32_LAYERS]})
        out["f32"] = served_checks(torch, build_model(cfg32), params32,
                                   prompts[:1], gen_toks[:1], fa, ssd, attn,
                                   tape, F32_LOGIT_TOLERANCE, (), faults=True)
        del params32
        torch.cuda.empty_cache()

        # where the time goes: one prefill and 8 decode steps, profiled
        def prefill_once():
            nonlocal cache
            _, cache = model.prefill(params, {"tokens": prompts},
                                     max_len=MOE_PROMPT + MOE_GEN)

        def decode_8():
            nonlocal cache
            for t in range(8):
                _, cache = model.decode_step(params, cache, gen_toks[:, t])

        cache = None
        with moe_ranges(torch, moe):
            ranges = tuple(MOE_RANGES.values())
            out["prefill_profile"] = profile_split(torch, prefill_once,
                                                   ranges)
            out["decode_profile"] = profile_split(torch, decode_8, ranges)
        del cache
    for what, prof in (("prefill", out["prefill_profile"]),
                       ("8 decode steps", out["decode_profile"])):
        print_profile(what, prof)
    prof = out["decode_profile"]
    if prof["device_ms"] is not None:
        out["launches_per_decode_step"] = prof["kernel_launches"] / 8
        print(f"  {out['launches_per_decode_step']:.1f} kernel launches per "
              f"decode step")
    del params, prompts, gen_toks
    return out


def phase_cut_configs(torch, serve_mod, config, fa, ssd, attn, moe) -> dict:
    print(f"phase 16: {', '.join(CUT_ARCHS)} at full width, cut to "
          f"{CUT_LAYERS} layers -- batch {CUT_BATCH}, a {CUT_PROMPT}-token "
          f"prompt, {CUT_GEN - 1} decode steps")
    from repro_torch.models import build_model
    out = {}
    tape = RoutingTape(torch, moe)
    for arch in CUT_ARCHS:
        full = config.get_model_config(arch)
        cut = dataclasses.replace(full, name=f"{arch}-{CUT_LAYERS}-layers",
                                  n_layers=CUT_LAYERS)
        if cut.name not in config.list_models():
            config.register_model(cut)
        print(f"  {arch}: the published config cut from {full.n_layers} to "
              f"{cut.n_layers} layers (dataclasses.replace, registered as "
              f"{cut.name!r}): d_model {cut.d_model}, {cut.n_heads} heads / "
              f"{cut.n_kv_heads} kv heads of {cut.resolved_head_dim}, mlp "
              f"{cut.mlp}, {cut.n_experts} experts top-{cut.top_k}; "
              f"{cut.param_count()} parameters")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fa.ops.reset_counts()
        t0 = time.perf_counter()
        res = serve_mod.serve(cut.name, batch=CUT_BATCH,
                              prompt_len=CUT_PROMPT, gen=CUT_GEN, seed=SEED)
        wall_s = time.perf_counter() - t0
        by_kernel = dict(fa.ops.flash_attention.launches_by_kernel)
        r = {"prefill_s": res.prefill_s, "decode_s": res.decode_s,
             "decode_ms_per_step": res.decode_s / res.decode_steps * 1e3,
             "launches": fa.ops.flash_attention.launches,
             "attn_launches_by_kernel": by_kernel, "wall_s": wall_s,
             "peak_bytes": torch.cuda.max_memory_allocated(),
             "params": cut.param_count(),
             "head_dim": cut.resolved_head_dim}
        print(f"  {cut.name}: prefill {res.prefill_s * 1e3:.1f} ms wall, "
              f"{res.decode_steps} decode steps "
              f"{r['decode_ms_per_step']:.3f} ms each; peak "
              f"{r['peak_bytes']} bytes; serve() {wall_s:.1f} s with init")
        check(by_kernel == {"mma": CUT_LAYERS, "simt": 0},
              f"{cut.name}: {CUT_LAYERS} tensor-core flash_attn launches at "
              f"head dim {cut.resolved_head_dim} ({by_kernel})")
        check(tuple(res.tokens.shape) == (CUT_BATCH, CUT_GEN)
              and int(res.tokens.min()) >= 0
              and int(res.tokens.max()) < cut.vocab_size,
              f"{cut.name}: {CUT_GEN} tokens in [0, {cut.vocab_size})")
        model = build_model(res.cfg)
        with torch.inference_mode():
            r.update(served_checks(
                torch, model, res.params, res.prompts[:1],
                res.tokens[:1].to(res.prompts.device), fa, ssd, attn, tape,
                LOGIT_TOLERANCE, (1, CUT_GEN - 1), faults=False))
        out[arch] = r
        del res, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_ycsb(torch) -> dict:
    print("phase 17: the YCSB key-value twin (repro_torch.examples.ycsb_kv) "
          "with its Logging Units on the card")
    from repro_torch.examples import ycsb_kv
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        drops = ycsb_kv.main([])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    lines = text.getvalue().splitlines()
    for line in lines:
        print(f"  | {line}")
    check(any(line.strip().endswith("exact match: True") for line in lines),
          f"the failed node's shard recovered from the replica logs, exact "
          f"match ({wall_s:.1f} s wall)")
    check(drops == 0 and "logging-unit drops: 0 (must be 0)" in lines,
          "0 Logging Unit drops")
    return {"wall_s": wall_s, "lines": lines, "drops": drops}


#: phase 18: whisper-medium served whole (its published config); prompts
#: of 224 tokens, half the decoder's 448-token context given to
#: previous-text conditioning, as long-form transcription does, and 32
#: generated, so the self-attention cache holds 256
WHISPER_ARCH = "whisper-medium"
WHISPER_BATCH = 8
WHISPER_PROMPT = 224
WHISPER_GEN = 32
#: phase 19: internvl2-26b served whole (its published config); prompts
#: of 1 024 positions, the 256 patch positions, then 768 text tokens
VLM_ARCH = "internvl2-26b"
VLM_BATCH = 4
VLM_PROMPT = 1024
VLM_GEN = 32
#: the f32 copies: whisper whole (3.2 GB), internvl2 at full width cut to
#: 2 of its 48 layers (~7.7 GB), as moonshot's f32 copy is cut
VLM_F32_LAYERS = 2
#: decode steps of request 0 held against fresh prefills
FAMILY_CONSISTENCY_STEPS = (1, 31)
#: the published widths the two phases must serve
PUBLISHED = {
    WHISPER_ARCH: dict(n_layers=24, encoder_layers=24, d_model=1024,
                       n_heads=16, n_kv_heads=16, head_dim=64, d_ff=4096,
                       vocab_size=51865, n_frames=1500, mlp="gelu"),
    VLM_ARCH: dict(n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
                   head_dim=128, d_ff=16384, vocab_size=92553,
                   n_patches=256, mlp="swiglu")}
FAULT_CROSS_CAUSAL = "cross-attention under a causal mask"
FAULT_ENC_CAUSAL = "the encoder's self-attention causal"
FAULT_CROSS_SHORT = "decode: the cross caches one frame short"
FAULT_NO_PATCHES = "vlm: patch_embeds ignored"
#: planted faults the bf16 comparisons of phases 18-19 read but do not
#: gate, and why: with random weights the cross-attention is a mean over
#: 1 500 near-uniformly weighted frames, a small share of the residual
#: stream, and these faults move that share by less than the rounding of
#: 24 bf16 layers (the largest logit's bf16 ulp alone is ~1.6% of it);
#: the f32 copy gates both
FAMILY_BF16_UNGATED = {
    FAULT_CROSS_CAUSAL: "the mask hides at most 223 of 1 500 frames, from "
                        "the early positions only; the f32 copy gates it",
    FAULT_CROSS_SHORT: "one of 1 500 frames moves the cross-attention "
                       "output by ~1/1 500 of a value; the f32 copy gates "
                       "it"}


def prefill_launches(cfg) -> int:
    """``flash_attn`` launches of one prefill: one per attention (enc-dec:
    each encoder layer's, and each decoder layer's self and cross)."""
    return (cfg.encoder_layers + 2 * cfg.n_layers if cfg.is_encdec
            else cfg.n_layers)


def logits_with(model, params, batch, fa_ops, attn_fn):
    """Every position's logits of a prefill of ``batch`` (f32) with the
    kernel op swapped for ``attn_fn``, on the same card tensors."""
    saved = fa_ops.flash_attention
    fa_ops.flash_attention = attn_fn
    try:
        logits, _ = model.prefill(params, batch)
    finally:
        fa_ops.flash_attention = saved
    return logits.float()


def cross_causal_attention(attn):
    """A planted fault: the cross-attention (Sq != Skv) under the causal
    mask, aligned to the last frame as the kernel aligns it."""
    return (lambda q, k, v, causal=True, **kw: attn._blockwise_attention(
        q, k, v, causal or q.shape[1] != k.shape[1]))


def encoder_causal_attention(attn):
    """A planted fault: the encoder's self-attention (the unmasked Sq ==
    Skv call) causal."""
    return (lambda q, k, v, causal=True, **kw: attn._blockwise_attention(
        q, k, v, causal or q.shape[1] == k.shape[1]))


def family_checks(torch, model, params, batch0, gen0, fa, attn, tol,
                  ungated) -> dict:
    """Request 0 (``batch0``: its tokens, frames or patches) of a served
    enc-dec or vlm model: the logits of every prompt position through the
    kernel against the plain attention; decode steps
    FAMILY_CONSISTENCY_STEPS against fresh prefills; then the planted
    faults, each read through the same comparison and each above ``tol``
    but those in ``ungated``, printed with the reason."""
    cfg = model.cfg
    out = {}
    n = prefill_launches(cfg)
    which = fa.kernel.kernel_for(getattr(torch, cfg.dtype))
    fa.ops.reset_counts()
    kern = logits_with(model, params, batch0, fa.ops, fa.ops.flash_attention)
    by_kernel = dict(fa.ops.flash_attention.launches_by_kernel)
    check(by_kernel == {"mma": n * (which == "mma"),
                        "simt": n * (which == "simt")},
          f"{cfg.name} ({cfg.dtype}), request 0: {n} {which} launches of "
          f"flash_attn in its prefill ({by_kernel})")
    check(bool(torch.isfinite(kern).all()), "prefill logits finite")
    plain_fn = plain_attention(attn)
    plain = logits_with(model, params, batch0, fa.ops, plain_fn)
    out["kernel_vs_plain_rel"] = max_rel(kern, plain)
    check(out["kernel_vs_plain_rel"] <= tol,
          f"{cfg.name}, request 0's logits at all {kern.shape[1]} positions "
          f"through the kernel vs the plain attention: max|diff| "
          f"{out['kernel_vs_plain_rel']:.4g} of max|logit| (tol {tol})")
    del kern
    prompt, steps = batch0["tokens"], FAMILY_CONSISTENCY_STEPS
    max_len = prompt.shape[1] + max(steps) + 1
    _, cache = model.prefill(params, batch0, max_len=max_len)
    dec = {}
    for t in range(1, max(steps) + 1):
        step, cache = model.decode_step(params, cache, gen0[:, t - 1])
        if t in steps:
            dec[t] = step.float()
    del cache
    out["consistency"], fresh = {}, {}
    for t in steps:
        toks = torch.cat([prompt, gen0[:, :t]], dim=1)
        fresh[t] = logits_with(model, params, dict(batch0, tokens=toks),
                               fa.ops, fa.ops.flash_attention)[:, -1]
        rel = max_rel(dec[t], fresh[t])
        out["consistency"][t] = rel
        check(rel <= tol, f"{cfg.name}, decode step {t} vs a fresh prefill "
              f"of {toks.shape[1]} tokens, last position: max|diff| "
              f"{rel:.4g} of max|logit| (tol {tol})")
    readings = {}
    if cfg.is_encdec:
        for name, fn in ((FAULT_CROSS_CAUSAL, cross_causal_attention(attn)),
                         (FAULT_ENC_CAUSAL, encoder_causal_attention(attn))):
            readings[name] = max_rel(
                logits_with(model, params, batch0, fa.ops, fn), plain)
        _, cache = model.prefill(params, batch0, max_len=max_len)
        for key in ("cross_k", "cross_v"):
            cache[key] = cache[key][:, :, :-1]
        step, _ = model.decode_step(params, cache, gen0[:, 0])
        readings[FAULT_CROSS_SHORT] = max_rel(step.float(), fresh[1])
        del cache
    if cfg.family == "vlm":
        readings[FAULT_NO_PATCHES] = max_rel(
            logits_with(model, params, {"tokens": prompt}, fa.ops, plain_fn),
            plain)
    out["planted"] = readings
    for name, rel in readings.items():
        print(f"  planted fault, {name}: max|diff| {rel:.4g} of max|logit|"
              + (f"; not gated: {ungated[name]}" if name in ungated else ""))
    for name, rel in readings.items():
        if name not in ungated:
            check(rel > tol, f"planted fault, {name}: {rel:.4g} of "
                  f"max|logit|, above the limit {tol}")
    return out


def phase_serve_family(torch, serve_mod, fa, attn, phase: int, arch: str,
                       batch: int, prompt: int, gen: int,
                       f32_layers) -> dict:
    """Phases 18-19: ``serve`` of an enc-dec or vlm config at its
    published width and depth; its checks on request 0 in bf16 and on an
    f32 copy (``f32_layers`` of its decoder layers, all if ``None``); a
    profiled prefill and 8 decode steps."""
    from repro_torch.models import build_model
    print(f"phase {phase}: serve {arch} at full width and depth -- {batch} "
          f"prompts of {prompt} positions, {gen} greedy tokens each")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(f"  device memory held before the phase: "
          f"{torch.cuda.memory_allocated()} bytes")
    fa.ops.reset_counts()
    t0 = time.perf_counter()
    res = serve_mod.serve(arch, batch=batch, prompt_len=prompt, gen=gen,
                          seed=SEED)
    wall_s = time.perf_counter() - t0
    by_kernel = dict(fa.ops.flash_attention.launches_by_kernel)
    peak = torch.cuda.max_memory_allocated()
    cfg = res.cfg
    n = prefill_launches(cfg)
    out = {"prefill_s": res.prefill_s, "decode_s": res.decode_s,
           "decode_ms_per_step": res.decode_s / res.decode_steps * 1e3,
           "decode_tok_per_s": res.decode_tok_per_s,
           "launches": fa.ops.flash_attention.launches,
           "attn_launches_by_kernel": by_kernel, "peak_bytes": peak,
           "wall_s": wall_s, "params": cfg.param_count(),
           "tokens_seq0": res.tokens[0].tolist()}
    stub = {k: tuple(v.shape) for k, v in res.inputs.items()
            if k != "tokens"}
    print(f"  {cfg.name}: {cfg.n_layers} decoder layers"
          + (f", {cfg.encoder_layers} encoder layers" if cfg.is_encdec
             else "")
          + f", d_model {cfg.d_model}, {cfg.n_heads} heads / "
          f"{cfg.n_kv_heads} kv heads of {cfg.resolved_head_dim}, "
          f"{cfg.param_count()} parameters ({cfg.dtype}); stub inputs "
          f"{stub}; prefill {res.prefill_s * 1e3:.1f} ms wall; "
          f"{res.decode_steps} decode steps {out['decode_ms_per_step']:.3f} "
          f"ms each ({res.decode_tok_per_s:.1f} tok/s); peak device memory "
          f"{peak} bytes; serve() {wall_s:.1f} s with init")
    print(f"  sample generation (seq 0): {res.tokens[0].tolist()}")
    check({k: getattr(cfg, k) for k in PUBLISHED[arch]} == PUBLISHED[arch],
          f"the published config: {PUBLISHED[arch]}")
    check(by_kernel == {"mma": n, "simt": 0},
          f"serve() launched the tensor-core flash_attn kernel {n} times, "
          f"all in its prefill, the CUDA-core one none ({by_kernel})")
    check(tuple(res.tokens.shape) == (batch, gen)
          and int(res.tokens.min()) >= 0
          and int(res.tokens.max()) < cfg.vocab_size,
          f"{batch} x {gen} tokens, all in [0, {cfg.vocab_size})")

    model = build_model(cfg)
    params, inputs = res.params, res.inputs
    gen_toks = res.tokens.to(inputs["tokens"].device)
    max_len = prompt + gen
    del res
    with torch.inference_mode():
        fa.ops.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, inputs, max_len=max_len)
        torch.cuda.synchronize()
        out["warm_prefill_s"] = time.perf_counter() - t0
        out["prefill_launches"] = fa.ops.flash_attention.launches
        check(torch.equal(logits[:, -1].argmax(-1).to(torch.int32),
                          gen_toks[:, 0]),
              f"a second (warm) prefill, {out['warm_prefill_s'] * 1e3:.1f} "
              f"ms wall, gives serve()'s first tokens")
        del logits
        model.decode_step(params, cache, gen_toks[:, 0])
        out["decode_launches"] = (fa.ops.flash_attention.launches
                                  - out["prefill_launches"])
        check(out["prefill_launches"] == n and out["decode_launches"] == 0,
              f"{out['prefill_launches']} flash_attn launches in a prefill "
              f"({n} expected), {out['decode_launches']} in a decode step")
        del cache
        batch0 = {k: v[:1] for k, v in inputs.items()}
        out["bf16"] = family_checks(torch, model, params, batch0,
                                    gen_toks[:1], fa, attn, LOGIT_TOLERANCE,
                                    FAMILY_BF16_UNGATED)
        cut = f32_layers or cfg.n_layers
        print(f"  an f32 copy of the served weights at full width, "
              f"{cut} of {cfg.n_layers} decoder layers"
              + (" and every encoder layer" if cfg.is_encdec else "")
              + ", request 0 (the CUDA-core kernel):")
        cfg32 = dataclasses.replace(cfg, dtype="float32", n_layers=cut)
        params32 = to_f32(torch, {**params, "layers": params["layers"][:cut]})
        out["f32"] = family_checks(torch, build_model(cfg32), params32,
                                   batch0, gen_toks[:1], fa, attn,
                                   F32_LOGIT_TOLERANCE, {})
        del params32
        gc.collect()
        torch.cuda.empty_cache()

        # where the time goes: one prefill and 8 decode steps, profiled
        def prefill_once():
            nonlocal cache
            _, cache = model.prefill(params, inputs, max_len=max_len)

        def decode_8():
            nonlocal cache
            for t in range(8):
                _, cache = model.decode_step(params, cache, gen_toks[:, t])

        cache = None
        out["prefill_profile"] = profile_split(torch, prefill_once)
        out["decode_profile"] = profile_split(torch, decode_8)
        del cache
    for what, prof in (("prefill", out["prefill_profile"]),
                       ("8 decode steps", out["decode_profile"])):
        print_profile(what, prof)
    prof = out["decode_profile"]
    if prof["device_ms"] is not None:
        out["launches_per_decode_step"] = prof["kernel_launches"] / 8
        print(f"  {out['launches_per_decode_step']:.1f} kernel launches per "
              f"decode step")
    del params, inputs, gen_toks
    gc.collect()
    torch.cuda.empty_cache()
    return out


def prepared(S, spec, n: int):
    """The prepared per-store arrays of one cell, as every engine gets
    them."""
    return S._prepare_cell(spec, S._trace_cached(
        spec.workload, n, spec.seed, S.PAPER_CLUSTER), n, S.PAPER_CLUSTER)


def timeline_bound_ms(n_stores: int, configs, per_lane: bool = False,
                      launches: int = 1) -> tuple:
    """Least time for store_timeline over lanes of rules ``configs``, per
    launch of ``launches`` that share them: each lane-store's inputs read
    once and 12 B of outputs per lane written once, against the f32
    operations of every lane-store under its rule. The serial mode reads
    the inputs of the lane's rule (``TIMELINE_BYTES_PER_STORE``); the
    per-step mode (``per_lane``) all five, and each lane's config_idx and
    sb_size. Returns ``(ms, "bytes"|"operations")``."""
    per_store = sum(TIMELINE_BYTES_PER_STORE["proactive" if per_lane else c]
                    for c in configs)
    nbytes = per_store * n_stores + (20 if per_lane else 12) * len(configs)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3 / launches
    t_ops = (sum(TIMELINE_OPS_PER_STORE[c] for c in configs) * n_stores
             / H100_F32_OPS_PER_S * 1e3 / launches)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_timeline_vs_plain(torch, S, Sc, stl) -> float:
    print("phase 10: store_timeline kernel against the plain version on "
          "the card")
    dev = torch.device(DEVICE)
    cpu = torch.device("cpu")
    costs = S._commit_cost_ns("proactive", S.PAPER_CLUSTER)
    knobs = {"t_l1": costs["t_l1"], "t_wt": costs["t_wt"]}
    fig10 = Sc.fig10_grid()
    five = [s for s in fig10 if s.workload == "canneal"]
    chunk = stl.kernel.load().store_timeline_chunk_stores()
    op = stl.ops.store_timeline
    max_err = 0.0

    def same(got, want, what):
        nonlocal max_err
        got = [g.cpu() for g in got]
        want = [w.cpu() for w in want]
        err = float((got[0] - want[0]).abs().max())
        max_err = max(max_err, err)
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"{what}: kernel == plain (max_abs_err {err})")

    def serial(n, depths, plain_dev, view=lambda x: x, what=""):
        """Each rule of `depths` on canneal's Fig. 10 cells at n stores;
        `view` cuts the inputs on both sides."""
        for spec in five:
            cell = prepared(S, spec, n)
            on_card = tuple(view(x) for x in S._to_device(cell, dev))
            plain_in = tuple(view(x) for x in S._to_device(cell, plain_dev))
            for sb in depths[spec.config]:
                got, rings = rings_used(op, lambda: stl.store_timeline(
                    *on_card, config=spec.config, sb=sb, **knobs))
                want = stl.store_timeline_ref(*plain_in, config=spec.config,
                                              sb=sb, **knobs)
                same(got, want, f"serial n={on_card[0].shape[0]}{what} "
                     f"{spec.workload}/{spec.config} sb={sb} "
                     f"({'/'.join(rings)} ring)")
                check(rings == [stl.kernel.ring_for(sb)],
                      f"sb={sb} ran on the {stl.kernel.ring_for(sb)} ring")

    check(stl.kernel.ring_for(48) == stl.kernel.ring_for(72) == "register"
          and stl.kernel.ring_for(7) == "shared"
          and stl.kernel.ring_for(500) == "scratch",
          "sb 48 and 72 keep their ring in registers, sb 7 in shared "
          "memory, sb 500 in scratch")
    # serial mode: every rule at sb 1, 7, 48, 72, 500 at a ragged n = 2 003
    # (plain version on the card); at the path's 50 000 stores every rule
    # at sb 48 and 72 and proactive also at 1, 7, 500 (plain version on
    # CPU tensors of the same inputs)
    serial(2003, {c: (1, 7, 48, 72, 500) for c in S.CONFIGS}, dev)
    serial(N_STORES, {c: (48, 72) + ((1, 7, 500) if c == "proactive"
                                     else ()) for c in S.CONFIGS}, cpu)
    # n = 1, 5 and one either side of the kernel's chunk (the tail paths)
    for n in (1, 5, chunk - 1, chunk + 1):
        serial(n, {c: (7, 48, 72) for c in S.CONFIGS}, dev)
    # contiguous views that start at element 1: no input 16-byte aligned
    serial(2004, {c: (7, 72) for c in S.CONFIGS}, dev,
           view=lambda x: x[1:], what=" (views from element 1)")

    # per-step mode: Fig. 10's own batch (48 lanes, every one sb 72: the
    # register ring), a mixed-SB batch (sb 16 / 48 / 72
    # / 200: shared) and one past the shared ring (sb 16 / 48 / 400 / 500:
    # scratch), padded lanes repeating cell 0
    mixed = [dataclasses.replace(s, sb_size=(16, 48, 72, 200)[i % 4])
             for i, s in enumerate(fig10[:21])]
    deep = [dataclasses.replace(s, sb_size=(16, 48, 400, 500)[i % 4])
            for i, s in enumerate(fig10[:21])]
    cases = [(fig10, n, d) for n, d in ((1, dev), (5, dev), (chunk - 1, dev),
                                        (chunk + 1, dev), (2003, dev),
                                        (N_STORES, cpu))]
    cases += [(mixed, n, d) for n, d in ((chunk + 1, dev), (2003, dev),
                                         (N_STORES, cpu))]
    cases += [(deep, 2003, dev)]
    for specs, n, plain_dev in cases:
        args, sb_max, _, sb_uniform = S._stack_cells([prepared(S, s, n)
                                                      for s in specs])
        on_card = tuple(torch.from_numpy(a).to(dev) for a in args)
        plain_in = tuple(torch.from_numpy(a).to(plain_dev) for a in args)
        got, rings = rings_used(op, lambda: stl.store_timeline_batch(
            *on_card, sb_max=sb_max, **knobs))
        want = stl.store_timeline_batch_ref(*plain_in, sb_max=sb_max,
                                            **knobs)
        depths = sorted(set(args[6].tolist()))
        same(got, want, f"per-step n={n}, {len(specs)} cells in "
             f"{args[0].shape[1]} lanes, sb {'/'.join(map(str, depths))} "
             f"({'/'.join(rings)} ring, {sb_max} slots)")
        check(rings == [stl.kernel.ring_for(sb_uniform, sb_max)],
              f"per-step batch of sb {'/'.join(map(str, depths))} ran on "
              f"the {stl.kernel.ring_for(sb_uniform, sb_max)} ring")
    args, sb_max, _, _ = S._stack_cells([prepared(S, s, 2003)
                                         for s in mixed])
    on_card = tuple(torch.from_numpy(a).to(dev) for a in args)
    bad = torch.tensor([72, sb_max + 1], dtype=torch.int32, device=dev)
    two = tuple(x[:, :2].contiguous() for x in on_card[:5])
    c, ah, sf = stl.store_timeline_batch(*two, on_card[5][:2].contiguous(),
                                         bad, sb_max=sb_max, **knobs)
    check(bool(torch.isnan(c[1])) and int(ah[1]) == -1 and int(sf[1]) == -1
          and not bool(torch.isnan(c[0])),
          "a lane deeper than its ring gives NaN / -1, not a fault")
    return max_err


def phase_fig10_routes(torch, S, E, C, Sc, stl, bs_ops) -> dict:
    print("phase 11: Fig. 10 at n_stores=50 000 through the serial, "
          "per-step, stacked and banked routes")
    specs = Sc.fig10_grid()
    dev = torch.device(DEVICE)
    routes = (
        ("serial", "serial", "stacked", lambda: E.simulate_grid(
            specs, n_stores=N_STORES, engine="serial")),
        ("per-step", "perstep", "stacked", lambda: S.simulate_batch(
            specs, n_stores=N_STORES, chunk_size=0)),
        ("stacked", "blocked", "stacked", lambda: S.simulate_batch(
            specs, n_stores=N_STORES, data_plane="stacked")),
        ("banked", "blocked", "bank", lambda: S.simulate_batch(
            specs, n_stores=N_STORES)),
    )
    res, walls, counts, rings = {}, {}, {}, {}
    for name, engine, plane, run in routes:
        S.clear_sim_caches()
        stl.ops.reset_counts()
        bs_ops.bank_scan.launches = 0
        t0 = time.perf_counter()
        res[name] = run()
        walls[name] = time.perf_counter() - t0
        counts[name] = {**stl.ops.store_timeline.launches_by_mode,
                        "bank_scan": bs_ops.bank_scan.launches}
        rings[name] = dict(stl.ops.store_timeline.launches_by_ring)
        print(f"  {name}: wall {walls[name]:.3f} s (caches cleared "
              f"first), launches {counts[name]}, store_timeline by ring "
              f"{rings[name]}")
        check(all(r.meta["engine"] == engine and r.meta["data_plane"] == plane
                  for r in res[name]),
              f"{name}: every cell ran engine={engine}, data_plane={plane}")
    groups = len({s.sb_size for s in specs})
    want = {"serial": {"serial": len(specs), "perstep": 0, "bank_scan": 0},
            "per-step": {"serial": 0, "perstep": 1, "bank_scan": 0},
            "stacked": {"serial": 0, "perstep": 0, "bank_scan": groups},
            "banked": {"serial": 0, "perstep": 0, "bank_scan": 1}}
    for name in want:
        check(counts[name] == want[name], f"{name} launches {want[name]}")
    check(rings["serial"] == {"register": len(specs), "shared": 0,
                              "scratch": 0}
          and rings["per-step"] == {"register": 1, "shared": 0,
                                    "scratch": 0},
          f"all {len(specs)} serial launches and the per-step launch took "
          f"the register ring (sb 72)")
    serial = [fields(r) for r in res["serial"]]
    for name in ("per-step", "stacked", "banked"):
        check([fields(r) for r in res[name]] == serial,
              f"every field of the {len(specs)} cells: {name} == serial")
    for spec in (specs[4], specs[17], specs[42]):
        o = C.serial_oracle(spec, n_stores=N_STORES)
        check(fields(o) == serial[specs.index(spec)],
              f"serial route {spec.workload}/{spec.config} == the per-store "
              f"numpy oracle")
    gm = S.geomean_slowdowns(S.slowdowns_from_results(res["serial"]))
    check(all(gm[c] == v for c, v in JAX_GEOMEANS_50K.items()),
          "serial route's geomeans == the JAX package's at 50 000 stores")

    # the kernel alone: the 45 serial launches, inputs already on the card
    costs = S._commit_cost_ns("proactive", S.PAPER_CLUSTER)
    knobs = {"t_l1": costs["t_l1"], "t_wt": costs["t_wt"]}
    cells = [prepared(S, s, N_STORES) for s in specs]
    on_card = [S._to_device(c, dev) for c in cells]

    def serial_all():
        for spec, cell, x in zip(specs, cells, on_card):
            stl.store_timeline(*x, config=spec.config, sb=cell.sb_size,
                               **knobs)

    serial_ms = cuda_ms(serial_all, 2) / len(specs)
    by_config = {}
    for i, spec in enumerate(specs[:5]):
        by_config[spec.config] = cuda_ms(lambda: stl.store_timeline(
            *on_card[i], config=spec.config, sb=cells[i].sb_size, **knobs),
            10)
    _, args, _, sb_max, _, sb_uniform = S._batch_inputs(
        tuple(specs), N_STORES, S.PAPER_CLUSTER, dev)

    def perstep_launch(ring):
        return lambda: stl.kernel.launch(
            *args, stl.kernel.PER_LANE_CONFIG,
            sb_uniform if ring == "register" else 0, sb_max, ring,
            knobs["t_l1"], knobs["t_wt"])

    # the kernel alone on the register ring and, as a batch of mixed
    # depths runs, on the shared ring; then the op, which also reads the
    # lanes' depths back to pick the ring
    perstep_ms = cuda_ms(perstep_launch("register"), 10)
    perstep_shared_ms = cuda_ms(perstep_launch("shared"), 10)
    perstep_op_ms = cuda_ms(lambda: stl.store_timeline_batch(
        *args, sb_max=sb_max, **knobs), 10)
    sm_mhz = sm_clock_mhz(torch, lambda: stl.store_timeline(
        *on_card[4], config="proactive", sb=cells[4].sb_size, **knobs))
    floor_ms = chain_floor_ms(N_STORES, sm_mhz)
    t0 = time.perf_counter()
    stl.store_timeline_ref(*on_card[4], config="proactive",
                           sb=cells[4].sb_size, **knobs)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    # the serial launches' mean bound, each launch reading its rule's
    # inputs; the per-step launch reads all five for every lane
    bound_ms, bound_by = timeline_bound_ms(
        N_STORES, [s.config for s in specs], launches=len(specs))
    bound_by_config = {c: timeline_bound_ms(N_STORES, [c])[0]
                       for c in by_config}
    pbound_ms, pbound_by = timeline_bound_ms(
        N_STORES, [S.CONFIGS[i] for i in args[5].tolist()], per_lane=True)
    print(f"  store_timeline: {serial_ms:.4f} ms per serial launch (mean "
          f"over the {len(specs)} cells, CUDA events, 2 passes); by rule "
          + ", ".join(f"{c} {v:.4f}" for c, v in by_config.items())
          + f" ms (mean of 10); per-step launch over {args[0].shape[1]} "
          f"lanes {perstep_ms:.4f} ms on the register ring, "
          f"{perstep_shared_ms:.4f} ms on the shared one, "
          f"{perstep_op_ms:.4f} ms through the op (means of 10); "
          f"plain version on the card, one proactive cell, "
          f"{plain_ms:.1f} ms; bound {bound_ms:.6f} ms ({bound_by}, the "
          f"mean of the serial launches, each its rule's inputs; by rule "
          + ", ".join(f"{c} {v:.6f}" for c, v in bound_by_config.items())
          + f" ms; {pbound_ms:.6f} ms ({pbound_by}) for the per-step "
          f"launch); chain floor {floor_ms:.4f} ms "
          f"({N_STORES} stores x {CHAIN_OPS_PER_STORE} dependent f32 ops x "
          f"{CHAIN_OP_CYCLES} cycles at clocks.sm {sm_mhz:.0f} MHz, read "
          f"during the launches)")
    return {"walls_s": walls, "launches": counts, "rings": rings,
            "serial_ms": serial_ms, "ms_by_config": by_config,
            "bound_ms_by_config": bound_by_config,
            "perstep_ms": perstep_ms, "perstep_shared_ms": perstep_shared_ms,
            "perstep_op_ms": perstep_op_ms,
            "perstep_lanes": int(args[0].shape[1]), "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "perstep_bound_ms": pbound_ms, "chain_floor_ms": floor_ms,
            "sm_mhz": sm_mhz, "geomeans": gm}


def phase_mega_stacked(torch, S, E, Sc, T, stl, bs_ops) -> dict:
    print("phase 12: mega-grid at n_stores=50 000 on the stacked stream "
          "tier, against the banked stream tier and the serial oracle")
    specs = Sc.mega_grid()
    S.clear_sim_caches()
    bs_ops.bank_scan.launches = 0
    t0 = time.perf_counter()
    banked = Sc.run_sweep(specs, n_stores=N_STORES)
    banked_s = time.perf_counter() - t0
    banked_launches = bs_ops.bank_scan.launches
    check(banked_launches == MEGA_TILES,
          f"banked stream tier: {MEGA_TILES} launches, {banked_s:.3f} s wall")
    S.clear_sim_caches()
    stl.ops.reset_counts()
    bs_ops.bank_scan.launches = 0
    with T.recording():
        t0 = time.perf_counter()
        stacked = Sc.run_sweep(specs, n_stores=N_STORES, engine="stream",
                               data_plane="stacked")
        wall_s = time.perf_counter() - t0
    launches = bs_ops.bank_scan.launches
    stats = E.bank_stats()
    summ = stats.pop("telemetry")
    print(f"  wall {wall_s:.3f} s; bank_stats: {json.dumps(stats)}")
    check(stats["data_plane"] == "stacked" and stats["bank_partition"] is None
          and stats["h2d_bytes"] == stats["stacked_h2d_bytes"]
          and stats["scan_lanes"] == len(specs),
          f"bank_stats reports the stacked plane ({stats['h2d_bytes']} "
          f"bytes host -> device, every cell a lane)")
    check(launches == stats["tiles"] and launches > 0
          and stl.ops.store_timeline.launches == 0,
          f"one bank_scan launch per tile ({launches} launches, "
          f"{stats['tiles']} tiles)")
    check(all(r.meta["engine"] == "streamed"
              and r.meta["data_plane"] == "stacked" for r in stacked),
          "every cell streamed on the stacked plane")
    check([fields(r) for r in stacked] == [fields(r) for r in banked],
          f"every field of the {len(specs)} cells: stacked stream tier == "
          f"banked stream tier")
    # the benchmarks' sampler (5 cells at 12 960) and the last cell
    n = len(specs)
    sample = sorted(set(range(0, n, max(1, n // 5))) | {n - 1})
    stl.ops.reset_counts()
    for i in sample:
        o = S.simulate_spec(specs[i], n_stores=N_STORES)
        check(fields(o) == fields(stacked[i]),
              f"cell {i} ({specs[i].workload}/{specs[i].config}, sb "
              f"{specs[i].sb_size}) == simulate_spec")
    serial_launches = stl.ops.store_timeline.launches
    serial_rings = dict(stl.ops.store_timeline.launches_by_ring)
    check(serial_launches == len(sample),
          f"{serial_launches} store_timeline launches for the sampled cells "
          f"(by ring {serial_rings})")
    spans = summ["spans"]
    split = {k: spans.get(k, {}).get("total", 0.0) for k in
             ("tile/prep", "tile/h2d", "tile/dispatch", "tile/drain")}
    print(f"  telemetry (ms, spans; tile/prep runs on the prefetch "
          f"thread): {json.dumps(split)}")
    return {"wall_s": wall_s, "banked_wall_s": banked_s,
            "launches": launches, "banked_launches": banked_launches,
            "serial_launches": serial_launches, "serial_rings": serial_rings,
            "bank_stats": stats,
            "telemetry_ms": split, "sampled": sample}


def pct(xs, q: float) -> float:
    """Nearest-rank percentile ``q`` of ``xs`` (ms)."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * q))] if xs else 0.0


def phase_serving(torch, S, E, Sc, sv, kernel, ops, mega_res) -> dict:
    print("phase 13: ScenarioServer at n_stores=50 000, 4 logical shards, "
          "64-lane serve tiles: the mega-grid warmed, then a seeded stream "
          "of 500 queries, a submit burst, a grid query and a downtime query")
    import numpy as np
    mega = Sc.mega_grid()
    index = {s: i for i, s in enumerate(mega)}
    novel = Sc.grid_delta(mega, seeds=(3,),
                          workloads=("ycsb", "canneal", "barnes"),
                          sb_sizes=(72, 48))
    check(len(novel) == 30, f"{len(novel)} novel cells (seed 3)")
    rng = np.random.default_rng(SEED)
    stream = [mega[rng.integers(len(mega))] if rng.random() < 0.7
              else novel[rng.integers(len(novel))]
              for _ in range(SERVE_QUERIES)]
    S.clear_sim_caches()
    srv = sv.ScenarioServer(n_stores=N_STORES, n_shards=SERVE_SHARDS,
                            batch_cells=64)
    with srv:
        t0 = time.perf_counter()
        srv.warm(mega)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        st = srv.stats()
        check(st["bank_rows"] == 27 + 1298 and st["lanes_cached"] == 2700,
              f"warm: {len(mega)} cells, {st['bank_rows']} bank rows, "
              f"{st['lanes_cached']} lanes, {warm_s:.3f} s")
        check(st["bank_capacity"] == (256, 512),
              f"capacity {st['bank_capacity']} (trace rows, local wv rows "
              f"per shard); {st['bank_dev_bytes']} bytes resident")
        warm_dev_bytes = st["bank_dev_bytes"]
        srv.reset_stats()
        tc0 = E.trace_count()
        lib0 = kernel.LIBRARY._lib, kernel.LIBRARY.last_build
        ops.bank_scan.launches = 0
        hit_ms, miss_ms, answers = [], [], []
        t0 = time.perf_counter()
        for spec in stream:
            t1 = time.perf_counter()
            r = srv.query(spec)
            (hit_ms if r.meta["cache"] == "hit" else miss_ms).append(
                (time.perf_counter() - t1) * 1e3)
            answers.append(r)
        stream_s = time.perf_counter() - t0
        launches = ops.bank_scan.launches
        st = srv.stats()
        burst = [f.result(timeout=600) for f in
                 [srv.submit(s) for s in stream[:64]]]
        grid_q = srv.query_grid(workloads=("streamcluster",),
                                configs=("proactive",), n_replicas=(2, 4))
        est = srv.query_downtime("ycsb", fail_time_ms=50.0, n_cns=8)
        new_programs = E.trace_count() - tc0
        same_lib = (kernel.LIBRARY._lib, kernel.LIBRARY.last_build) == lib0
        dev_bytes = srv.stats()["bank_dev_bytes"]
    print(f"  stream: {len(stream)} queries in {stream_s:.3f} s "
          f"({len(stream) / stream_s:.1f} q/s); hits {len(hit_ms)}: p50 "
          f"{pct(hit_ms, 0.5):.4f} ms p99 {pct(hit_ms, 0.99):.4f} ms; "
          f"misses {len(miss_ms)}: p50 {pct(miss_ms, 0.5):.3f} ms p99 "
          f"{pct(miss_ms, 0.99):.3f} ms; h2d "
          f"{st['h2d_bytes'] / len(stream):.1f} bytes per query; "
          f"{launches} bank_scan launches; resident bank "
          f"{dev_bytes} bytes")
    check(len(miss_ms) == st["lane_misses"] == len(set(stream) - set(mega)),
          f"{len(miss_ms)} misses, one per novel cell asked")
    check(launches == st["lane_misses"],
          f"one bank_scan launch per miss flush ({launches})")
    check(new_programs == 0 and st["compiled_programs"] == 0,
          "zero new tile programs after warm")
    check(same_lib, "zero new kernel builds after warm (the library "
          "loaded before the stream is the one that ran)")
    check(dev_bytes == warm_dev_bytes, "resident bank bytes unchanged")
    for spec, r in zip(stream[:64], burst):
        check_answer(r, answers[stream.index(spec)], "submit burst")
    for spec, r in zip(stream, answers):
        if spec in index:
            if fields(r) != fields(mega_res[index[spec]]):
                raise SmokeFailure(f"{spec} served != phase 4's answer")
    n_hits = sum(s in index for s in stream)
    check(True, f"{n_hits} mega-grid answers == phase 4's stream-tier "
          f"results")
    asked = list(dict.fromkeys(s for s in stream if s not in index))
    blocked = E.simulate_grid(asked + list(Sc.sweep_grid(
        workloads=("streamcluster",), configs=("proactive",),
        n_replicas=(2, 4))), n_stores=N_STORES, engine="blocked")
    by_spec = {s: r for s, r in zip(stream, answers)}
    for spec, want in zip(asked, blocked):
        check_answer(by_spec[spec], want, "novel cell vs blocked oracle")
    check(True, f"{len(asked)} novel answers == simulate_grid(engine="
          f"\"blocked\") on the card")
    for r, want in zip(grid_q, blocked[len(asked):]):
        check_answer(r, want, "query_grid vs blocked oracle")
    check(True, f"query_grid: {len(grid_q)} cells == the blocked oracle")
    for spec in asked[:3]:
        check_answer(by_spec[spec], S.simulate_spec(spec, n_stores=N_STORES),
                     "novel cell vs simulate_spec")
    check(True, "three novel cells == simulate_spec")
    want = Sc.downtime_query("ycsb", 50.0, n_cns=8)
    check(est == want, f"query_downtime == downtime_query "
          f"({est.total_ns / 1e6:.4f} ms)")
    return {"warm_s": warm_s, "queries": len(stream), "stream_s": stream_s,
            "qps": len(stream) / stream_s, "hits": len(hit_ms),
            "misses": len(miss_ms), "hit_p50_ms": pct(hit_ms, 0.5),
            "hit_p99_ms": pct(hit_ms, 0.99), "miss_p50_ms": pct(miss_ms, 0.5),
            "miss_p99_ms": pct(miss_ms, 0.99),
            "h2d_bytes_per_query": st["h2d_bytes"] / len(stream),
            "launches": launches, "bank_dev_bytes": dev_bytes,
            "bank_capacity": st["bank_capacity"]}


def check_answer(got, want, what: str) -> None:
    if fields(got) != fields(want):
        raise SmokeFailure(f"{what}: {got} != {want}")


def phase_resilience(torch, S, E, Sc, chaos, launcher, ops,
                     mega_res) -> dict:
    print("phase 14: resilience on the card: the mega-grid at 4 logical "
          "shards with a replica set, a lost shard, a corrupt row, a "
          "degraded finish, and the serving launcher's shard-loss demo")
    import contextlib
    import io
    mega = Sc.mega_grid()
    want = [fields(r) for r in mega_res]
    out = {"launches": 0}
    S.clear_sim_caches()
    ops.bank_scan.launches = 0
    t0 = time.perf_counter()
    clean = E.run_grid(mega, n_stores=N_STORES, n_shards=SERVE_SHARDS,
                       k_replicas=2)
    out["clean_wall_s"] = time.perf_counter() - t0
    stats = E.bank_stats()
    out["launches"] += ops.bank_scan.launches
    check([fields(r) for r in clean] == want
          and stats["k_replicas"] == 2 and stats["tiles"]
          == ops.bank_scan.launches,
          f"fault-free: {stats['tiles']} tiles at {SERVE_SHARDS} shards, "
          f"k_replicas 2, one launch each, every cell == phase 4 "
          f"({out['clean_wall_s']:.3f} s, {stats['bank_dev_bytes']} bytes "
          f"resident)")
    for name, cfg in (
            ("shard loss", chaos.ChaosConfig(lose_shard=3,
                                             lose_at_dispatch=5)),
            ("corrupt row", chaos.ChaosConfig(corrupt_wv_row=0,
                                              verify_rows=True))):
        tc0 = E.trace_count()
        ops.bank_scan.launches = 0
        t0 = time.perf_counter()
        with chaos.inject(cfg) as cs:
            res = E.run_grid(mega, n_stores=N_STORES, n_shards=SERVE_SHARDS,
                             k_replicas=2)
        wall = time.perf_counter() - t0
        out["launches"] += ops.bank_scan.launches
        rep = cs.report()
        rec = rep["recoveries"]
        check([fields(r) for r in res] == want,
              f"{name}: every cell == phase 4 ({wall:.3f} s, "
              f"{ops.bank_scan.launches} launches)")
        if cfg.lose_shard is not None:
            check(len(rec) == 1 and rec[0]["shard"] == 3
                  and rec[0]["source"] == "replica",
                  f"one recovery of shard 3 from the replica block "
                  f"({rec[0]['ms']:.2f} ms)" if rec else "one recovery")
        else:
            check(rep["detection_dispatches"] is not None and len(rec) == 1,
                  f"detected by digest after {rep['detection_dispatches']} "
                  f"dispatches, recovered from {rec[0]['source']} "
                  f"({rec[0]['ms']:.2f} ms)" if rec else "detected")
        check(E.trace_count() == tc0, f"{name}: zero new tile programs")
        out[name] = {"wall_s": wall, "report": {k: rep[k] for k in (
            "dispatches", "recoveries", "detection_dispatches",
            "detection_ms", "recovery_ms")}}
    tc0 = E.trace_count()
    ops.bank_scan.launches = 0
    t0 = time.perf_counter()
    with chaos.inject(chaos.ChaosConfig(lose_shard=3, lose_at_dispatch=5,
                                        recovery="degraded")) as cs:
        res = E.run_grid(mega, n_stores=N_STORES, n_shards=SERVE_SHARDS,
                         k_replicas=2)
    wall = time.perf_counter() - t0
    out["launches"] += ops.bank_scan.launches
    rec = cs.report()["recoveries"]
    check([fields(r) for r in res] == want and E.bank_stats()["degraded"]
          and rec and rec[0]["source"] == "degraded-mesh",
          f"degraded: every cell == phase 4 ({wall:.3f} s), finished on "
          f"{SERVE_SHARDS - 1} shards, replicated")
    check(E.trace_count() - tc0 == 2,
          f"degraded: {E.trace_count() - tc0} new programs, one per SB group")
    out["degraded"] = {"wall_s": wall, "recoveries": rec}
    S.clear_sim_caches()
    ops.bank_scan.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        launcher.main(["--stores", str(N_STORES), "--queries", "200",
                       "--shards", str(SERVE_SHARDS), "--lose-shard", "3",
                       "--check"])
    wall = time.perf_counter() - t0
    out["launches"] += ops.bank_scan.launches
    text = buf.getvalue()
    for line in text.splitlines():
        print(f"  | {line}")
    check("oracle check: 200 answers bit-identical" in text,
          "launcher: 200 answers == the blocked oracle")
    check("shard 3 lost, recovered from replica" in text,
          "launcher: shard 3 recovered from the replica block")
    check("post-recovery tile programs 0" in text,
          f"launcher: 0 post-recovery tile programs ({wall:.1f} s)")
    out["launcher_wall_s"] = wall
    return out


#: phase 20: training. The backward kernel's shapes, (name, B, Sq, Skv, H,
#: K, D, causal, dtypes): qwen3-0.6b's training shape (train_4k's 4 096
#: positions, batch 4), hymba-1.5b's, whisper-medium's encoder and
#: cross-attention (unmasked, Skv 1 500 not a multiple of the 64-key
#: tile, Sq != Skv), stablelm-12b's head dim 160
BWD_CASES = [
    ("qwen3-0.6b train", 4, 4096, 4096, 16, 8, 128, True, ("bfloat16",)),
    ("hymba-1.5b", 4, 4096, 4096, 25, 5, 64, True, ("bfloat16",)),
    ("whisper-medium encoder", 8, 1500, 1500, 16, 16, 64, False,
     ("bfloat16",)),
    ("whisper-medium cross", 8, 224, 1500, 16, 16, 64, False,
     ("bfloat16", "float32")),
    ("stablelm-12b", 1, 2048, 2048, 32, 8, 160, True,
     ("bfloat16", "float32")),
]
#: dq, dk, dv each held to its own max|value|: f32 in the forward's
#: 1e-5 class (sums in another order); bf16 in its 2e-2 class against the
#: plain version on the same bf16 inputs (which rounds p to bf16 as the
#: kernel does) and against an f32 oracle (the exact gradient of the
#: f32 function at the bf16 inputs)
BWD_TOLERANCE = {"float32": 1e-5, "bfloat16": 2e-2}
BWD_TOLERANCE_TEXT = ("dq, dk, dv each within 1e-5 (f32) / 2e-2 (bf16) of "
                      "its own max|value|, against attention_bwd_ref on the "
                      "same inputs, the kernel's own output and lse; bf16 "
                      "also against an f32 oracle at 2e-2")
FAULT_BWD_GQA = ("backward: dK / dV of the group's first query head, not "
                 "summed over the GQA group")
FAULT_BWD_CAUSAL = "backward: the causal mask dropped"
#: the bf16 backward's tensor-core kernels against its CUDA-core ones on
#: the same inputs, at qwen3-0.6b's training shape: at least this factor
BWD_MIN_SPEEDUP = 4.0
#: the (spill store, spill load) bytes ptxas may give a tensor-core
#: backward kernel, (kernel, D): the dK / dV kernel at D 32, which ptxas
#: holds to 128 registers; every other instantiation none
BWD_MMA_SPILLS = {("flash_attn_bwd_dkdv_mma_kernel", 32): (8, 12)}
TRAIN_ARCH = "qwen3-0.6b"
TRAIN_SEQ = 4096                 # train_4k's sequence length
TRAIN_BATCH = 4                  # train_4k's global batch 256, cut to a card
TRAIN_STEPS = 6
TRAIN_FAIL = (3, 2)              # (step, node): a fail-stop
TRAIN_DUMP_INTERVAL = 5          # one MN dump, after step 4
TRAIN_LOG_CAPACITY = 2
TRAIN_F32_LAYERS = 2
#: the gradients of loss_fn with attention through the kernels against
#: through the plain version, each leaf relative to its max|grad|: the f32
#: copy at the reference model test's f32 class
TRAIN_GRAD_TOLERANCE = 1e-4


def bwd_bound_ms(torch, q, k, causal: bool) -> tuple:
    """q, k, v, out, dout and lse read once, dq, dk, dv written once,
    against the five products of the backward: 10 D operations per
    allowed (query, key) pair (s, dP, dV, dK, dQ)."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    es = q.element_size()
    nbytes = (4 * q.numel() + 4 * k.numel()) * es + b * h * sq * 4
    if causal:
        off = skv - sq
        pairs = sum(min(i + off + 1, skv) for i in range(sq))
    else:
        pairs = sq * skv
    return bound(nbytes, 10.0 * d * pairs * b * h, rate_for(torch, q.dtype))


def per_batch(torch, fn, *ts):
    """``fn`` over one batch element at a time, the results concatenated:
    the plain version's (B, H, S, S) f32 scores one request at a time."""
    outs = [fn(*(t[i:i + 1] for t in ts)) for i in range(ts[0].shape[0])]
    return tuple(torch.cat([o[j] for o in outs]) for j in range(3))


def grads_rel(got, want) -> float:
    return max(max_rel(g.float(), w.float()) for g, w in zip(got, want))


def check_bwd_case(torch, fa, randn, case, dtype) -> dict:
    """One shape and dtype of the backward kernel against its plain
    version (and, bf16, an f32 oracle), its planted faults, its time
    beside its bound, the plain version's and SDPA's forward + backward."""
    ref = fa.ref
    name, b, sq, skv, h, kh, d, causal, _ = case
    q = randn(b, sq, h, d, dtype=dtype)
    k, v = (randn(b, skv, kh, d, dtype=dtype) for _ in range(2))
    do = randn(b, sq, h, d, dtype=dtype)
    out, lse = fa.kernel.launch(q, k, v, causal, with_lse=True)
    got = fa.kernel.launch_bwd(q, k, v, out, lse, do, causal)
    again = fa.kernel.launch_bwd(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    want = per_batch(torch, lambda *t: ref.attention_bwd_ref(*t, causal),
                     q, k, v, out, lse, do)
    r = {"shape": case[:8], "dtype": dtype,
         "kernel": fa.kernel.bwd_kernel_for(getattr(torch, dtype)),
         "deterministic": same,
         "vs_plain": [max_rel(g.float(), w.float())
                      for g, w in zip(got, want)],
         "max_abs_err": max(float((g.float() - w.float()).abs().max())
                            for g, w in zip(got, want))}
    if r["kernel"] != "simt":
        # the CUDA-core kernels, the yardstick, on the same inputs
        simt = fa.kernel.launch_bwd(q, k, v, out, lse, do, causal,
                                    which="simt")
        r["simt_vs_plain"] = [max_rel(g.float(), w.float())
                              for g, w in zip(simt, want)]
        del simt
    del want
    tol = BWD_TOLERANCE[dtype]
    if dtype == "bfloat16":
        def oracle(qi, ki, vi, doi):
            qf, kf, vf = qi.float(), ki.float(), vi.float()
            return ref.attention_bwd_ref(
                qf, kf, vf, ref.attention_ref(qf, kf, vf, causal),
                ref.attention_lse_ref(qf, kf, causal), doi.float(), causal)
        f32 = per_batch(torch, oracle, q, k, v, do)
        r["vs_f32_oracle"] = [max_rel(g.float(), w) for g, w in zip(got, f32)]
        del f32
    faults = {}
    g = h // kh
    if g > 1:
        ke, ve = (t.repeat_interleave(g, dim=2) for t in (k, v))
        _, dke, dve = fa.kernel.launch_bwd(q, ke, ve, out, lse, do, causal)
        faults[FAULT_BWD_GQA] = grads_rel((got[0], dke[:, :, ::g],
                                           dve[:, :, ::g]), got)
        del ke, ve, dke, dve
    if causal:
        faults[FAULT_BWD_CAUSAL] = grads_rel(
            fa.kernel.launch_bwd(q, k, v, out, lse, do, False), got)
    r["planted"] = faults
    what = (f"flash_attn backward ({r['kernel']}) at {name}'s shape (B {b}, "
            f"Sq {sq}, Skv {skv}, H {h}, K {kh}, D {d}, {dtype}, "
            f"{'causal' if causal else 'no mask'})")
    print(f"  {what}: dq, dk, dv vs plain {r['vs_plain']}"
          + (f", vs the f32 oracle {r['vs_f32_oracle']}"
             if "vs_f32_oracle" in r else "")
          + (f", the CUDA-core kernels vs plain {r['simt_vs_plain']}"
             if "simt_vs_plain" in r else "") + f"; planted {faults}")
    check(max(r["vs_plain"]) <= tol, f"{what}: kernel vs plain, largest "
          f"{max(r['vs_plain']):.4g} of max|grad| (tol {tol})")
    if "simt_vs_plain" in r:
        check(max(r["simt_vs_plain"]) <= tol, f"{what}: the CUDA-core "
              f"kernels vs plain, largest {max(r['simt_vs_plain']):.4g} "
              f"(tol {tol})")
    if "vs_f32_oracle" in r:
        check(max(r["vs_f32_oracle"]) <= tol,
              f"{what}: kernel vs f32 oracle, largest "
              f"{max(r['vs_f32_oracle']):.4g} (tol {tol})")
    for fault, rel in faults.items():
        check(rel > tol, f"{what}: planted fault ({fault}) reads "
              f"{rel:.4g}, above the limit {tol}")
    check(same, f"{what}: two launches give bit-identical dq, dk, dv")
    # times: the backward kernels, (bf16) the CUDA-core ones on the same
    # inputs, the forward with lse, SDPA's forward + backward, in turns;
    # the plain version one request at a time
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    dot = do.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_fwd_bwd():
        o = sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
        o.backward(dot)

    runs = {"ms": lambda: fa.kernel.launch_bwd(q, k, v, out, lse, do,
                                               causal),
            "fwd_lse_ms": lambda: fa.kernel.launch(q, k, v, causal,
                                                   with_lse=True),
            "library_ms": sdpa_fwd_bwd}
    if r["kernel"] != "simt":
        runs["simt_ms"] = lambda: fa.kernel.launch_bwd(
            q, k, v, out, lse, do, causal, which="simt")
    # the split: the prep with the dQ kernel alone, with the dK / dV one
    runs["dq_ms"] = lambda: fa.kernel.launch_bwd(q, k, v, out, lse, do,
                                                 causal, need_dkv=False)
    runs["dkdv_ms"] = lambda: fa.kernel.launch_bwd(q, k, v, out, lse, do,
                                                   causal, need_dq=False)
    times = {key: [] for key in runs}
    for order in (list(runs), list(runs)[::-1]):
        for key in order:
            times[key].append(cuda_ms(runs[key], 10))
    r.update({key: sum(ts) / len(ts) for key, ts in times.items()})
    r.setdefault("simt_ms", None)
    r["turns"] = times
    r["fwd_bwd_ms"] = r["ms"] + r["fwd_lse_ms"]
    r["plain_ms"] = cuda_ms(lambda: per_batch(
        torch, lambda *t: ref.attention_bwd_ref(*t, causal),
        q, k, v, out, lse, do), 1)
    r["bound_ms"], r["bound_by"] = bwd_bound_ms(torch, q, k, causal)
    print(f"  {what}: backward kernels {r['ms']:.4f} ms (dQ alone "
          f"{r['dq_ms']:.4f}, dK / dV alone {r['dkdv_ms']:.4f})"
          + (f", CUDA-core ones {r['simt_ms']:.4f} ms"
             if r["simt_ms"] is not None else "") + f", forward with lse "
          f"{r['fwd_lse_ms']:.4f} ms, SDPA forward + backward "
          f"{r['library_ms']:.4f} ms (in turns: {json.dumps(times)}); plain "
          f"{r['plain_ms']:.2f} ms; bound {r['bound_ms']:.5f} ms "
          f"({r['bound_by']})")
    return r


def train_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOP of one training step: 6 N T for the weights' products
    (forward and backward) plus attention's, 12 D per causal (query, key)
    pair per head and layer (4 D forward, 8 D backward); no recompute."""
    pairs = seq * (seq + 1) / 2
    attn = 12.0 * cfg.resolved_head_dim * pairs * cfg.n_heads * cfg.n_layers
    return 6.0 * cfg.param_count() * batch * seq + attn * batch


def grad_leaves(torch, model, params, batch, attn_fn, fa_ops):
    """The gradient of ``loss_fn`` (as a flat list) with the attention op
    swapped for ``attn_fn`` (``None``: the kernels)."""
    from repro_torch.optim.optimizers import tree_leaves
    leaves = tree_leaves(params)
    for p in leaves:
        p.grad = None
    saved = fa_ops.flash_attention
    if attn_fn is not None:
        fa_ops.flash_attention = attn_fn
    try:
        loss, _ = model.loss_fn(params, batch)
        loss.backward()
    finally:
        fa_ops.flash_attention = saved
    out = [p.grad.detach().clone() for p in leaves]
    for p in leaves:
        p.grad = None
    return float(loss.detach()), out


def phase_train(torch, fa, attn, ssd) -> dict:
    """Phase 20: the flash_attn backward kernel against its plain version
    at five shapes; qwen3-0.6b trained at full width and depth through
    ``Trainer`` with a node failure recovered and an MN dump; gradients
    through the kernels against the plain attention on an f32 copy."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch import config
    from repro_torch.core.failures import FailureEvent, FailureInjector
    from repro_torch.distributed import elastic
    from repro_torch.distributed.context import make_context
    from repro_torch.models import build_model
    from repro_torch.models.layers import dtype_of
    from repro_torch.optim.optimizers import tree_leaves, tree_rebuild
    from repro_torch.training import trainer as trainer_mod
    print("phase 20: training -- the flash_attn backward kernel against its "
          "plain version; qwen3-0.6b trained at full width and depth "
          "through Trainer (node failure, recovery, MN dump); gradients "
          "through the kernels against the plain attention")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  device memory held before the phase: "
          f"{torch.cuda.memory_allocated()} bytes")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)

    def randn(*shape, dtype="bfloat16"):
        return torch.randn(*shape, generator=gen, device=DEVICE).to(
            getattr(torch, dtype))

    t0 = time.perf_counter()
    out = {"bwd": []}
    for case in BWD_CASES:
        for dtype in case[8]:
            out["bwd"].append(check_bwd_case(torch, fa, randn, case, dtype))
            gc.collect()
            torch.cuda.empty_cache()
    out["bwd_s"] = time.perf_counter() - t0
    main_case = out["bwd"][0]
    check(main_case["kernel"] == "mma" and main_case["simt_ms"]
          >= BWD_MIN_SPEEDUP * main_case["ms"],
          f"{BWD_CASES[0][0]}: the tensor-core backward "
          f"{main_case['ms']:.4f} ms is at least {BWD_MIN_SPEEDUP:g}x "
          f"faster than the CUDA-core one {main_case['simt_ms']:.4f} ms "
          f"on the same inputs")

    # (b) qwen3-0.6b at full width and depth through Trainer
    cfg = config.get_model_config(TRAIN_ARCH)
    check(cfg.n_layers == 28 and cfg.d_model == 1024 and cfg.vocab_size
          == 151936 and cfg.tie_embeddings,
          f"{TRAIN_ARCH}: the published config (28 layers, d_model 1 024, "
          f"vocab 151 936, tied embeddings; {cfg.param_count()} parameters)")
    run = config.RunConfig(
        model=cfg,
        shape=config.ShapeConfig("train_4k, batch cut to 4", TRAIN_SEQ,
                                 TRAIN_BATCH, "train"),
        mesh=config.MeshConfig((4, 2), ("data", "model")),
        replication=config.ReplicationConfig(
            variant="proactive", n_replicas=2, n_buckets=4,
            log_capacity=TRAIN_LOG_CAPACITY,
            dump_interval=TRAIN_DUMP_INTERVAL),
        train=config.TrainConfig(total_steps=TRAIN_STEPS, warmup_steps=2,
                                 remat="full"))
    ctx = make_context(run.mesh.shape, run.mesh.axes, device=DEVICE)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    state_bytes = cfg.param_count() * (2 + 4 + 4 + 4)   # bf16 + m, v, master
    free = shutil.disk_usage(workdir).free
    print(f"  dump target {workdir}: {free} bytes free, the dump ~"
          f"{state_bytes} bytes")
    check(free >= 1.25 * state_bytes, f"room for the MN dump: {free} bytes "
          f"free for ~{state_bytes} (x 1.25)")
    real_install = elastic.install_recovered_shard
    installs = []

    def holed_install(state, specs, engine, result, target_coord):
        """The trainer's install, handed a state whose failed node's
        blocks are NaN (a fail-stop loses them): the recovered shard must
        come from the replica logs alone and equal what the node held."""
        from repro_torch.core.replication import tree_flatten
        node = target_coord[-1]
        holed = [p.detach().clone() for p in tree_leaves(state)]
        for p, spec in zip(holed, tree_flatten(specs)[0]):
            for m in range(ctx.model_size):
                p[elastic._block_slices(tuple(p.shape), spec, ctx,
                                        {"data": node, "model": m})] = \
                    float("nan")
        new = real_install(tree_rebuild(state, holed), specs, engine,
                           result, target_coord)
        installs.append(all(torch.equal(a, b.detach()) for a, b in
                            zip(tree_leaves(new), tree_leaves(state))))
        return new

    try:
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        tr = trainer_mod.Trainer(
            run, ctx, workdir,
            injector=FailureInjector([FailureEvent(step=TRAIN_FAIL[0],
                                                   node=TRAIN_FAIL[1])]))
        setup_s = time.perf_counter() - t1
        trainer_mod.install_recovered_shard = holed_install
        steps, per_step, per_step_kernel = [], [], []
        fa.ops.reset_counts()
        ssd.ops.reset_counts()
        dumped = None
        for i in range(TRAIN_STEPS):
            f0, b0 = (fa.ops.flash_attention.launches,
                      fa.ops.flash_attention.bwd_launches)
            k0 = dict(fa.ops.flash_attention.bwd_launches_by_kernel)
            steps += tr.train(1)
            per_step.append((fa.ops.flash_attention.launches - f0,
                             fa.ops.flash_attention.bwd_launches - b0))
            per_step_kernel.append({
                n: fa.ops.flash_attention.bwd_launches_by_kernel[n] - c
                for n, c in k0.items()})
            if (i + 1) % TRAIN_DUMP_INTERVAL == 0:
                dumped = [p.detach().clone()
                          for p in tree_leaves(tr.state.params)]
        launches = {"forward": fa.ops.flash_attention.launches,
                    "backward": fa.ops.flash_attention.bwd_launches,
                    "forward_by_kernel":
                        dict(fa.ops.flash_attention.launches_by_kernel),
                    "backward_by_kernel":
                        dict(fa.ops.flash_attention.bwd_launches_by_kernel),
                    "ssd_scan": ssd.ops.ssd_scan.launches}
        peak = torch.cuda.max_memory_allocated()
        trainer_mod.install_recovered_shard = real_install
        w0 = time.perf_counter()
        tr.ckpt.wait()
        wait_s = time.perf_counter() - w0
        losses = [s["loss"] for s in steps]
        walls = [s["wall_s"] for s in steps]
        print(f"  losses {losses}; step walls (s) {walls}; attention "
              f"launches per step (forward, backward) {per_step}")
        check(all(np.isfinite(losses)), "every loss is finite")
        check(abs(losses[0] - np.log(cfg.vocab_size)) <= 0.5,
              f"the first loss {losses[0]:.4f} is within 0.5 of ln "
              f"{cfg.vocab_size} = {np.log(cfg.vocab_size):.4f}")
        check(all(p == (2 * cfg.n_layers, cfg.n_layers) for p in per_step),
              f"every step launches the forward kernel {2 * cfg.n_layers} "
              f"times (the forward and remat's recompute) and the backward "
              f"{cfg.n_layers} times")
        check(all(p == {"mma": cfg.n_layers, "simt": 0}
                  for p in per_step_kernel),
              f"every step's {cfg.n_layers} backward launches run the "
              f"tensor-core kernels, none the CUDA-core ones: "
              f"{per_step_kernel[0]}")
        check(launches["ssd_scan"] == 0, "ssd_scan is not launched")
        rec = [e for e in tr.events if e["event"] == "recovery"]
        check(len(rec) == 1 and rec[0]["stats"]["unrecoverable"] == 0
              and rec[0]["stats"]["recovered_from_replicas"] > 0,
              f"node {TRAIN_FAIL[1]} failed at step {TRAIN_FAIL[0]} and "
              f"was recovered from the replicas: {rec and rec[0]['stats']}")
        check(installs == [True], "the shard installed on the spare, made "
              "from the replica logs with the node's blocks lost, is == "
              "the parameters the node held before the failure")
        dumps = [e for e in tr.events if e["event"] == "mn_dump"]
        check(len(dumps) == 1 and tr.ckpt.latest_step() == dumps[0]["step"],
              f"one MN dump inside the run, at step "
              f"{dumps and dumps[0]['step']}")
        r0 = time.perf_counter()
        restored, extra = tr.ckpt.restore(
            {"params": tr.state.params, "opt": tr.state.opt_state})
        restore_s = time.perf_counter() - r0
        check(all(torch.equal(a, b) for a, b in
                  zip(tree_leaves(restored["params"]), dumped)),
              "restore of the dump gives the parameters of its step bit "
              "for bit")
        check(restored["opt"]["count"] == dumps[0]["step"] + 1
              and extra["pipeline_step"] == dumps[0]["step"] + 1,
              "the dump's optimizer count and pipeline step")
        del restored, dumped
        # the replicate step alone, on the trained state (CUDA events)
        eng = tr.engine
        rep_ms = cuda_ms(lambda: eng.replicate(
            tr.state.params, tr.state.logs, tr.state.step,
            tr.state.params), 3)
        med = float(np.median(walls[1:]))
        tokens = TRAIN_BATCH * TRAIN_SEQ
        flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
        out["train"] = {
            "losses": losses, "step_walls_s": walls,
            "step_ms_median_2_6": med * 1e3,
            "tokens_per_s": tokens / med, "peak_bytes": peak,
            "model_flop_per_step": flops,
            "model_flop_share_of_989": flops / med / H100_BF16_OPS_PER_S,
            "replicate_ms": rep_ms,
            "recovery_wall_s": rec[0]["wall_s"],
            "recovery_stats": rec[0]["stats"],
            "dump_snapshot_s": dumps[0]["snapshot_s"],
            "dump_write_s": tr.ckpt.last_write_s, "dump_wait_s": wait_s,
            "restore_s": restore_s, "setup_s": setup_s,
            "log_ring_bytes": sum(t.numel() * t.element_size()
                                  for t in tr.state.logs.values()),
            "launches": launches, "launches_per_step": per_step,
            "params": cfg.param_count()}
        t = out["train"]
        print(f"  {TRAIN_ARCH} ({cfg.param_count()} parameters, bf16, AdamW "
              f"with an f32 master copy, remat full) at batch {TRAIN_BATCH} "
              f"x {TRAIN_SEQ}: step {t['step_ms_median_2_6']:.1f} ms (median "
              f"of steps 2-6), {t['tokens_per_s']:.0f} tokens/s, peak "
              f"{peak} bytes; {flops:.4g} model FLOP a step, "
              f"{100 * t['model_flop_share_of_989']:.2f}% of 989 TFLOP/s; "
              f"replicate {rep_ms:.3f} ms (log ring {t['log_ring_bytes']} "
              f"bytes); recovery {t['recovery_wall_s']:.3f} s; dump "
              f"snapshot {t['dump_snapshot_s']:.3f} s, write "
              f"{t['dump_write_s']:.3f} s, restore {restore_s:.3f} s")
        del tr
    finally:
        trainer_mod.install_recovered_shard = real_install
        shutil.rmtree(workdir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # (c) gradients at full width, kernels against the plain attention
    f32cfg = dataclasses.replace(cfg, n_layers=TRAIN_F32_LAYERS,
                                 dtype="float32")
    model = build_model(f32cfg)
    params = model.init(SEED, device=DEVICE)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    tok = torch.randint(0, cfg.vocab_size, (1, TRAIN_SEQ), generator=gen,
                        device=DEVICE, dtype=torch.int32)
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, dims=1)}
    fa.ops.reset_counts()
    loss_k, g_k = grad_leaves(torch, model, params, batch, None, fa.ops)
    launches_c = (fa.ops.flash_attention.launches,
                  fa.ops.flash_attention.bwd_launches)
    bwd_kernels_c = dict(fa.ops.flash_attention.bwd_launches_by_kernel)
    loss_p, g_p = grad_leaves(torch, model, params, batch,
                              plain_attention(attn), fa.ops)
    rels = [max_rel(a, b) for a, b in zip(g_k, g_p)]
    real_bwd = fa.kernel.launch_bwd
    fa.kernel.launch_bwd = (lambda q, k, v, o, lse, do, causal, **kw:
                            real_bwd(q, k, v, o, lse, do, False, **kw))
    try:
        _, g_bad = grad_leaves(torch, model, params, batch, None, fa.ops)
    finally:
        fa.kernel.launch_bwd = real_bwd
    bad = max(max_rel(a, b) for a, b in zip(g_bad, g_p))
    out["grads_f32"] = {"layers": TRAIN_F32_LAYERS, "loss_kernel": loss_k,
                        "loss_plain": loss_p, "max_rel": max(rels),
                        "planted": {FAULT_BWD_CAUSAL: bad},
                        "launches": launches_c}
    print(f"  gradients of loss_fn, {TRAIN_ARCH} f32 at {TRAIN_F32_LAYERS} "
          f"layers, batch 1 x {TRAIN_SEQ}: kernels vs plain attention, "
          f"largest leaf {max(rels):.4g} of its max|grad| (losses "
          f"{loss_k:.6f} / {loss_p:.6f}); planted ({FAULT_BWD_CAUSAL}) "
          f"{bad:.4g}; launches (forward, backward) {launches_c}")
    check(launches_c == (2 * TRAIN_F32_LAYERS, TRAIN_F32_LAYERS)
          and bwd_kernels_c == {"mma": 0, "simt": TRAIN_F32_LAYERS},
          "the kernels' route: the forward twice and the backward once a "
          "layer, f32 on the CUDA-core backward")
    check(max(rels) <= TRAIN_GRAD_TOLERANCE, f"gradients through the "
          f"kernels vs the plain attention: {max(rels):.4g} (tol "
          f"{TRAIN_GRAD_TOLERANCE})")
    check(bad > TRAIN_GRAD_TOLERANCE, f"planted fault ({FAULT_BWD_CAUSAL}) "
          f"reads {bad:.4g}, above the limit {TRAIN_GRAD_TOLERANCE}")
    # the same on the bf16 weights
    del g_k, g_p, g_bad
    bcfg = dataclasses.replace(cfg, n_layers=TRAIN_F32_LAYERS)
    bmodel = build_model(bcfg)
    with torch.no_grad():
        bparams = tree_rebuild(params, [p.detach().to(dtype_of(bcfg))
                                        for p in tree_leaves(params)])
    for p in tree_leaves(bparams):
        p.requires_grad_(True)
    _, b_k = grad_leaves(torch, bmodel, bparams, batch, None, fa.ops)
    _, b_p = grad_leaves(torch, bmodel, bparams, batch,
                         plain_attention(attn), fa.ops)
    out["grads_bf16"] = {"max_rel": max(max_rel(a.float(), b.float())
                                        for a, b in zip(b_k, b_p))}
    print(f"  the same on bf16 weights: largest leaf "
          f"{out['grads_bf16']['max_rel']:.4g} of its max|grad|")
    del params, bparams, b_k, b_p, model, bmodel
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    return out


#: phase 21: the ssm, hybrid, MoE and enc-dec families trained. The SSD
#: backward's shapes, (name, b, l, h, p, n, chunk, dtype, with an initial
#: state and the final state's gradient): hymba-1.5b's and mamba2-2.7b's
#: training shapes (bf16), mamba2's in f32 at batch 1, and mamba2's heads
#: over l = 4 000 (a ragged last chunk) with an initial state, both dtypes
SSD_BWD_CASES = [
    ("hymba-1.5b train", 4, 4096, 50, 64, 16, 256, "bfloat16", False),
    ("mamba2-2.7b train", 2, 4096, 80, 64, 128, 256, "bfloat16", False),
    ("mamba2-2.7b f32", 1, 4096, 80, 64, 128, 256, "float32", False),
    ("mamba2-2.7b ragged, init_state", 1, 4000, 80, 64, 128, 256,
     "bfloat16", True),
    ("mamba2-2.7b ragged, init_state, f32", 1, 4000, 80, 64, 128, 256,
     "float32", True),
]
#: each gradient held to its own max|value|: bf16 at the forward's bf16
#: limit (the plain version rounds att, x w, Cd and the prior where the
#: kernel does, and the f32 oracle does not round), f32 at 1e-4
SSD_BWD_TOLERANCE = {"float32": 1e-4, "bfloat16": 3e-2}
SSD_BWD_TOLERANCE_TEXT = ("dx, ddt, dA, dB, dC (and dinit) each within 3e-2 "
                          "(bf16) / 1e-4 (f32) of its own max|value|, "
                          "against ssd_bwd_ref on the same inputs and the "
                          "kernel's own priors, and against torch autograd "
                          "of ssd_chunked on the inputs widened to f32")
FAULT_SSD_DB = "ssd backward: dB of the first head, not summed over the heads"
FAULT_SSD_WALK = ("ssd backward: the chunk decay taken as 1 in the reverse "
                  "walk")
FAULT_SSD_TAIL = "ssd backward: the padded tail chunk's seg_last gradient "\
                 "dropped"
SSD_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dinit")
#: the (spill store, spill load) bytes ptxas may give the tensor-core
#: backward's rows kernel, in any of its 16 (p, n padding) instantiations:
#: it holds dC's accumulators beside G, D and dP, and ptxas spills 4-32
#: bytes in 7 of them (hymba's p 64 / n 16 and mamba2's p 64 / n 128
#: among them); its chunk and keys kernels none
SSD_BWD_ROWS_SPILLS = (32, 48)
#: the training runs, (arch, layers (None: the published depth), batch,
#: positions, steps, (step, node) of a fail-stop or None, log slots, log
#: dtype): hymba-1.5b and mamba2-2.7b whole at train_4k's 4 096 positions,
#: moonshot-v1-16b-a3b at full width cut to 2 layers, whisper-medium whole
#: at phase 18's batch, frames and prompt length. hymba's logs are f32:
#: its A_log, D and dt_bias are f32 leaves, which bf16 logs would round,
#: and the recovered shard is held ``==`` the lost one. One log slot
#: where two would not leave room for the activations (mamba2's 2.8e9
#: parameters: 45 GB of state)
FAMILY_TRAIN = [
    ("hymba-1.5b", None, 4, 4096, 4, (2, 2), 1, "float32"),
    ("mamba2-2.7b", None, 2, 4096, 4, None, 1, "bfloat16"),
    ("moonshot-v1-16b-a3b", 2, 2, 2048, 3, None, 1, "bfloat16"),
    ("whisper-medium", None, WHISPER_BATCH, WHISPER_PROMPT, 3, None, 2,
     "bfloat16"),
]
FAMILY_F32_LAYERS = 2
FAMILY_F32_SEQ = 4096
#: the f32 2-layer gradient checks, (arch, positions): hymba-1.5b and
#: mamba2-2.7b at train_4k's 4 096, moonshot-v1-16b-a3b at its training
#: run's 2 048 with its routing pinned to the plain run's (recorded over
#: the plain run's forward and backward: remat's recompute routes again),
#: whisper-medium (2 encoder and 2 decoder layers) at phase 18's 1 500
#: frames and 224-token prompt
FAMILY_GRAD_ARCHS = (("hymba-1.5b", FAMILY_F32_SEQ),
                     ("mamba2-2.7b", FAMILY_F32_SEQ),
                     ("moonshot-v1-16b-a3b", 2048),
                     ("whisper-medium", WHISPER_PROMPT))
FAULT_CROSS_BWD_CAUSAL = "backward: the cross-attention under a causal mask"
FAULT_MOE_GATES_DETACHED = ("moe: the combine's gates detached (their "
                            "gradient dropped)")
#: the first step's loss (bf16, through the kernels) against the loss of
#: the same weights and batch through the plain versions: a random init
#: sets the loss's distance from ln vocab (hymba-1.5b's starts ~0.9 above
#: it), the kernels set this one. For the MoE family, whose routing flips
#: between two sound runs (ROADMAP C) move the loss by more than rounding,
#: the kernels' loss is taken with the routing pinned to the plain run's
#: (``RoutingTape``), under ``no_grad`` on the same weights and batch; the
#: unpinned first step's loss and the flips are printed beside it
FAMILY_LOSS_TOLERANCE = 1e-2
#: the f32 2-layer gradients of hymba and mamba2 are held leaf by leaf in
#: the norm, ||g_kernels - g_plain|| / ||g_plain|| <= TRAIN_GRAD_TOLERANCE:
#: the elementwise measure phase 20 uses (max|diff| / max|g|) sits at the
#: f32 floor on these leaves (a bias's gradient is a sum of cancelling
#: terms over 4 096 positions, and exp(seg_q - seg_k) carries seg's f32
#: rounding at |seg| in the thousands): the plain versions' own distance
#: from a reference with the SSD backward in f64 is of the same size, and
#: the phase prints all three readings


def ssd_bwd_bound_ms(torch, x, B, chunk: int, priors) -> tuple:
    """x, dy, B, C, dt and the priors read once, dx, dB, dC and ddt written
    once, against the products the gradient needs: per head and chunk
    2 p MACs per allowed (row, key) pair (dP, dx) and 4 p n per position
    (the walk's term, dCd, dwx, the state's dB); per (b, chunk) 3 n per
    pair for G = C B^T, dC = D B and dB = D^T C, with D the sum of dG over
    the heads (B and C do not depend on the head); the tail chunk counts
    its real positions only."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    es = x.element_size()
    nbytes = ((3 * x.numel() + 4 * B.numel()) * es + 2 * b * l * h * 4
              + priors.numel() * priors.element_size())
    chunk = min(chunk, l)
    sizes = [chunk] * (l // chunk) + ([l % chunk] if l % chunk else [])
    pairs = sum(q * (q + 1) // 2 for q in sizes)
    macs = b * (h * (pairs * 2 * p + 4 * l * p * n) + 3 * pairs * n)
    return bound(nbytes, 2.0 * macs, rate_for(torch, x.dtype))


def check_ssd_bwd_case(torch, ssd, ssm_mod, randn, case) -> dict:
    """One shape and dtype of the SSD backward against its plain version
    (one request at a time) and the f32 autograd oracle; two launches;
    the planted faults; its time beside its bound, the forward's with and
    without the priors, the plain version's and the plain autograd's."""
    name, b, l, h, p, n, chunk, dtype, with_init = case
    kernel, ref = ssd.kernel, ssd.ref
    T = getattr(torch, dtype)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 21)
    x = randn(b, l, h, p, dtype=dtype) * 0.5
    dt = torch.rand(b, l, h, generator=gen, device=DEVICE) * 0.1 + 0.001
    A = -torch.arange(1, h + 1, dtype=torch.float32, device=DEVICE)
    B, C = ((randn(b, l, n, dtype=dtype) * 0.3).to(T) for _ in range(2))
    dy = randn(b, l, h, p, dtype=dtype)
    init = ds = None
    if with_init:
        init = randn(b, h, p, n, dtype="float32") * 0.1
        ds = randn(b, h, p, n, dtype="float32")
    x = x.to(T)
    y, s, pr = kernel.launch(x, dt, A, B, C, chunk, init, with_priors=True)
    dinit_dtype = torch.float32 if with_init else None

    def bwd(*args, fault=None):
        return kernel.launch_bwd(*args, dinit_dtype=dinit_dtype, fault=fault)

    got = bwd(x, dt, A, B, C, chunk, pr, dy, ds)
    again = bwd(x, dt, A, B, C, chunk, pr, dy, ds)
    torch.cuda.synchronize()
    same = all(a is None or torch.equal(a, c) for a, c in zip(got, again))
    del again

    def rows(fn):
        """``fn`` over one request at a time; dA summed over them."""
        outs = [fn(i) for i in range(b)]
        return [None if outs[0][j] is None else
                (sum(o[j] for o in outs) if j == 2
                 else torch.cat([o[j] for o in outs])) for j in range(6)]

    def sl(i, t):
        return None if t is None else t[i:i + 1]

    want = rows(lambda i: ref.ssd_bwd_ref(
        sl(i, x), sl(i, dt), A, sl(i, B), sl(i, C), chunk, sl(i, dy),
        sl(i, ds), sl(i, init), sl(i, pr)))

    def oracle(i):
        leaves = [t.detach().float().clone().requires_grad_(True)
                  for t in (sl(i, x), sl(i, dt), A, sl(i, B), sl(i, C))]
        s0 = None if init is None else sl(i, init).clone().requires_grad_()
        yy, ss = ssm_mod.ssd_chunked(*leaves, chunk, s0)
        loss = (yy * sl(i, dy).float()).sum()
        if ds is not None:
            loss = loss + (ss * sl(i, ds)).sum()
        grads = torch.autograd.grad(loss, leaves + ([s0] if with_init
                                                    else []))
        return list(grads) + ([] if with_init else [None])

    auto = rows(oracle)
    r = {"shape": case[:8], "with_init": with_init, "deterministic": same,
         "vs_plain": {k: max_rel(g.float(), w.float())
                      for k, g, w in zip(SSD_GRADS, got, want)
                      if g is not None},
         "vs_f32_oracle": {k: max_rel(g.float(), w.float())
                           for k, g, w in zip(SSD_GRADS, got, auto)
                           if g is not None},
         "max_abs_err": max(float((g.float() - w.float()).abs().max())
                            for g, w in zip(got, want) if g is not None)}
    del auto
    tol = SSD_BWD_TOLERANCE[dtype]

    def grads_rel_ssd(bad):
        return max(max_rel(g.float(), w.float())
                   for g, w in zip(bad, want) if g is not None)

    faults = {}
    # dB of head 0 alone, as if the per-head partials were not summed
    part = kernel.launch_bwd(x[:, :, :1], dt[..., :1], A[:1], B, C, chunk,
                             pr[:, :1], dy[:, :, :1],
                             None if ds is None else ds[:, :1])
    faults[FAULT_SSD_DB] = max_rel(part[3].float(), want[3].float())
    del part
    # the walk's decay and the tail's seg_last gradient broken inside the
    # dtype's own kernels (``ssd_scan_bwd_planted_launch``)
    faults[FAULT_SSD_WALK] = grads_rel_ssd(bwd(
        x, dt, A, B, C, chunk, pr, dy, ds, fault="walk"))
    if l % chunk and ds is not None:
        # without the final state's gradient the last chunk's seg_last
        # gradient is 0, and so is this fault
        faults[FAULT_SSD_TAIL] = grads_rel_ssd(bwd(
            x, dt, A, B, C, chunk, pr, dy, ds, fault="tail"))
    r["planted"] = faults
    what = (f"ssd_scan backward at {name} (b {b}, l {l}, h {h}, p {p}, "
            f"n {n}, chunk {chunk}, {dtype}"
            + (", init_state and dstate" if with_init else "") + ")")
    print(f"  {what}, {kernel.bwd_kernel_for(T)} kernels: vs plain "
          f"{json.dumps(r['vs_plain'])}, vs the f32 "
          f"autograd oracle {json.dumps(r['vs_f32_oracle'])}; planted "
          f"{json.dumps(faults)}")
    for key in ("vs_plain", "vs_f32_oracle"):
        worst = max(r[key].values())
        check(worst <= tol, f"{what}: kernel {key.replace('_', ' ')}, "
              f"largest {worst:.4g} of max|grad| (tol {tol})")
    for fault, rel in faults.items():
        check(rel > tol, f"{what}: planted fault ({fault}) reads {rel:.4g}, "
              f"above the limit {tol}")
    check(same, f"{what}: two launches give bit-identical gradients")
    # times: the backward, the forward with and without the priors, in
    # turns; the plain version and the plain autograd once
    r["kernel"] = kernel.bwd_kernel_for(T)
    runs = {"ms": lambda: bwd(x, dt, A, B, C, chunk, pr, dy, ds),
            "fwd_priors_ms": lambda: kernel.launch(x, dt, A, B, C, chunk,
                                                   init, with_priors=True),
            "fwd_ms": lambda: kernel.launch(x, dt, A, B, C, chunk, init)}
    if r["kernel"] == "mma":
        # the CUDA-core kernels on the same bf16 inputs: the yardstick
        runs["simt_ms"] = lambda: kernel.launch_bwd(
            x, dt, A, B, C, chunk, pr, dy, ds, dinit_dtype=dinit_dtype,
            which="simt")
    times = {key: [] for key in runs}
    for order in (list(runs), list(runs)[::-1]):
        for key in order:
            times[key].append(cuda_ms(runs[key], 5))
    r.update({key: sum(ts) / len(ts) for key, ts in times.items()})
    r["turns"] = times
    r["plain_ms"] = cuda_ms(lambda: rows(lambda i: ref.ssd_bwd_ref(
        sl(i, x), sl(i, dt), A, sl(i, B), sl(i, C), chunk, sl(i, dy),
        sl(i, ds), sl(i, init), sl(i, pr))), 1)
    r["autograd_ms"] = cuda_ms(lambda: rows(oracle), 1)
    r["bound_ms"], r["bound_by"] = ssd_bwd_bound_ms(torch, x, B, chunk, pr)
    if "simt_ms" in r:
        check(r["ms"] < r["simt_ms"], f"{what}: the tensor-core backward "
              f"({r['ms']:.4f} ms) is faster than the CUDA-core one on the "
              f"same inputs ({r['simt_ms']:.4f} ms)")
    print(f"  {what}: backward ({r['kernel']}) {r['ms']:.4f} ms"
          + (f", the CUDA-core kernels on the same inputs "
             f"{r['simt_ms']:.4f} ms" if "simt_ms" in r else "")
          + f", forward with priors "
          f"{r['fwd_priors_ms']:.4f} ms, without {r['fwd_ms']:.4f} ms (in "
          f"turns: {json.dumps(times)}); plain backward {r['plain_ms']:.2f} "
          f"ms, plain autograd forward + backward (f32) "
          f"{r['autograd_ms']:.2f} ms; bound {r['bound_ms']:.5f} ms "
          f"({r['bound_by']})")
    return r


def family_model_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOP of one training step of a decoder (no recompute): 6 N T
    for the weights' products, attention's 12 D per causal pair per head
    and layer, and the SSD scan's 2 x 3 x (pairs (n + p) + 2 Q p n) per
    head and chunk a layer (forward, and twice that backward)."""
    flops = 6.0 * cfg.param_count() * batch * seq
    pairs = seq * (seq + 1) / 2
    if cfg.family != "ssm":
        flops += 12.0 * cfg.resolved_head_dim * pairs * cfg.n_heads \
            * cfg.n_layers * batch
    if cfg.family in ("ssm", "hybrid"):
        q = cfg.ssm_chunk
        nc = -(-seq // q)
        p, n = cfg.ssm_head_dim, cfg.ssm_state
        per_chunk = q * (q + 1) / 2 * (n + p) + 2 * q * p * n
        flops += 6.0 * per_chunk * nc * cfg.ssm_n_heads * cfg.n_layers * batch
    return flops


def published_check(cfg, arch: str) -> None:
    """The published config's widths (and depth where not cut)."""
    want = {"hymba-1.5b": dict(n_layers=32, d_model=1600, n_heads=25,
                               ssm_n_heads=50, ssm_state=16,
                               vocab_size=32001),
            "mamba2-2.7b": dict(n_layers=64, d_model=2560, ssm_n_heads=80,
                                ssm_state=128, vocab_size=50280),
            "moonshot-v1-16b-a3b": dict(n_layers=48, d_model=2048,
                                        n_experts=64, vocab_size=163840),
            "whisper-medium": dict(n_layers=24, encoder_layers=24,
                                   d_model=1024, n_heads=16,
                                   vocab_size=51865)}[arch]
    got = {k: getattr(cfg, k) for k in want}
    check(got == want, f"{arch}: the published config {want}, got {got} "
          f"({cfg.param_count()} parameters)")


def train_family(torch, fa, attn, ssd, ssm_mod, arch: str, layers,
                 batch: int, seq: int, steps: int, fail, log_capacity: int,
                 log_dtype: str) -> dict:
    """``arch`` trained ``steps`` steps through ``Trainer`` on the card:
    bf16, AdamW with an f32 master copy, ``remat="full"``, a logical data
    4 x model 2 mesh (proactive, N_r 2, 4 buckets), no MN dump; a node's
    fail-stop at ``fail`` recovered from the replica logs, the installed
    shard ``==`` the node's parameters. Per step: every loss finite, the
    kernels' launches counted; the first loss against the plain
    versions' on the same weights and batch (an MoE's with its routing
    pinned to the plain run's)."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch import config
    from repro_torch.models import moe
    from repro_torch.core.failures import FailureEvent, FailureInjector
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.distributed import elastic
    from repro_torch.distributed.context import make_context
    from repro_torch.optim.optimizers import tree_leaves, tree_rebuild
    from repro_torch.training import trainer as trainer_mod
    published = config.get_model_config(arch)
    published_check(published, arch)
    cfg = (published if layers is None
           else dataclasses.replace(published, n_layers=layers))
    n_params = cfg.param_count()
    # the reckoning before the run: bf16 params and grads, f32 master, m, v
    # (16 B a parameter), the bf16 logs (2 B x N_r x slots a parameter) and
    # the f32 logits with their gradient
    state_b = 16 * n_params
    ring_b = (2 if log_dtype == "bfloat16" else 4) * 2 * log_capacity \
        * n_params
    logits_b = 2 * 4 * batch * seq * cfg.vocab_size
    print(f"  {arch}{'' if layers is None else f' cut to {layers} layers'}: "
          f"{n_params} parameters; reckoned {state_b / 1e9:.1f} GB of "
          f"parameters, gradients and AdamW state, {ring_b / 1e9:.1f} GB of "
          f"replica logs ({log_capacity} slot(s), {log_dtype}), "
          f"{logits_b / 1e9:.2f} GB of logits and their "
          f"gradient at batch {batch} x {seq}; "
          f"{torch.cuda.mem_get_info()[0]} bytes free on the card")
    run = config.RunConfig(
        model=cfg,
        shape=config.ShapeConfig(f"train, batch {batch}", seq, batch,
                                 "train"),
        mesh=config.MeshConfig((4, 2), ("data", "model")),
        replication=config.ReplicationConfig(
            variant="proactive", n_replicas=2, n_buckets=4,
            log_capacity=log_capacity, dump_interval=steps + 1,
            log_dtype=log_dtype),
        train=config.TrainConfig(total_steps=steps, warmup_steps=2,
                                 remat="full"))
    ctx = make_context(run.mesh.shape, run.mesh.axes, device=DEVICE)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_train21_")
    real_install = elastic.install_recovered_shard
    installs = []

    def holed_install(state, specs, engine, result, target_coord):
        """As phase 20's: the failed node's blocks NaN before the install,
        so the shard comes from the replica logs alone."""
        node = target_coord[-1]
        from repro_torch.core.replication import tree_flatten
        holed = [t.detach().clone() for t in tree_leaves(state)]
        for t, spec in zip(holed, tree_flatten(specs)[0]):
            for m in range(ctx.model_size):
                t[elastic._block_slices(tuple(t.shape), spec, ctx,
                                        {"data": node, "model": m})] = \
                    float("nan")
        new = real_install(tree_rebuild(state, holed), specs, engine,
                           result, target_coord)
        installs.append(all(torch.equal(a, c.detach()) for a, c in
                            zip(tree_leaves(new), tree_leaves(state))))
        return new

    fops, sops = fa.ops.flash_attention, ssd.ops.ssd_scan
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr = trainer_mod.Trainer(
            run, ctx, workdir, injector=FailureInjector(
                [FailureEvent(step=fail[0], node=fail[1])] if fail else []))
        setup_s = time.perf_counter() - t0
        # the first batch's loss through the plain versions, before a step
        first = tr._to_device(SyntheticTokenPipeline(
            cfg, run.shape, seed=run.train.seed).next())
        saved = (fa.ops.flash_attention, ssd.ops.ssd_scan)
        fa.ops.flash_attention = plain_attention(attn)
        ssd.ops.ssd_scan = plain_ssd(ssm_mod)
        tape = RoutingTape(torch, moe)
        try:
            with torch.no_grad(), tape.record() as plain_calls:
                loss_plain = float(tr.model.loss_fn(tr.state.params,
                                                    first)[0])
        finally:
            fa.ops.flash_attention, ssd.ops.ssd_scan = saved
        pinned = None
        if cfg.is_moe:
            # the same batch through the kernels, unpinned (the flips) and
            # pinned to the plain run's experts (the gate)
            with torch.no_grad(), tape.record() as kernel_calls:
                loss_unpinned = float(tr.model.loss_fn(tr.state.params,
                                                       first)[0])
            with torch.no_grad(), tape.pin(plain_calls):
                loss_pinned = float(tr.model.loss_fn(tr.state.params,
                                                     first)[0])
            pinned = {"loss": loss_pinned, "loss_unpinned": loss_unpinned,
                      "tape_calls": len(plain_calls),
                      "tape_left": len(tape.queue),
                      "route_flips": route_flips(plain_calls, kernel_calls)}
            del kernel_calls
        del first, plain_calls
        gc.collect()
        torch.cuda.empty_cache()
        trainer_mod.install_recovered_shard = holed_install
        fa.ops.reset_counts()
        ssd.ops.reset_counts()
        steps_out, per_step = [], []
        for _ in range(steps):
            c0 = (fops.launches, fops.bwd_launches,
                  dict(fops.bwd_launches_by_kernel), sops.launches,
                  sops.bwd_launches, dict(sops.bwd_launches_by_kernel))
            steps_out += tr.train(1)
            per_step.append({
                "flash_attn": (fops.launches - c0[0],
                               fops.bwd_launches - c0[1]),
                "flash_attn_bwd_by_kernel": {
                    k: v - c0[2][k]
                    for k, v in fops.bwd_launches_by_kernel.items()},
                "ssd_scan": (sops.launches - c0[3],
                             sops.bwd_launches - c0[4]),
                "ssd_scan_bwd_by_kernel": {
                    k: v - c0[5][k]
                    for k, v in sops.bwd_launches_by_kernel.items()}})
        peak = torch.cuda.max_memory_allocated()
        trainer_mod.install_recovered_shard = real_install
        losses = [s_["loss"] for s_ in steps_out]
        walls = [s_["wall_s"] for s_ in steps_out]
        rec = [e for e in tr.events if e["event"] == "recovery"]
        dumps = [e for e in tr.events if e["event"] == "mn_dump"]
        out = {"arch": arch, "layers": cfg.n_layers, "batch": batch,
               "seq": seq, "params": n_params, "losses": losses,
               "first_loss_plain": loss_plain, "first_loss_pinned": pinned,
               "step_walls_s": walls, "per_step": per_step,
               "peak_bytes": peak, "setup_s": setup_s,
               "log_ring_bytes": sum(t.numel() * t.element_size()
                                     for t in tr.state.logs.values()),
               "launches": {
                   "flash_attn": fops.launches,
                   "flash_attn_bwd": fops.bwd_launches,
                   "flash_attn_bwd_by_kernel":
                       dict(fops.bwd_launches_by_kernel),
                   "ssd_scan": sops.launches,
                   "ssd_scan_by_kernel": dict(sops.launches_by_kernel),
                   "ssd_scan_bwd": sops.bwd_launches,
                   "ssd_scan_bwd_by_kernel":
                       dict(sops.bwd_launches_by_kernel)}}
        med = float(np.median(walls[1:]))
        out["step_ms_median"] = med * 1e3
        out["tokens_per_s"] = batch * seq / med
        if cfg.family in ("ssm", "hybrid"):
            flops = family_model_flops(cfg, batch, seq)
            out["model_flop_per_step"] = flops
            out["model_flop_share_of_989"] = flops / med / \
                H100_BF16_OPS_PER_S
        if rec:
            out["recovery_wall_s"] = rec[0]["wall_s"]
            out["recovery_stats"] = rec[0]["stats"]
        del tr
    finally:
        trainer_mod.install_recovered_shard = real_install
        shutil.rmtree(workdir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    if pinned is not None:
        print(f"  {arch}: the first batch through the kernels with the "
              f"routing pinned to the plain run's ({pinned['tape_calls']} "
              f"top_k_gates calls, {pinned['tape_left']} left): loss "
              f"{pinned['loss']:.6f}; unpinned {pinned['loss_unpinned']:.6f} "
              f"(routing flips {json.dumps(pinned['route_flips'])}); the "
              f"first step's {losses[0]:.6f}")
    print(f"  {arch}: losses {losses} (the first through the plain versions "
          f"{loss_plain:.6f}; ln vocab {np.log(cfg.vocab_size):.4f}); step "
          f"walls (s) {walls}; launches "
          f"per step {per_step[0]}; step {out['step_ms_median']:.1f} ms "
          f"(median of steps 2-{steps}), {out['tokens_per_s']:.0f} "
          f"tokens/s, peak {peak} bytes"
          + (f", {out['model_flop_per_step']:.4g} model FLOP a step, "
             f"{100 * out['model_flop_share_of_989']:.2f}% of 989 TFLOP/s"
             if "model_flop_per_step" in out else "")
          + (f"; recovery {out['recovery_wall_s']:.3f} s" if rec else ""))
    check(all(np.isfinite(losses)), f"{arch}: every loss is finite")
    if pinned is None:
        check(abs(losses[0] - loss_plain) <= FAMILY_LOSS_TOLERANCE,
              f"{arch}: the first loss {losses[0]:.6f} is within "
              f"{FAMILY_LOSS_TOLERANCE} of the plain versions' "
              f"{loss_plain:.6f}")
    else:
        check(pinned["tape_calls"] > 0 and pinned["tape_left"] == 0,
              f"{arch}: the pinned run took each of the plain run's "
              f"{pinned['tape_calls']} routings once")
        check(abs(pinned["loss"] - loss_plain) <= FAMILY_LOSS_TOLERANCE,
              f"{arch}: the first batch's loss through the kernels, routing "
              f"pinned, {pinned['loss']:.6f} is within "
              f"{FAMILY_LOSS_TOLERANCE} of the plain versions' "
              f"{loss_plain:.6f}")
    n_attn = 0 if cfg.family == "ssm" else (
        3 * cfg.n_layers if cfg.is_encdec else cfg.n_layers)
    n_ssd = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    want = {"flash_attn": (2 * n_attn, n_attn),
            "flash_attn_bwd_by_kernel": {"mma": n_attn, "simt": 0},
            "ssd_scan": (2 * n_ssd, n_ssd),
            "ssd_scan_bwd_by_kernel": {"mma": n_ssd, "simt": 0}}
    check(all(p_ == want for p_ in per_step),
          f"{arch}: every step launches flash_attn {2 * n_attn} times "
          f"forward (with remat's recompute) and {n_attn} backward, and "
          f"ssd_scan {2 * n_ssd} forward and {n_ssd} backward, both "
          f"backwards all on their tensor-core kernels: {per_step}")
    check(not dumps, f"{arch}: no MN dump inside the run")
    if fail:
        check(len(rec) == 1 and rec[0]["stats"]["unrecoverable"] == 0
              and rec[0]["stats"]["recovered_from_replicas"] > 0,
              f"{arch}: node {fail[1]} failed at step {fail[0]} and was "
              f"recovered from the replicas: {rec and rec[0]['stats']}")
        check(installs == [True], f"{arch}: the shard installed on the "
              f"spare, made from the replica logs with the node's blocks "
              f"lost, is == the parameters the node held")
    return out


def f64_backward_ssd(torch, ssd, ssm_mod):
    """The SSD scan as the plain version forward (f32) with its gradient
    from ``ssd_bwd_ref`` in f64: a reference for the f32 gradients."""
    class F64Backward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, dt, A, B, C, chunk, init):
            ctx.save_for_backward(x, dt, A, B, C)
            ctx.chunk = chunk
            return ssm_mod.ssd_chunked(x, dt, A, B, C, chunk, init)

        @staticmethod
        def backward(ctx, dy, ds):
            x, dt, A, B, C = ctx.saved_tensors
            g = ssd.ref.ssd_bwd_ref(
                *(t.double() for t in (x, dt, A, B, C)), ctx.chunk,
                dy.double(), None if ds is None else ds.double())
            return tuple(t.float() for t in g[:5]) + (None, None)

    return (lambda x, dt, A, B, C, chunk=256, init_state=None:
            F64Backward.apply(x, dt, A, B, C, chunk, init_state))


def norm_rel(got, want) -> float:
    return float((got - want).norm() / want.norm())


def family_grads(torch, fa, attn, ssd, ssm_mod, arch: str, seq: int) -> dict:
    """The gradients of ``loss_fn`` of an f32 copy of ``arch`` cut to 2
    layers (an enc-dec's encoder too), batch 1 x ``seq``, through the
    kernels (the CUDA-core backwards) against through the plain versions
    (``_blockwise_attention``, ``ssd_chunked``), each leaf in the norm;
    an MoE's kernel runs pinned to the plain run's routing, recorded over
    its forward and backward, and the tape must be taken exactly; an SSD
    arch's readings also against a reference whose SSD backward runs in
    f64. Planted faults, each read the same way: the SSD backward's dB of
    the first head alone (ssm, hybrid); the attention backward's causal
    mask dropped (every arch with causal attention); the cross-attention
    backward under a causal mask (enc-dec); the MoE gates detached."""
    from repro_torch import config
    from repro_torch.models import build_model, moe
    from repro_torch.models.model_zoo import make_batch
    from repro_torch.optim.optimizers import tree_leaves
    published = config.get_model_config(arch)
    cut = dict(n_layers=FAMILY_F32_LAYERS, dtype="float32")
    if published.is_encdec:
        cut["encoder_layers"] = FAMILY_F32_LAYERS
    cfg = dataclasses.replace(published, **cut)
    ssd_arch = cfg.family in ("ssm", "hybrid")
    model = build_model(cfg)
    params = model.init(SEED, device=DEVICE)
    for p_ in tree_leaves(params):
        p_.requires_grad_(True)
    if ssd_arch:
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
        tok = torch.randint(0, cfg.vocab_size, (1, seq), generator=gen,
                            device=DEVICE, dtype=torch.int32)
        batch = {"tokens": tok, "labels": torch.roll(tok, -1, dims=1)}
    else:
        batch = make_batch(cfg, config.ShapeConfig("f32 gradients", seq, 1,
                                                   "train"),
                           seed=SEED + 5, device=DEVICE)
    tape = RoutingTape(torch, moe)
    plain_calls = []

    def grads(swaps, detach_gates=False):
        """Loss and gradients with ``swaps`` in place; the plain run (no
        tape yet) records the routing, every other run is pinned to it."""
        saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        routing = (tape.pin(plain_calls, detach_gates) if plain_calls
                   else tape.record())
        try:
            for p_ in tree_leaves(params):
                p_.grad = None
            with routing as calls:
                loss, _ = model.loss_fn(params, batch)
                loss.backward()
            if not plain_calls and calls:
                plain_calls.extend(calls)
            elif plain_calls:
                check(not tape.queue, f"{arch}: the pinned run took each of "
                      f"the {len(plain_calls)} recorded routings once")
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)
        out = [p_.grad.detach().clone() for p_ in tree_leaves(params)]
        for p_ in tree_leaves(params):
            p_.grad = None
        return float(loss.detach()), out

    plain = [(fa.ops, "flash_attention", plain_attention(attn)),
             (ssd.ops, "ssd_scan", plain_ssd(ssm_mod))]
    loss_p, g_p = grads(plain)
    fa.ops.reset_counts()
    ssd.ops.reset_counts()
    loss_k, g_k = grads([])
    launches = {"flash_attn": (fa.ops.flash_attention.launches,
                               fa.ops.flash_attention.bwd_launches),
                "flash_attn_bwd_by_kernel":
                    dict(fa.ops.flash_attention.bwd_launches_by_kernel),
                "ssd_scan": (ssd.ops.ssd_scan.launches,
                             ssd.ops.ssd_scan.bwd_launches),
                "ssd_scan_by_kernel": dict(ssd.ops.ssd_scan.launches_by_kernel),
                "ssd_scan_bwd_by_kernel":
                    dict(ssd.ops.ssd_scan.bwd_launches_by_kernel)}
    rels = [norm_rel(a, b) for a, b in zip(g_k, g_p)]
    readings = {"kernels_vs_plain_max_rel": max(max_rel(a, b)
                                                for a, b in zip(g_k, g_p))}
    if ssd_arch:
        _, g_64 = grads([plain[0], (ssd.ops, "ssd_scan",
                                    f64_backward_ssd(torch, ssd, ssm_mod))])
        readings.update({
            "kernels_vs_f64_norm": max(norm_rel(a, b)
                                       for a, b in zip(g_k, g_64)),
            "plain_vs_f64_norm": max(norm_rel(a, b)
                                     for a, b in zip(g_p, g_64)),
            "kernels_vs_f64_max_rel": max(max_rel(a, b)
                                          for a, b in zip(g_k, g_64)),
            "plain_vs_f64_max_rel": max(max_rel(a, b)
                                        for a, b in zip(g_p, g_64))})
        del g_64
    del g_k

    def planted(swaps, detach_gates=False):
        _, g_bad = grads(swaps, detach_gates)
        return max(norm_rel(a, b) for a, b in zip(g_bad, g_p))

    faults = {}
    if ssd_arch:
        real_ssd_bwd = ssd.kernel.launch_bwd

        def db_first_head(x, dt, A, B, C, chunk, priors, dy, dstate=None,
                          **kw):
            out = list(real_ssd_bwd(x, dt, A, B, C, chunk, priors, dy,
                                    dstate, **kw))
            out[3] = real_ssd_bwd(x[:, :, :1], dt[..., :1], A[:1], B, C,
                                  chunk, priors[:, :1], dy[:, :, :1],
                                  None if dstate is None
                                  else dstate[:, :1])[3]
            return tuple(out)

        faults[FAULT_SSD_DB] = planted([(ssd.kernel, "launch_bwd",
                                         db_first_head)])
    real_bwd = fa.kernel.launch_bwd
    if cfg.family != "ssm":
        faults[FAULT_BWD_CAUSAL] = planted([(
            fa.kernel, "launch_bwd",
            lambda q, k, v, o, lse, do, causal, **kw:
                real_bwd(q, k, v, o, lse, do, False, **kw))])
    if cfg.is_encdec:
        faults[FAULT_CROSS_BWD_CAUSAL] = planted([(
            fa.kernel, "launch_bwd",
            lambda q, k, v, o, lse, do, causal, **kw:
                real_bwd(q, k, v, o, lse, do,
                         causal or q.shape[1] != k.shape[1], **kw))])
    if cfg.is_moe:
        faults[FAULT_MOE_GATES_DETACHED] = planted([], detach_gates=True)
    n_attn = 0 if cfg.family == "ssm" else (
        3 * FAMILY_F32_LAYERS if cfg.is_encdec else FAMILY_F32_LAYERS)
    n_ssd = FAMILY_F32_LAYERS if ssd_arch else 0
    out = {"arch": arch, "layers": FAMILY_F32_LAYERS, "seq": seq,
           "loss_kernel": loss_k, "loss_plain": loss_p,
           "norm_rel": max(rels), "readings": readings,
           "routing_tape_calls": len(plain_calls),
           "planted": faults, "launches": launches}
    print(f"  gradients of loss_fn, {arch} f32 at {FAMILY_F32_LAYERS} "
          f"layers, batch 1 x {seq}: kernels vs plain versions, largest "
          f"leaf {max(rels):.4g} in the norm (losses {loss_k:.6f} / "
          f"{loss_p:.6f}); {json.dumps(readings)}"
          + (f"; routing pinned to the plain run's {len(plain_calls)} "
             f"top_k_gates calls (forward and remat's recompute)"
             if cfg.is_moe else "")
          + f"; planted {json.dumps(faults)}; launches {launches}")
    check(launches["ssd_scan"] == (2 * n_ssd, n_ssd)
          and launches["ssd_scan_by_kernel"] == {"mma": 0, "simt": 2 * n_ssd}
          and launches["ssd_scan_bwd_by_kernel"] == {"mma": 0, "simt": n_ssd}
          and launches["flash_attn"] == (2 * n_attn, n_attn)
          and launches["flash_attn_bwd_by_kernel"] == {"mma": 0,
                                                      "simt": n_attn},
          f"{arch}: the kernels' route, f32 on the CUDA cores: each forward "
          f"twice and each backward once a layer")
    if cfg.is_moe:
        check(len(plain_calls) > 0, f"{arch}: the routing tape recorded "
              f"{len(plain_calls)} top_k_gates calls")
    check(max(rels) <= TRAIN_GRAD_TOLERANCE, f"{arch}: gradients through "
          f"the kernels vs the plain versions, each leaf in the norm: "
          f"{max(rels):.4g} (tol {TRAIN_GRAD_TOLERANCE})")
    for fault, bad in faults.items():
        check(bad > TRAIN_GRAD_TOLERANCE, f"{arch}: planted fault ({fault}) "
              f"reads {bad:.4g}, above the limit {TRAIN_GRAD_TOLERANCE}")
    del params, g_p, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_train_families(torch, fa, attn, ssd, ssm_mod) -> dict:
    """Phase 21: the ssd_scan backward kernels (bf16 on the tensor cores,
    f32 on the CUDA cores) against their plain version at five shapes;
    hymba-1.5b (a node failure recovered) and mamba2-2.7b trained whole,
    moonshot-v1-16b-a3b cut in depth and whisper-medium whole, through
    ``Trainer``; gradients of hymba, mamba2, moonshot (routing pinned) and
    whisper through the kernels against the plain versions on f32
    copies."""
    print("phase 21: the ssm, hybrid, MoE and enc-dec families trained -- "
          "the ssd_scan backward kernels against their plain version; "
          "hymba-1.5b and mamba2-2.7b whole, moonshot-v1-16b-a3b cut in "
          "depth, whisper-medium whole through Trainer; gradients of all "
          "four through the kernels against the plain versions")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  device memory held before the phase: "
          f"{torch.cuda.memory_allocated()} bytes")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 21)

    def randn(*shape, dtype="bfloat16"):
        return torch.randn(*shape, generator=gen, device=DEVICE).to(
            getattr(torch, dtype))

    t0 = time.perf_counter()
    out = {"bwd": []}
    for case in SSD_BWD_CASES:
        out["bwd"].append(check_ssd_bwd_case(torch, ssd, ssm_mod, randn,
                                             case))
        gc.collect()
        torch.cuda.empty_cache()
    out["bwd_s"] = time.perf_counter() - t0
    print(f"  the backward's shapes: {out['bwd_s']:.1f} s")
    out["train"] = {}
    for arch, layers, batch, seq, steps, fail, cap, log_dt in FAMILY_TRAIN:
        t1 = time.perf_counter()
        out["train"][arch] = train_family(torch, fa, attn, ssd, ssm_mod,
                                          arch, layers, batch, seq, steps,
                                          fail, cap, log_dt)
        out["train"][arch]["wall_s"] = time.perf_counter() - t1
        print(f"  {arch}: {out['train'][arch]['wall_s']:.1f} s")
    out["grads_f32"] = {arch: family_grads(torch, fa, attn, ssd, ssm_mod,
                                           arch, seq)
                        for arch, seq in FAMILY_GRAD_ARCHS}
    out["phase_s"] = time.perf_counter() - t0
    print(f"  phase 21: {out['phase_s']:.1f} s")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", help="also write the measured numbers "
                    "as JSON to this path")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import contention as C
    from repro_torch.core import engine as E
    from repro_torch.core import scenarios as Sc
    from repro_torch.core import simulator as S
    from repro_torch.core import telemetry as T
    from repro_torch.kernels import log_compress as lc
    from repro_torch.kernels.bank_scan import kernel, ops, ref
    from repro_torch.kernels import store_timeline as stl
    from repro_torch.kernels.log_compress import kernel as lc_kernel
    from repro_torch.kernels.log_compress import ref as lc_ref
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.core import chaos
    from repro_torch.core import serving as sv
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import serve_scenarios
    from repro_torch.models import attention as attn
    from repro_torch.models import moe
    from repro_torch.models import ssm as ssm_mod
    from repro_torch import config

    # plain f32 products in full f32 on the card, never TF32 (both knobs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device {name}")
    print("kernels: bank_scan (CUDA C++, src/repro_torch/csrc/bank_scan.cu)"
          " replaces src/repro/kernels/bank_scan/kernel.py:91 "
          "bank_scan_pallas; compress / decompress (CUDA C++, "
          "src/repro_torch/csrc/log_compress.cu) replace "
          "src/repro/kernels/log_compress/kernel.py:41 compress_pallas / "
          ":67 decompress_pallas; flash_attn (CUDA C++, bf16 on the "
          "tensor cores and f32 on the CUDA cores, "
          "src/repro_torch/csrc/flash_attn.cu) replaces "
          "src/repro/kernels/flash_attn/kernel.py:82 flash_attention_pallas; "
          "flash_attn_bwd (CUDA C++, bf16 on the tensor cores and f32 on "
          "the CUDA cores, src/repro_torch/csrc/flash_attn_bwd.cu) replaces "
          "XLA autodiff of "
          "src/repro/models/attention.py:123 _blockwise_attention; "
          "ssd_scan_bwd (CUDA C++, bf16 on the tensor cores and f32 on the "
          "CUDA cores, src/repro_torch/csrc/ssd_scan_bwd.cu) replaces XLA "
          "autodiff of "
          "src/repro/models/ssm.py:94 ssd_chunked; "
          "ssd_scan (CUDA C++, bf16 as three chunk-parallel passes on the "
          "tensor cores and f32 on the CUDA cores, "
          "src/repro_torch/csrc/ssd_scan.cu) replaces "
          "src/repro/kernels/ssd_scan/kernel.py:79 ssd_scan_pallas; "
          "store_timeline (CUDA C++, src/repro_torch/csrc/store_timeline.cu)"
          " replaces two lax.scans, src/repro/core/simulator.py:1229 "
          "_timeline and :1290 _timeline_batch")
    t_start = time.perf_counter()
    build = phase_build([kernel.LIBRARY, lc_kernel.LIBRARY,
                         fa.kernel.LIBRARY, fa.kernel.BWD_LIBRARY,
                         ssd.kernel.LIBRARY, ssd.kernel.BWD_LIBRARY,
                         stl.kernel.LIBRARY])
    # the five rules and the per-lane one, each on every register depth
    # and on the ring in memory
    check_no_spills(stl.kernel.LIBRARY, "store_timeline_kernel",
                    (len(S.CONFIGS) + 1)
                    * (len(stl.kernel.register_ring_depths()) + 1))
    # head dim 160: the f32 and bf16 CUDA-core and the tensor-core kernels
    check_no_spills(fa.kernel.LIBRARY, "Li160E", 3)
    # the backward's tensor-core kernels at every head dim: no spill but
    # the few bytes ptxas gives the dK / dV kernel at D 32
    for d in fa.kernel.HEAD_DIMS:
        for kern in ("flash_attn_bwd_dkdv_mma_kernel",
                     "flash_attn_bwd_dq_mma_kernel"):
            check_no_spills(fa.kernel.BWD_LIBRARY, f"{kern}ILi{d}E", 1,
                            BWD_MMA_SPILLS.get((kern, d), (0, 0)))
    build["flash_attn_bwd_mma_spills"] = {
        re.search(r"(flash_attn_bwd_\w+?_mma_kernelILi\d+E)", n).group(1): v
        for n, v in ptxas_spills(ptxas_log(fa.kernel.BWD_LIBRARY)).items()
        if "_mma_kernel" in n}
    print(f"  flash_attn_bwd tensor-core kernels, (spill store, load) bytes: "
          f"{build['flash_attn_bwd_mma_spills']}")
    # the SSD backward's tensor-core kernels at every (p, n padding): none
    # spills but the rows kernel, by at most SSD_BWD_ROWS_SPILLS bytes
    for kern, most in (("ssd_bwd_chunk_mma_kernel", (0, 0)),
                       ("ssd_bwd_keys_mma_kernel", (0, 0)),
                       ("ssd_bwd_rows_mma_kernel", SSD_BWD_ROWS_SPILLS)):
        check_no_spills(ssd.kernel.BWD_LIBRARY, kern,
                        len(ssd.kernel.HEAD_DIMS) * 4, most)
    build["ssd_scan_bwd_spills"] = {
        n: v for n, v in ptxas_spills(ptxas_log(ssd.kernel.BWD_LIBRARY)).items()
        if any(v)}
    print(f"  ssd_scan_bwd instantiations with a spill, (store, load) bytes: "
          f"{build['ssd_scan_bwd_spills']}")
    err2 = phase_kernel_vs_plain(torch, S, Sc, ops, ref)
    fig10 = phase_fig10(torch, S, E, Sc, C, ops, ref)
    mega = phase_mega(torch, S, E, Sc, T, ops, ref)
    mega_res = mega.pop("results")
    S.clear_sim_caches()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    err5 = phase_compress_vs_plain(torch, lc, lc_ref)
    faults = phase_fault_scenarios(Sc)
    paper = phase_paper_width(torch, lc, lc_ref)
    torch.cuda.empty_cache()
    model_k = phase_model_kernels_vs_plain(torch, fa, ssd, attn, ssm_mod)
    torch.cuda.empty_cache()
    served = phase_serve(torch, serve_mod, fa, ssd, attn, ssm_mod)
    torch.cuda.empty_cache()
    err10 = phase_timeline_vs_plain(torch, S, Sc, stl)
    routes = phase_fig10_routes(torch, S, E, C, Sc, stl, ops)
    mega_st = phase_mega_stacked(torch, S, E, Sc, T, stl, ops)
    served_sc = phase_serving(torch, S, E, Sc, sv, kernel, ops, mega_res)
    resil = phase_resilience(torch, S, E, Sc, chaos, serve_scenarios, ops,
                             mega_res)
    del mega_res
    S.clear_sim_caches()
    served_moe = phase_serve_moe(torch, serve_mod, fa, ssd, attn, moe)
    cut = phase_cut_configs(torch, serve_mod, config, fa, ssd, attn, moe)
    ycsb = phase_ycsb(torch)
    whisper = phase_serve_family(torch, serve_mod, fa, attn, 18,
                                 WHISPER_ARCH, WHISPER_BATCH, WHISPER_PROMPT,
                                 WHISPER_GEN, None)
    vlm = phase_serve_family(torch, serve_mod, fa, attn, 19, VLM_ARCH,
                             VLM_BATCH, VLM_PROMPT, VLM_GEN, VLM_F32_LAYERS)
    train = phase_train(torch, fa, attn, ssd)
    fam = phase_train_families(torch, fa, attn, ssd, ssm_mod)

    entry = {
        "name": "bank_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/bank_scan.cu",
        "replaces": "src/repro/kernels/bank_scan/kernel.py:91",
        "launches": (fig10["launches"] + mega["launches"]
                     + routes["launches"]["stacked"]["bank_scan"]
                     + routes["launches"]["banked"]["bank_scan"]
                     + mega_st["launches"] + mega_st["banked_launches"]
                     + served_sc["launches"] + resil["launches"]),
        "max_abs_err": max(err2, fig10["max_abs_err"], mega["max_abs_err"]),
        "ms": mega["kernel_ms"], "plain_ms": mega["plain_ms"],
        "bound_ms": mega["bound_ms"], "bound_by": mega["bound_by"],
        "library_ms": None, "chain_floor_ms": mega["chain_floor_ms"],
        "tolerance": TOLERANCE,
        "paths": [
            {"path": "fig10 blocked", "lanes": fig10["lanes"],
             "launches": fig10["launches"], "ms": fig10["kernel_ms"],
             "plain_ms": fig10["plain_ms"], "bound_ms": fig10["bound_ms"],
             "chain_floor_ms": fig10["chain_floor_ms"]},
            {"path": "mega-grid stream, per tile",
             "lanes": -(-E._default_tile_cells(N_STORES) // 8) * 8,
             "launches": mega["launches"], "ms": mega["kernel_ms"],
             "plain_ms": mega["plain_ms"], "bound_ms": mega["bound_ms"],
             "chain_floor_ms": mega["chain_floor_ms"]},
            {"path": "fig10 stacked and banked routes",
             "launches": (routes["launches"]["stacked"]["bank_scan"]
                          + routes["launches"]["banked"]["bank_scan"])},
            {"path": "mega-grid stacked and banked stream tiers",
             "launches": mega_st["launches"] + mega_st["banked_launches"]},
            {"path": "scenario service stream, 4 logical shards",
             "launches": served_sc["launches"]},
            {"path": "resilience: 4-shard runs, recoveries, launcher",
             "launches": resil["launches"]},
        ],
    }
    st_entry = {
        "name": "store_timeline", "route": "cuda",
        "source": "src/repro_torch/csrc/store_timeline.cu",
        "replaces": "src/repro/core/simulator.py:1229",
        "replaces_also": "src/repro/core/simulator.py:1290",
        "launches": (routes["launches"]["serial"]["serial"]
                     + routes["launches"]["per-step"]["perstep"]
                     + mega_st["serial_launches"]),
        "launches_by_mode": {
            "serial": (routes["launches"]["serial"]["serial"]
                       + mega_st["serial_launches"]),
            "perstep": routes["launches"]["per-step"]["perstep"]},
        "launches_by_ring": {
            ring: (routes["rings"]["serial"][ring]
                   + routes["rings"]["per-step"][ring]
                   + mega_st["serial_rings"][ring])
            for ring in stl.kernel.RINGS},
        "rings": {"register": "sb " + " / ".join(
                      map(str, stl.kernel.register_ring_depths()))
                  + " (unrolled, one register a slot)",
                  "shared": "other depths up to 384 slots",
                  "scratch": "deeper rings, in device memory"},
        "max_abs_err": err10,
        "ms": routes["serial_ms"], "plain_ms": routes["plain_ms"],
        "bound_ms": routes["bound_ms"], "bound_by": routes["bound_by"],
        "library_ms": None, "chain_floor_ms": routes["chain_floor_ms"],
        "perstep_ms": routes["perstep_ms"],
        "perstep_shared_ms": routes["perstep_shared_ms"],
        "perstep_bound_ms": routes["perstep_bound_ms"],
        "perstep_op_ms": routes["perstep_op_ms"],
        "ms_by_config": routes["ms_by_config"],
        "bound_ms_by_config": routes["bound_ms_by_config"],
        "tolerance": TOLERANCE,
    }
    lc_entries = [{
        "name": f"log_compress.{op}", "route": "cuda",
        "source": "src/repro_torch/csrc/log_compress.cu",
        "replaces": f"src/repro/kernels/log_compress/kernel.py:{line}",
        "launches": paper["launches"][i],
        "max_abs_err": max(err5, paper["max_abs_err"]),
        "ms": paper[f"{op}_ms"], "plain_ms": paper[f"{op}_plain_ms"],
        "bound_ms": paper["bound_ms"], "bound_by": paper["bound_by"],
        "library_ms": paper.get(f"{op}_library_ms"),
        "op_ms": paper[f"{op}_op_ms"],
        "tolerance": LC_TOLERANCE,
    } for i, (op, line) in enumerate((("compress", 41), ("decompress", 67)))]
    model_entries = [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/csrc/{name}.cu",
        "replaces": f"src/repro/kernels/{name}/kernel.py:{line}",
        "launches": served["launches"][name],
        "max_abs_err": model_k[f"{key}_err"],
        "ms": model_k[f"{key}_ms"], "plain_ms": model_k[f"{key}_plain_ms"],
        "bound_ms": model_k[f"{key}_bound_ms"],
        "bound_by": model_k[f"{key}_bound_by"],
        "library_ms": model_k.get(f"{key}_library_ms"),
        "tolerance": tol,
    } for name, key, line, tol in (
        ("flash_attn", "attn", 82, ATTN_TOLERANCE),
        ("ssd_scan", "ssd", 79, SSD_TOLERANCE))]
    ssd_entry = model_entries[1]
    ssd_entry["launches_by_kernel"] = served["ssd_launches_by_kernel"]
    ssd_entry["paths"] = [
        {"path": "hymba-1.5b serve, prefill",
         "launches": served["launches"]["ssd_scan"]}] + [
        {"path": f"{arch} train, {len(t['losses'])} steps (forward and "
                 f"remat's recompute)", "launches": t["launches"]["ssd_scan"]}
        for arch, t in fam["train"].items() if t["launches"]["ssd_scan"]] + [
        {"path": f"{arch} f32 at {g['layers']} layers, gradients",
         "launches": g["launches"]["ssd_scan"][0]}
        for arch, g in fam["grads_f32"].items()
        if g["launches"]["ssd_scan"][0]]
    ssd_entry["launches"] = sum(p["launches"] for p in ssd_entry["paths"])
    for key in ("simt_ms", "f32_ms", "passes_ms"):
        ssd_entry[key] = model_k[f"ssd_{key}"]
    attn_entry = model_entries[0]
    attn_entry["simt_ms"] = model_k["attn_simt_ms"]
    attn_entry["shapes"] = [
        {k: t[k] for k in ("shape", "dtype", "ms", "library_ms", "simt_ms",
                           "plain_ms", "bound_ms", "bound_by")}
        for t in model_k["attn_timed"]]
    attn_entry["paths"] = [
        {"path": "hymba-1.5b serve, prefill", "launches":
         served["launches"]["flash_attn"]},
        {"path": f"{MOE_ARCH} serve, prefill", "launches":
         served_moe["launches"]}] + [
        {"path": f"{arch} at {CUT_LAYERS} layers, serve, prefill",
         "launches": cut[arch]["launches"]} for arch in CUT_ARCHS] + [
        {"path": f"{WHISPER_ARCH} serve, prefill (encoder, decoder, cross)",
         "launches": whisper["launches"]},
        {"path": f"{VLM_ARCH} serve, prefill", "launches": vlm["launches"]},
        {"path": f"{TRAIN_ARCH} train, {TRAIN_STEPS} steps (forward and "
                 f"remat's recompute)",
         "launches": train["train"]["launches"]["forward"]}] + [
        {"path": f"{arch} train, {len(t['losses'])} steps (forward and "
                 f"remat's recompute)",
         "launches": t["launches"]["flash_attn"]}
        for arch, t in fam["train"].items() if t["launches"]["flash_attn"]]
    attn_entry["launches"] = sum(p["launches"] for p in attn_entry["paths"])
    bwd_main = train["bwd"][0]
    bwd_entry = {
        "name": "flash_attn_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attn_bwd.cu",
        "replaces": "src/repro/models/attention.py:123",
        "replaces_what": "XLA autodiff of _blockwise_attention (no Pallas "
                         "kernel has a custom_vjp)",
        "launches": train["train"]["launches"]["backward"] + sum(
            t["launches"]["flash_attn_bwd"] for t in fam["train"].values()),
        "launches_by_kernel": {
            k: v + sum(t["launches"]["flash_attn_bwd_by_kernel"][k]
                       for t in fam["train"].values())
            for k, v in train["train"]["launches"][
                "backward_by_kernel"].items()},
        "paths": [{"path": f"{TRAIN_ARCH} train, {TRAIN_STEPS} steps",
                   "launches": train["train"]["launches"]["backward"]}] + [
            {"path": f"{arch} train, {len(t['losses'])} steps",
             "launches": t["launches"]["flash_attn_bwd"]}
            for arch, t in fam["train"].items()
            if t["launches"]["flash_attn_bwd"]],
        "kernel": bwd_main["kernel"],
        "kernels": {"mma": "bf16: flash_attn_bwd_dkdv_mma_kernel + "
                           "flash_attn_bwd_dq_mma_kernel, tensor cores "
                           "(mma.sync m16n8k16)",
                    "simt": "f32, and bf16 by name: flash_attn_bwd_dkdv_"
                            "kernel + flash_attn_bwd_dq_kernel, CUDA cores"},
        "max_abs_err": max(r["max_abs_err"] for r in train["bwd"]),
        "ms": bwd_main["ms"], "plain_ms": bwd_main["plain_ms"],
        "simt_ms": bwd_main["simt_ms"], "dq_ms": bwd_main["dq_ms"],
        "dkdv_ms": bwd_main["dkdv_ms"],
        "bound_ms": bwd_main["bound_ms"], "bound_by": bwd_main["bound_by"],
        "library_ms": bwd_main["library_ms"],
        "library_is": "F.scaled_dot_product_attention forward + backward",
        "fwd_bwd_ms": bwd_main["fwd_bwd_ms"],
        "tolerance": BWD_TOLERANCE_TEXT,
        "shapes": [{k: r[k] for k in ("shape", "dtype", "kernel", "ms",
                                      "simt_ms", "dq_ms", "dkdv_ms",
                                      "fwd_lse_ms", "fwd_bwd_ms",
                                      "library_ms", "plain_ms", "bound_ms",
                                      "bound_by")}
                   for r in train["bwd"]],
    }
    ssd_main = fam["bwd"][0]
    ssd_bwd_paths = [
        {"path": f"{arch} train, {len(t['losses'])} steps",
         "launches": t["launches"]["ssd_scan_bwd"]}
        for arch, t in fam["train"].items() if t["launches"]["ssd_scan_bwd"]
    ] + [{"path": f"{arch} f32 at {g['layers']} layers, gradients",
          "launches": g["launches"]["ssd_scan"][1]}
         for arch, g in fam["grads_f32"].items()
         if g["launches"]["ssd_scan"][1]]
    ssd_bwd_entry = {
        "name": "ssd_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan_bwd.cu",
        "replaces": "src/repro/models/ssm.py:94",
        "replaces_what": "XLA autodiff of ssd_chunked (no Pallas kernel has "
                         "a custom_vjp)",
        "launches": sum(p["launches"] for p in ssd_bwd_paths),
        "paths": ssd_bwd_paths,
        "launches_by_kernel": {
            k: sum(t["launches"]["ssd_scan_bwd_by_kernel"][k]
                   for t in fam["train"].values())
            + sum(g["launches"]["ssd_scan_bwd_by_kernel"][k]
                  for g in fam["grads_f32"].values())
            for k in ("mma", "simt")},
        "kernels": {"mma": "bf16: ssd_bwd_chunk_mma_kernel, "
                           "ssd_bwd_walk_kernel, ssd_bwd_rows_mma_kernel, "
                           "ssd_bwd_keys_mma_kernel, ssd_bwd_dt_kernel, "
                           "ssd_bwd_reduce_mma_kernel, ssd_bwd_da_kernel; "
                           "tensor cores (mma.sync m16n8k16), the products "
                           "with B and C once per head group",
                    "simt": "f32, and bf16 by name: ssd_bwd_chunk_kernel, "
                            "ssd_bwd_walk_kernel, ssd_bwd_tile_kernel, "
                            "ssd_bwd_dt_kernel, ssd_bwd_reduce_kernel, "
                            "ssd_bwd_da_kernel, CUDA cores, f32 sums"},
        "max_abs_err": max(r["max_abs_err"] for r in fam["bwd"]),
        "ms": ssd_main["ms"], "plain_ms": ssd_main["plain_ms"],
        "simt_ms": ssd_main["simt_ms"], "kernel": ssd_main["kernel"],
        "autograd_ms": ssd_main["autograd_ms"],
        "bound_ms": ssd_main["bound_ms"], "bound_by": ssd_main["bound_by"],
        "library_ms": None,
        "fwd_priors_ms": ssd_main["fwd_priors_ms"],
        "tolerance": SSD_BWD_TOLERANCE_TEXT,
        "shapes": [{k: r.get(k) for k in ("shape", "with_init", "kernel",
                                          "ms", "simt_ms", "fwd_priors_ms",
                                          "fwd_ms", "plain_ms", "autograd_ms",
                                          "bound_ms", "bound_by")}
                   for r in fam["bwd"]],
    }
    kernels = [entry] + lc_entries + model_entries + [bwd_entry,
                                                      ssd_bwd_entry, st_entry]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w", encoding="utf-8") as fh:
            json.dump({"card": card, "torch": torch.__version__,
                       "cuda": torch.version.cuda, "build": build,
                       "fig10": fig10, "mega": mega, "faults": faults,
                       "paper_width": paper, "model_kernels": model_k,
                       "serve": served, "timeline_max_abs_err": err10,
                       "fig10_routes": routes, "mega_stacked": mega_st,
                       "serving": served_sc, "resilience": resil,
                       "serve_moe": served_moe, "cut_configs": cut,
                       "ycsb": ycsb, "serve_whisper": whisper,
                       "serve_vlm": vlm, "train": train,
                       "train_families": fam, "kernels": kernels},
                      fh, indent=1, default=str)
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
