#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one CUDA card.

Drives the port's two paths at full width through the entry points a
user calls -- the paper's evaluation, and the ReCXL mechanism
(replication into per-node log rings, Algorithms 1-2 recovery, the
log-dump compressor) -- and holds each hand-written CUDA kernel against
its plain PyTorch version:

1. build ``bank_scan.cu`` and ``log_compress.cu`` from
   ``src/repro_torch/csrc``, one nvcc each, started together;
2. kernel against the plain version on the card, ``==`` on all three
   outputs, over real banks at sb in {1, 7, 24, 48, 72, 200, 500}, a
   ragged n, n = 1, padded lanes and the ``[0]`` view of a sub-bank stack;
3. ``run_sweep(fig10_grid(), n_stores=50_000)`` on the blocked tier: one
   launch, every cell ``==`` the plain version on CPU tensors, three
   cells ``==`` the serial per-store oracle, geomeans inside the paper's
   bands and ``==`` the JAX package's values at this size;
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
   at 8 and 4 bits, ``==`` the plain version on the card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It prints
the card, the build, each phase's checks and times, a ``{"kernels":
[...]}`` line, and as its last line ``{"ok": true, "device": {...}}``.
It exits non-zero, without that line, when a phase fails, when torch
sees no CUDA device, or when the repo's sources are missing.
``--report PATH`` also writes every measured number as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
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
#: geomean_slowdowns(slowdown_table(n_stores=50_000)) of the JAX package
#: on the CPU: the port must give these exact values.
JAX_GEOMEANS_50K = {"wt": 7.800868352151868,
                    "baseline": 2.7793430928059646,
                    "parallel": 2.7555289788601542,
                    "proactive": 1.2559832132009918}
TOLERANCE = "== (max_abs_err 0.0): the scan is IEEE add and max only"
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
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas: {line.strip()}")
        out[f"nvcc_s/{lib.name}"] = nvcc_s
    print(f"  all built and loaded in {secs:.3f} s")
    return out


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
                got = ops.bank_scan(*banks, tr, wv, chunk=sb, sb=sb)
                want = ref.bank_scan_ref(*banks, tr, wv, chunk=sb, sb=sb)
                torch.cuda.synchronize()
                same = all(torch.equal(g, w) for g, w in zip(got, want))
                err = float((got[0] - want[0]).abs().max())
                max_err = max(max_err, err)
                check(same, f"n={n} sb={sb} {name} lanes={len(rows)}: "
                      f"kernel == plain (max_abs_err {err})")
    check_bad_index(torch, ops, cols)
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

    kernel_ms = cuda_ms(lambda: ops.bank_scan(*dev_cols, tr_d, wv_d,
                                              chunk=chunk, sb=sb), 10)
    t0 = time.perf_counter()
    ref.bank_scan_ref(*dev_cols, tr_d, wv_d, chunk=chunk, sb=sb)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    bound_ms, bound_by = scan_bound_ms(N_STORES, tr, wv)
    print(f"  wall: cold {cold_s:.3f} s, warm {warm_s:.3f} s")
    print(f"  kernel {kernel_ms:.4f} ms for {len(tr)} lanes (CUDA events, "
          f"mean of 10); plain version on the card {plain_ms:.1f} ms; "
          f"bound {bound_ms:.5f} ms ({bound_by})")
    return {"launches": launches, "cold_s": cold_s, "warm_s": warm_s,
            "lanes": len(tr), "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
            "geomeans": gm}


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
    print(f"  per tile: kernel {ms_mean:.4f} ms mean (min "
          f"{min(t[0] for t in per_tile):.4f}, max "
          f"{max(t[0] for t in per_tile):.4f}), bound {bound_mean:.5f} ms "
          f"({per_tile[0][2]}); kernel total {kernel_total:.2f} ms of "
          f"{wall_s * 1e3:.1f} ms wall")
    t0 = time.perf_counter()
    ref.bank_scan_ref(*sub_view, tr_d, wv_d, chunk=tile.sig.chunk,
                      sb=tile.sig.sb_uniform)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    print(f"  plain version on the card, one tile: {plain_ms:.1f} ms")
    return {"launches": launches, "wall_s": wall_s, "bank_stats": stats,
            "telemetry_ms": split, "tile_kernel_ms": [t[0] for t in per_tile],
            "tile_bound_ms": [t[1] for t in per_tile], "kernel_ms": ms_mean,
            "kernel_total_ms": kernel_total, "bound_ms": bound_mean,
            "bound_by": per_tile[0][2], "plain_ms": plain_ms,
            "max_abs_err": max_err}


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
    from repro_torch.kernels.log_compress import kernel as lc_kernel
    from repro_torch.kernels.log_compress import ref as lc_ref

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
          ":67 decompress_pallas")
    t_start = time.perf_counter()
    build = phase_build([kernel.LIBRARY, lc_kernel.LIBRARY])
    err2 = phase_kernel_vs_plain(torch, S, Sc, ops, ref)
    fig10 = phase_fig10(torch, S, E, Sc, C, ops, ref)
    mega = phase_mega(torch, S, E, Sc, T, ops, ref)
    S.clear_sim_caches()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    err5 = phase_compress_vs_plain(torch, lc, lc_ref)
    faults = phase_fault_scenarios(Sc)
    paper = phase_paper_width(torch, lc, lc_ref)

    entry = {
        "name": "bank_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/bank_scan.cu",
        "replaces": "src/repro/kernels/bank_scan/kernel.py:91",
        "launches": fig10["launches"] + mega["launches"],
        "max_abs_err": max(err2, fig10["max_abs_err"], mega["max_abs_err"]),
        "ms": mega["kernel_ms"], "plain_ms": mega["plain_ms"],
        "bound_ms": mega["bound_ms"], "bound_by": mega["bound_by"],
        "library_ms": None,
        "tolerance": TOLERANCE,
        "paths": [
            {"path": "fig10 blocked", "lanes": fig10["lanes"],
             "launches": fig10["launches"], "ms": fig10["kernel_ms"],
             "plain_ms": fig10["plain_ms"], "bound_ms": fig10["bound_ms"]},
            {"path": "mega-grid stream, per tile",
             "lanes": -(-E._default_tile_cells(N_STORES) // 8) * 8,
             "launches": mega["launches"], "ms": mega["kernel_ms"],
             "plain_ms": mega["plain_ms"], "bound_ms": mega["bound_ms"]},
        ],
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
    kernels = [entry] + lc_entries
    print(f"total {time.perf_counter() - t_start:.1f} s")
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w", encoding="utf-8") as fh:
            json.dump({"card": card, "torch": torch.__version__,
                       "cuda": torch.version.cuda, "build": build,
                       "fig10": fig10, "mega": mega, "faults": faults,
                       "paper_width": paper, "kernels": kernels},
                      fh, indent=1, default=str)
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
