#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one CUDA card.

Drives the port's main path -- the paper's evaluation -- at full width
through the entry points a user calls, and holds the hand-written CUDA
kernel against its plain PyTorch version:

1. build the ``bank_scan`` kernel from ``src/repro_torch/csrc`` with nvcc;
2. kernel against the plain version on the card, ``==`` on all three
   outputs, over real banks at sb in {1, 7, 24, 48, 72, 200, 500}, a
   ragged n, n = 1, padded lanes and the ``[0]`` view of a sub-bank stack;
3. ``run_sweep(fig10_grid(), n_stores=50_000)`` on the blocked tier: one
   launch, every cell ``==`` the plain version on CPU tensors, three
   cells ``==`` the serial per-store oracle, geomeans inside the paper's
   bands and ``==`` the JAX package's values at this size;
4. ``run_sweep(mega_grid(), n_stores=50_000)`` on the stream tier: 27 +
   1 298 bank rows, 2 700 lanes, one launch per tile, 64 sampled lanes
   ``==`` the plain version on CPU.

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

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
N_STORES = 50_000
#: Tiles of the mega-grid at N_STORES: 1 350 lanes per SB group in
#: 160-lane tiles, as the JAX package's plan_tiles gives them.
MEGA_TILES = 18
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


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def phase_build(kernel) -> dict:
    print("phase 1: build bank_scan with nvcc for sm_90a")
    t0 = time.perf_counter()
    kernel.load()
    secs = time.perf_counter() - t0
    path, nvcc_s, log = kernel.LAST_BUILD
    print(f"build: {path.name} in {secs:.3f} s (nvcc {nvcc_s:.3f} s)")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  ptxas: {line.strip()}")
    return {"build_s": secs, "nvcc_s": nvcc_s}


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
    from repro_torch.kernels.bank_scan import kernel, ops, ref

    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device {name}")
    print("kernels: bank_scan (CUDA C++, src/repro_torch/csrc/bank_scan.cu)"
          " replaces src/repro/kernels/bank_scan/kernel.py:91 "
          "bank_scan_pallas")
    t_start = time.perf_counter()
    build = phase_build(kernel)
    err2 = phase_kernel_vs_plain(torch, S, Sc, ops, ref)
    fig10 = phase_fig10(torch, S, E, Sc, C, ops, ref)
    mega = phase_mega(torch, S, E, Sc, T, ops, ref)

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
    print(f"total {time.perf_counter() - t_start:.1f} s")
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w", encoding="utf-8") as fh:
            json.dump({"card": card, "torch": torch.__version__,
                       "cuda": torch.version.cuda, "build": build,
                       "fig10": fig10, "mega": mega, "kernels": [entry]},
                      fh, indent=1, default=str)
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
