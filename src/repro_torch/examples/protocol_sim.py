"""Reproduce the paper's headline evaluation (Figs. 2 and 10) with the
port's trace-driven protocol simulator on the card, compare against the
published claims, and estimate post-failure downtime (SS VII-E).

The whole 9-workload x 5-configuration grid runs as ONE
``simulate_batch`` call on the banked blocked scan (cold, then warm),
then once more through the per-step engine (``chunk_size=0``, the
store-timeline kernel with every commit rule applied before the max-plus
collapse); the two must agree ``==``. A batched ``recovery_sweep``
reports the estimated downtime per workload across the dump interval.

    PYTHONPATH=src python -m repro_torch.examples.protocol_sim
    PYTHONPATH=src python -m repro_torch.examples.protocol_sim \\
        --n-stores 2000 --device cpu       # the plain versions on the CPU
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import torch

from repro_torch.configs.recxl_paper import PAPER_CLAIMS, WORKLOADS
from repro_torch.core.scenarios import recovery_sweep
from repro_torch.core.simulator import (
    CONFIGS,
    ScenarioSpec,
    geomean_slowdowns,
    simulate_batch,
    slowdowns_from_results,
)
from repro_torch.device import resolve_device

N_STORES = 30_000


def _fields(r) -> tuple:
    return tuple(getattr(r, f.name) for f in dataclasses.fields(r)
                 if f.name != "meta")


def _synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-stores", type=int, default=N_STORES,
                    help="stores per cell (default %(default)s)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n = args.n_stores

    print(f"simulating 9 workloads x 5 configurations on {dev} "
          f"(16 CN / 16 MN cluster, Table II parameters, {n} stores per "
          f"cell)...")
    specs = [ScenarioSpec(w, c) for w in WORKLOADS for c in CONFIGS]
    t0 = time.perf_counter()
    results = simulate_batch(specs, n_stores=n, device=dev)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = simulate_batch(specs, n_stores=n, device=dev)
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    perstep = simulate_batch(specs, n_stores=n, chunk_size=0, device=dev)
    _synchronize(dev)
    perstep_s = time.perf_counter() - t0
    same = [_fields(r) for r in perstep] == [_fields(r) for r in results]
    if not same:
        raise RuntimeError("the per-step engine and the blocked scan "
                           "disagree")
    table = slowdowns_from_results(results)
    gm = geomean_slowdowns(table)
    print(f"...{len(specs)} cells: {cold:.2f} s cold, {warm * 1e3:.0f} ms "
          f"warm (banked blocked scan); per-step engine {perstep_s * 1e3:.0f}"
          f" ms, every field == the blocked scan's")

    print(f"\n{'workload':14s}" + "".join(f"{c:>11s}" for c in CONFIGS))
    for w, row in table.items():
        print(f"{w:14s}" + "".join(f"{row[c]:11.2f}" for c in row))

    print("\nheadline comparison (slowdown vs WB, geomean):")
    rows = [
        ("write-through (WT)", gm["wt"], PAPER_CLAIMS["wt_slowdown_geomean"]),
        ("ReCXL-baseline", gm["baseline"],
         PAPER_CLAIMS["baseline_slowdown_geomean"]),
        ("ReCXL-parallel", gm["parallel"],
         PAPER_CLAIMS["baseline_slowdown_geomean"] * 0.97),
        ("ReCXL-proactive", gm["proactive"],
         PAPER_CLAIMS["proactive_slowdown_geomean"]),
    ]
    print(f"  {'configuration':22s}{'reproduced':>12s}{'paper':>8s}")
    for name, got, paper in rows:
        print(f"  {name:22s}{got:12.2f}{paper:8.2f}")

    print("\nestimated downtime after a CN fail-stop (SS VII-E model,")
    print("failure at 10% / 50% / 90% of the Logging-Unit dump interval):")
    sweep = recovery_sweep(cn_counts=(16,), device=dev)
    print(f"  {'workload':14s}{'early':>9s}{'mid':>9s}{'late':>9s}   (ms)")
    downtime: Dict[str, List[float]] = {}
    for w in sweep.workloads:
        downtime[w] = [sweep.total_ms(w, t, 16) for t in sweep.fail_times_ms]
        print(f"  {w:14s}" + "".join(f"{ms:9.3f}" for ms in downtime[w]))
    return {"table": table, "geomeans": gm, "downtime_ms": downtime,
            "cold_s": cold, "warm_s": warm, "perstep_s": perstep_s}


if __name__ == "__main__":
    main()
