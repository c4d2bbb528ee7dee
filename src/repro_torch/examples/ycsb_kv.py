"""YCSB-style replicated key-value store (the paper's SS VI workload),
built directly on the port's fine-grained ReCXL Logging Unit.

The twin of the JAX package's ``examples/ycsb_kv.py``: the same
constants, the same ``default_rng(0)`` stream of operations, the same
printed lines and the same assertions, on the port's
``core.logging_unit`` and ``core.replica_groups``.

* records partitioned over nodes by key hash (the CXL-memory analogue);
* every PUT runs the full REPL -> REPL_ACK -> VAL transaction into the
  N_r=3 hash-selected replica Logging Units (row granularity, paper
  Fig. 4/5 semantics);
* periodic dumps snapshot each store to the MN tier;
* halfway through, a node fail-stops: its shard is reconstructed from the
  replica DRAM logs (latest validated version per key, Algorithms 1-2)
  on top of the last dump -- then verified against the lost truth.

    PYTHONPATH=src python -m repro_torch.examples.ycsb_kv
    PYTHONPATH=src python -m repro_torch.examples.ycsb_kv --device cpu

The Logging Units live on ``--device`` (default: the card); the stores
and dumps are host arrays, as in the JAX example.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import logging_unit as lu
from repro_torch.core.replica_groups import line_replicas
from repro_torch.device import resolve_device

N_NODES = 4
N_RECORDS = 1024                  # paper: 500K x 1KB; scaled for the demo
WIDTH = 8                         # words per record
N_REPLICAS = 3
N_OPS = 4000
READ_FRAC = 0.8
DUMP_EVERY = 1000


def owner_of(key: int) -> int:
    return key % N_NODES


def main(argv: Optional[List[str]] = None) -> int:
    """Run the workload; returns the Logging Units' total drops (0)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the Logging Units (default: the "
                         "card)")
    dev = resolve_device(ap.parse_args(argv).device)

    rng = np.random.default_rng(0)
    stores = [np.zeros((N_RECORDS, WIDTH), np.float32)
              for _ in range(N_NODES)]
    units = [lu.init_state(sram_entries=128, dram_entries=4096,
                           n_sources=N_NODES, value_width=WIDTH, device=dev)
             for _ in range(N_NODES)]
    next_ts = np.zeros((N_NODES, N_NODES), np.int64)   # (src, dst) counters
    dumps = [s.copy() for s in stores]                 # MN tier

    def put(key: int, value: np.ndarray) -> None:
        owner = owner_of(key)
        reps = line_replicas(key, N_REPLICAS, N_NODES)
        # REPL fan-out; ACKs are immediate in-process
        row = torch.from_numpy(value).to(dev)
        for r in reps:
            units[r] = lu.receive_repl(units[r], owner, key, row)
        # all ACKs received -> VAL with per-(src, dst) logical timestamps
        for r in reps:
            units[r] = lu.receive_val(units[r], owner, key,
                                      int(next_ts[owner, r]))
            next_ts[owner, r] += 1
            units[r] = lu.drain(units[r], 8)
        # commit
        stores[owner][key // N_NODES] = value

    def get(key: int) -> np.ndarray:
        return stores[owner_of(key)][key // N_NODES]

    # ---- run the workload -------------------------------------------------
    n_reads = n_writes = 0
    fail_at = N_OPS // 2 + DUMP_EVERY // 2   # mid dump-interval
    failed = None
    truth_at_failure = None

    for op in range(N_OPS):
        if op == fail_at:
            failed = 2
            truth_at_failure = stores[failed].copy()
            stores[failed] = None          # fail-stop: shard gone
            print(f"op {op}: node {failed} FAILED (shard lost)")
            # --- recovery (Algorithms 1-2) --------------------------------
            recovered = dumps[failed].copy()
            n_from_log = 0
            for key in range(failed, N_RECORDS * N_NODES, N_NODES):
                reps = line_replicas(key, N_REPLICAS, N_NODES)
                best_ts, best_val = -1, None
                for r in reps:
                    if r == failed:
                        continue           # switch never asks the dead node
                    found, ts, val = lu.latest_version(
                        units[r], failed, key)
                    if bool(found) and int(ts) > best_ts:
                        best_ts, best_val = int(ts), val.cpu().numpy()
                if best_val is not None:
                    recovered[key // N_NODES] = best_val
                    n_from_log += 1
            stores[failed] = recovered
            ok = np.allclose(recovered, truth_at_failure)
            print(f"  recovered {n_from_log} records from replica logs "
                  f"(+ dump base); exact match: {ok}")
            assert ok, "recovery mismatch!"

        key = int(rng.integers(0, N_RECORDS * N_NODES))
        key = key - key % 1                       # uniform keys (paper)
        if key // N_NODES >= N_RECORDS:
            key = key % (N_RECORDS * N_NODES)
        if rng.random() < READ_FRAC:
            _ = get(key)
            n_reads += 1
        else:
            put(key, rng.standard_normal(WIDTH).astype(np.float32))
            n_writes += 1

        if (op + 1) % DUMP_EVERY == 0:
            for node in range(N_NODES):
                if stores[node] is not None:
                    dumps[node] = stores[node].copy()
                    units[node] = lu.clear_dram(units[node])
            print(f"op {op + 1}: MN dump + log clear")

    print(f"\ndone: {n_reads} reads, {n_writes} writes "
          f"({100 * READ_FRAC:.0f}/{100 - 100 * READ_FRAC:.0f} mix), "
          f"N_r={N_REPLICAS}")
    drops = sum(int(u.dropped) for u in units)
    print(f"logging-unit drops: {drops} (must be 0)")
    assert drops == 0
    return drops


if __name__ == "__main__":
    main()
