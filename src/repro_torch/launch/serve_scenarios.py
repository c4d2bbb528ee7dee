"""Scenario-serving daemon launcher: warm a :class:`ScenarioServer`
on a sweep grid, then drive a mixed query stream against it and report
serve-side latency/cache statistics.

Example (on the CPU; without ``--device`` it runs on the CUDA card)::

    PYTHONPATH=src python -m repro_torch.launch.serve_scenarios \
        --stores 2000 --queries 60 --check --device cpu

The launcher warms the server on a mixed-SB sweep grid, then sends a
query stream that interleaves lane-cache hits (cells of the warm grid),
novel cells (diff-upload misses), a grid-delta request and a couple of
downtime queries -- the daemon's three query shapes -- and prints
p50/p99 latency, throughput, cache-hit ratio and the marginal
host->device bytes per query. ``--check`` re-runs every served cell
through the cold ``simulate_grid`` oracle and asserts ``==`` on every
``SimResult`` field but ``meta``.
"""

import argparse
import dataclasses
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--stores", type=int, default=5_000,
                    help="stores per timeline (n_stores)")
    ap.add_argument("--queries", type=int, default=200,
                    help="live queries to send after warmup")
    ap.add_argument("--batch-cells", type=int, default=32,
                    help="canonical serve-tile size")
    ap.add_argument("--window-ms", type=float, default=2.0,
                    help="async batching window (submit path)")
    ap.add_argument("--shards", type=int, default=1,
                    help="logical shards of the resident bank")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check", action="store_true",
                    help="assert every answer == the cold oracle")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device to serve on (default: the CUDA "
                         "card; 'cpu' runs the plain versions)")
    ap.add_argument("--k-replicas", type=int, default=None,
                    help="sub-bank replica blocks per shard (default: 1, "
                         "or 2 inside a chaos scope)")
    ap.add_argument("--submit-timeout-ms", type=float, default=None,
                    help="default deadline on submit() futures; the "
                         "watchdog fails them with a diagnostic past it")
    ap.add_argument("--watchdog-ms", type=float, default=None,
                    help="fail a wedged daemon flush after this long")
    ap.add_argument("--lose-shard", type=int, default=None,
                    help="inject a shard loss mid-stream (chaos demo: the "
                         "server must recover ==, 0 new tile programs)")
    ap.add_argument("--trace-out", type=str, default=None, metavar="PATH",
                    help="enable the flight recorder and export the run "
                         "as Chrome trace-event JSONL to PATH (load at "
                         "https://ui.perfetto.dev)")
    args = ap.parse_args(argv)

    import contextlib

    import numpy as np

    from repro_torch.core import chaos
    from repro_torch.core import telemetry
    from repro_torch.core.engine import simulate_grid, trace_count
    from repro_torch.core.scenarios import grid_delta, sweep_grid
    from repro_torch.core.serving import ScenarioServer
    from repro_torch.device import resolve_device

    device = resolve_device(args.device)

    if args.trace_out:
        telemetry.enable()

    warm_grid = sweep_grid(seeds=(0, 1), sb_sizes=(None, 48),
                           link_bw_gbps=(None, 40.0))
    novel = grid_delta(warm_grid, workloads=("ycsb", "canneal", "barnes"),
                       configs=("proactive", "baseline"),
                       n_replicas=(2, 4), sb_sizes=(None, 48))

    rng = np.random.default_rng(args.seed)
    stream = [warm_grid[rng.integers(len(warm_grid))] if rng.random() < 0.7
              else novel[rng.integers(len(novel))]
              for _ in range(args.queries)]

    # arm far out so the warm phase runs clean, then re-arm a couple of
    # dispatches into the query stream once warm's dispatch count is known
    scope = (chaos.inject(chaos.ChaosConfig(lose_shard=args.lose_shard,
                                            lose_at_dispatch=1 << 30))
             if args.lose_shard is not None else contextlib.nullcontext())
    with scope as chaos_state, \
         ScenarioServer(n_stores=args.stores, batch_cells=args.batch_cells,
                        batch_window_ms=args.window_ms,
                        n_shards=args.shards, k_replicas=args.k_replicas,
                        submit_timeout_ms=args.submit_timeout_ms,
                        watchdog_ms=args.watchdog_ms, device=device) as srv:
        t0 = time.perf_counter()
        srv.warm(warm_grid)
        t_warm = time.perf_counter() - t0
        print(f"warm: {len(warm_grid)} cells, "
              f"{srv.stats()['bank_rows']} bank rows, "
              f"{srv.stats()['compiled_programs']} programs, "
              f"{t_warm * 1e3:.1f} ms")

        if chaos_state is not None:
            chaos_state.arm_after(2)

        if args.trace_out:
            telemetry.reset()   # trace the live stream, not the warm flush
        srv.reset_stats()
        tc0 = trace_count()
        lat = []
        t0 = time.perf_counter()
        for spec in stream:
            t1 = time.perf_counter()
            srv.query(spec)
            lat.append(time.perf_counter() - t1)
        wall = time.perf_counter() - t0
        st = srv.stats()
        lat_ms = np.sort(np.asarray(lat)) * 1e3
        print(f"served {len(stream)} queries in {wall:.3f} s "
              f"({len(stream) / wall:.0f} q/s)")
        print(f"latency p50 {lat_ms[len(lat_ms) // 2]:.3f} ms  "
              f"p99 {lat_ms[int(len(lat_ms) * 0.99)]:.3f} ms")
        print(f"cache-hit ratio {st['hit_ratio']:.3f}  "
              f"steady-state tile programs {trace_count() - tc0}")
        print(f"marginal h2d {st['h2d_bytes'] / len(stream):.0f} B/query "
              f"(cold full-bank upload {st['bank_bytes']} B)")

        # async path: a submit() burst exercises the daemon thread (and,
        # traced, the queue-wait / batching-window histograms)
        for f in [srv.submit(s) for s in stream[:16]]:
            f.result()

        if chaos_state is not None:
            rep = chaos_state.report()
            for r in rep["recoveries"]:
                print(f"chaos: shard {r['shard']} lost, recovered from "
                      f"{r['source']} in {r['ms']:.1f} ms ({r['mode']})")
            print(f"chaos: k_replicas={srv.k_replicas}, "
                  f"upload retries {rep['upload_retries']}, "
                  f"post-recovery tile programs {trace_count() - tc0}")

        # the other two query shapes
        added = srv.query_grid(workloads=("streamcluster",),
                               configs=("proactive",), n_replicas=(2, 4))
        est = srv.query_downtime("ycsb", fail_time_ms=50.0, n_cns=8)
        print(f"grid-delta query: {len(added)} cells; "
              f"downtime(ycsb, 50ms, 8 CNs) = {est.total_ns / 1e6:.2f} ms")

        if args.check:
            served = srv.query_batch(stream)
            oracle = simulate_grid(stream, n_stores=args.stores,
                                   engine="blocked", device=device)
            for a, b in zip(served, oracle):
                assert _fields(a) == _fields(b), (a.meta, a, b)
            print(f"oracle check: {len(stream)} answers bit-identical")

        if args.trace_out:
            summ = telemetry.summary()
            n = telemetry.export_chrome(args.trace_out)
            q = summ["dists"].get("serve/query_ms", {})
            print(f"telemetry: {n} trace events -> {args.trace_out} "
                  f"({summ['threads']} threads, "
                  f"serve/query_ms p50 {q.get('p50', 0.0):.3f} ms "
                  f"p99 {q.get('p99', 0.0):.3f} ms)")


def _fields(r) -> tuple:
    """Every ``SimResult`` field but ``meta``."""
    return tuple(getattr(r, f.name) for f in dataclasses.fields(r)
                 if f.name != "meta")


if __name__ == "__main__":
    main()
