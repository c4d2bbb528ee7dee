"""The port's flight recorder on its engine, daemon and recovery paths
against the JAX package -- twins of ``tests/test_telemetry.py``'s
pipeline tests.

Recording never changes a number: a traced ``run_grid`` is ``==`` the
untraced one and the JAX package's, memo keys and bank bytes stay put,
and a traced re-run of a warm grid builds zero tile programs. The span
taxonomy is the JAX package's: the pipeline spans nest and balance per
thread, the daemon records its flush spans and latency histograms, and
a chaos shard loss emits detection -> rollback -> rebuild -> re-place
-> re-dispatch in that order. The protocol counters equal the JAX
package's: integer counters ``==``, float counters ``math.isclose``
(XLA and numpy sum them in different orders).
"""

import dataclasses
import json
import math

import pytest

from repro.core import engine as JE
from repro.core import simulator as JS
from repro.core import telemetry as jtm
from repro_torch.core import chaos
from repro_torch.core import engine as E
from repro_torch.core import telemetry as tm
from repro_torch.core.scenarios import chaos_grid, sweep_grid
from repro_torch.core.serving import ScenarioServer
from repro_torch.core.simulator import (
    PAPER_CLUSTER,
    _plane_keys,
    _specs_key,
    clear_sim_caches,
    get_trace_bank,
)

N = 600
CPU = "cpu"
GRID = sweep_grid(workloads=("ycsb", "canneal"),
                  configs=("wb", "proactive"),
                  sb_sizes=(None, 48), n_replicas=(None, 3))


def fields(r):
    return tuple(getattr(r, f.name) for f in dataclasses.fields(r)
                 if f.name != "meta")


def jax_specs(specs):
    return [JS.ScenarioSpec(**dataclasses.asdict(s)) for s in specs]


@pytest.fixture(autouse=True)
def _no_recorder_leaks():
    tm.disable()
    jtm.disable()
    yield
    tm.disable()
    jtm.disable()


def test_traced_run_grid_equal_keys_bank_and_programs():
    clear_sim_caches()
    res_off = E.run_grid(GRID, n_stores=N, device=CPU)
    keys_off = [_plane_keys(s, PAPER_CLUSTER) for s in GRID]
    skey_off = _specs_key(tuple(GRID), N, PAPER_CLUSTER)
    bank_off = get_trace_bank(GRID, N, PAPER_CLUSTER).nbytes
    tc = E.trace_count()
    with tm.recording() as rec:
        res_on = E.run_grid(GRID, n_stores=N, device=CPU)
        summ = rec.summary()
    assert E.trace_count() == tc, "tracing a warm grid must build 0"
    ref = JE.run_grid(jax_specs(GRID), n_stores=N, n_shards=1)
    assert [fields(r) for r in res_on] == [fields(r) for r in res_off] \
        == [fields(r) for r in ref]
    assert [_plane_keys(s, PAPER_CLUSTER) for s in GRID] == keys_off
    assert _specs_key(tuple(GRID), N, PAPER_CLUSTER) == skey_off
    assert get_trace_bank(GRID, N, PAPER_CLUSTER).nbytes == bank_off
    assert summ["spans"]["tile/dispatch"]["count"] >= 1
    assert summ["counters"]["proto/cells"] == len(GRID)
    assert res_on[0].meta["telemetry"] is not None
    assert "telemetry" not in (res_off[0].meta or {})


@pytest.mark.parametrize("n_shards", [1, 4])
def test_pipeline_spans_nest_and_balance_per_thread(tmp_path, n_shards):
    clear_sim_caches()
    path = tmp_path / "grid.jsonl"
    with tm.recording() as rec:
        E.run_grid(GRID, n_stores=N, n_shards=n_shards, device=CPU)
        rec.export_chrome(str(path))
        summ = rec.summary()
    for name in ("tile/prep", "tile/h2d", "tile/dispatch", "tile/drain",
                 "bank/place", "compile/warm"):
        assert summ["spans"][name]["count"] >= 1, name
    assert summ["gauges"]["engine/in_flight_tiles"] >= 0
    assert "engine/prefetch_queue_depth" in summ["gauges"]
    # prefetch + compile-warm threads record off the main thread
    assert summ["threads"] >= 2
    stats = tm.validate_chrome_trace(str(path))
    assert stats["threads"] == summ["threads"]
    depth = {}
    for ln in path.read_text().splitlines():
        ev = json.loads(ln)
        if ev["ph"] == "B":
            depth[ev["tid"]] = depth.get(ev["tid"], 0) + 1
        elif ev["ph"] == "E":
            depth[ev["tid"]] = depth[ev["tid"]] - 1
            assert depth[ev["tid"]] >= 0
    assert all(v == 0 for v in depth.values())


def test_daemon_spans_and_latency_histograms():
    clear_sim_caches()
    with ScenarioServer(n_stores=N, batch_cells=8, batch_window_ms=1.0,
                        device=CPU) as srv:
        srv.warm(GRID[:8])
        with tm.recording() as rec:
            srv.query_batch(GRID)
            for f in [srv.submit(s) for s in GRID[:4]]:
                f.result(timeout=120)
            st = srv.stats()
            summ = rec.summary()
    assert summ["spans"]["serve/flush"]["count"] >= 2
    assert summ["spans"]["serve/bank_sync"]["count"] >= 1
    assert summ["spans"]["serve/scan"]["count"] >= 1
    q = summ["dists"]["serve/query_ms"]
    assert q["count"] == len(GRID) + 4
    assert summ["dists"]["serve/queue_wait_ms"]["count"] >= 4
    assert summ["dists"]["serve/window_wait_ms"]["count"] >= 1
    hits = summ["counters"]["serve/lane_hits"]
    misses = summ["counters"]["serve/lane_misses"]
    assert hits + misses == len(GRID) + 4
    assert misses >= 1
    assert st["telemetry"]["spans"].keys() == summ["spans"].keys()


def test_chaos_recovery_timeline_span_order():
    grid = chaos_grid()[:24]
    clear_sim_caches()
    base = E.run_grid(grid, n_stores=N, tile_cells=8, n_shards=2,
                      device=CPU)
    with chaos.inject(chaos.ChaosConfig(lose_shard=1, lose_at_dispatch=2)):
        with tm.recording() as rec:
            res = E.run_grid(grid, n_stores=N, tile_cells=8, n_shards=2,
                             device=CPU)
            evs = rec.span_events("recover")
            summ = rec.summary()
    assert [fields(r) for r in res] == [fields(r) for r in base]
    begins = [nm for ph, _t, nm, _tid in evs if ph == "B"]
    assert begins == ["recover", "recover/detect", "recover/rollback",
                      "recover/rebuild", "recover/replace",
                      "recover/redispatch"]
    parent = summ["spans"]["recover"]["total"]
    for child in ("recover/detect", "recover/rollback",
                  "recover/rebuild", "recover/replace"):
        assert summ["spans"][child]["total"] <= parent + 1e-6
    assert summ["counters"]["chaos/faults_detected"] == 1
    assert summ["counters"]["chaos/shard_loss"] == 1
    assert summ["spans"]["chaos/replica_rebuild"]["count"] == 1
    assert summ["spans"]["chaos/verify_rebuild"]["count"] == 1


def test_protocol_counters_equal_jax():
    """The ``proto/*`` counters and distributions of a traced run equal
    the JAX package's: integer counters ``==``, float ones within
    ``math.isclose`` (the float sums are accumulated in different orders
    -- the reason the reference's own test of ``proto/log_unit_bytes``
    against ``sum()`` can fail), and each equals the results' own
    totals the same way."""
    clear_sim_caches()
    with tm.recording() as rec:
        res = E.run_grid(GRID, n_stores=N, device=CPU)
        summ = rec.summary()
    JS.clear_sim_caches()
    with jtm.recording() as jrec:
        JE.run_grid(jax_specs(GRID), n_stores=N, n_shards=1)
        jsumm = jrec.summary()
    proto = sorted(k for k in jsumm["counters"] if k.startswith("proto/"))
    assert proto == sorted(k for k in summ["counters"]
                           if k.startswith("proto/"))
    for k in proto:
        got, want = summ["counters"][k], jsumm["counters"][k]
        if isinstance(want, int) and isinstance(got, int):
            assert got == want, k
        else:
            assert math.isclose(got, want, rel_tol=1e-12), k
    assert summ["counters"]["proto/cells"] == len(GRID)
    assert summ["counters"]["proto/repl_msgs"] == \
        sum(r.n_repl_msgs for r in res)
    assert math.isclose(summ["counters"]["proto/log_unit_bytes"],
                        sum(r.max_log_bytes for r in res), rel_tol=1e-12)
    for dist in ("proto/dump_bw_gbps", "proto/cxl_mem_bw_gbps",
                 "proto/dir_queue_occupancy"):
        assert summ["dists"][dist]["count"] == len(GRID), dist
        assert summ["dists"][dist]["count"] == jsumm["dists"][dist]["count"]
