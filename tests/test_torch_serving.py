"""The port's scenario-serving daemon against the JAX package -- the twin
of ``tests/test_serving.py``.

Every answer ``repro_torch.core.serving.ScenarioServer`` gives (on the
CPU here, ``device="cpu"``) -- lane-cache hit or diff-upload miss, any
batching, any shard count, any interleaving with ``clear_sim_caches()``
-- is ``==`` on every ``SimResult`` field but ``meta`` to the JAX
package's cold ``simulate_batch`` oracle for the same specs (and, on
hypothesis streams, to the JAX package's own ``ScenarioServer``), and
steady-state serving builds zero new tile programs. The bank-geometry
pins are held against the JAX package's numbers.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import simulator as JS
from repro.core.scenarios import downtime_query as jax_downtime_query
from repro.core.serving import ScenarioServer as JaxServer
from repro_torch.core import engine as E
from repro_torch.core import simulator as S
from repro_torch.core.scenarios import (
    contention_mega_grid,
    directory_mega_grid,
    downtime_query,
    grid_delta,
    mega_grid,
    recovery_sweep,
    sweep_grid,
)
from repro_torch.core.serving import ScenarioServer, _row_capacity
from repro_torch.core.simulator import CONFIGS, ScenarioSpec

N = 700
CPU = "cpu"
WORKLOAD_POOL = ("ycsb", "canneal", "barnes", "raytrace", "ocean_ncp")

#: The warm grid every deterministic test heats the daemon with: mixed
#: SB depths, two configs on each side of the replicate/local split.
WARM_GRID = sweep_grid(workloads=("ycsb", "canneal"),
                       configs=("wb", "proactive"),
                       sb_sizes=(None, 48), n_replicas=(None, 3))


def fields(r):
    return tuple(getattr(r, f.name) for f in dataclasses.fields(r)
                 if f.name != "meta")


def jax_specs(specs):
    return [JS.ScenarioSpec(**dataclasses.asdict(s)) for s in specs]


def jax_oracle(specs):
    return [fields(r) for r in JS.simulate_batch(jax_specs(specs),
                                                 n_stores=N)]


def server(**kw):
    return ScenarioServer(n_stores=N, device=CPU, **kw)


def fresh_caches():
    """Drop both packages' memos: a server adopts the digest-memoized
    bank of its first grid and extends it in place, so a bank left by an
    earlier server would change ``meta["bank_rows"]`` on one side only."""
    S.clear_sim_caches()
    JS.clear_sim_caches()


def _spec_pool(draw):
    return ScenarioSpec(
        draw(st.sampled_from(WORKLOAD_POOL)),
        draw(st.sampled_from(CONFIGS)),
        seed=draw(st.integers(min_value=0, max_value=2)),
        n_replicas=draw(st.sampled_from((None, 2, 3))),
        link_bw_gbps=draw(st.sampled_from((None, 40.0))),
        n_cns=draw(st.sampled_from((None, 8))),
        sb_size=draw(st.sampled_from((None, 16, 48))),
        coalescing=draw(st.booleans()))


@st.composite
def query_streams(draw):
    """A ragged mixed-SB query stream: WARM_GRID cells (lane-cache hits)
    interleaved with novel pool cells (diff-upload misses)."""
    n = draw(st.integers(min_value=1, max_value=12))
    stream = []
    for _ in range(n):
        if draw(st.booleans()):
            stream.append(WARM_GRID[draw(st.integers(
                min_value=0, max_value=len(WARM_GRID) - 1))])
        else:
            stream.append(_spec_pool(draw))
    return stream


def lane_count(specs):
    lanes = set()
    for s in specs:
        sb = s.sb_size if s.sb_size is not None \
            else S.PAPER_CLUSTER.store_buffer
        lanes.add((sb,) + S._plane_keys(s, S.PAPER_CLUSTER))
    return len(lanes)


# ---------------------------------------------------------------------------
# Differential: daemon answers == the JAX server and the cold oracle
# ---------------------------------------------------------------------------


@settings(max_examples=4, deadline=None)
@given(query_streams())
def test_daemon_equals_jax_server_and_oracle_on_random_streams(stream):
    fresh_caches()
    with server(batch_cells=8) as srv:
        srv.warm(WARM_GRID)
        warm_again = srv.query_batch(WARM_GRID)
        served = srv.query_batch(stream)
        served_again = srv.query_batch(stream)
        st_ = srv.stats()
    with JaxServer(n_stores=N, batch_cells=8) as jsrv:
        jsrv.warm(jax_specs(WARM_GRID))
        jwarm = jsrv.query_batch(jax_specs(WARM_GRID))
        jserved = jsrv.query_batch(jax_specs(stream))
    oracle = jax_oracle(WARM_GRID + stream)
    S.clear_sim_caches()
    stacked = S.simulate_batch(WARM_GRID + stream, n_stores=N,
                               data_plane="stacked", device=CPU)
    got = [fields(r) for r in warm_again + served]
    assert got == oracle
    assert got == [fields(r) for r in jwarm + jserved]
    assert got == [fields(r) for r in stacked]
    assert [r.meta for r in warm_again + served] == \
        [r.meta for r in jwarm + jserved]
    for x, y in zip(served, served_again):
        assert fields(x) == fields(y)
        assert y.meta["cache"] == "hit"
    assert st_["lane_hits"] >= len(WARM_GRID) + len(stream)
    assert st_["bank_builds"] == 1


def test_hit_and_miss_paths_and_meta_provenance():
    novel = ScenarioSpec("bodytrack", "proactive", n_replicas=4)
    fresh_caches()
    with server(batch_cells=8) as srv:
        srv.warm(WARM_GRID)
        srv.reset_stats()
        hit = srv.query(WARM_GRID[0])
        assert hit.meta["cache"] == "hit"
        assert hit.meta["h2d_bytes"] == 0
        assert srv.stats()["appended_trace_rows"] == 0
        miss = srv.query(novel)
        assert miss.meta["cache"] == "miss"
        assert miss.meta["h2d_bytes"] > 0
        st_ = srv.stats()
        assert st_["appended_trace_rows"] == 1
        assert st_["appended_wv_rows"] == 1
        assert st_["h2d_bytes"] < st_["bank_bytes"]
        again = srv.query(novel)
        assert again.meta["cache"] == "hit"
        assert again.meta["h2d_bytes"] == 0
        assert fields(again) == fields(miss)
    with JaxServer(n_stores=N, batch_cells=8) as jsrv:
        jsrv.warm(jax_specs(WARM_GRID))
        jhit, jmiss = (jsrv.query(s) for s in jax_specs([WARM_GRID[0],
                                                         novel]))
    assert (hit.meta, miss.meta) == (jhit.meta, jmiss.meta)
    assert [fields(hit), fields(miss)] == jax_oracle([WARM_GRID[0], novel])


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_serving_equals_jax(n_shards):
    novel = [ScenarioSpec("barnes", "proactive", seed=2)]
    fresh_caches()
    with server(batch_cells=8, n_shards=n_shards) as srv:
        served = srv.query_batch(WARM_GRID)
        served += srv.query_batch(novel)
    with JaxServer(n_stores=N, batch_cells=8, n_shards=n_shards) as jsrv:
        jserved = jsrv.query_batch(jax_specs(WARM_GRID))
        jserved += jsrv.query_batch(jax_specs(novel))
    assert [fields(r) for r in served] == jax_oracle(WARM_GRID + novel)
    assert [r.meta for r in served] == [r.meta for r in jserved]


def test_capacity_growth_reuploads_and_stays_equal():
    base = [ScenarioSpec("ycsb", "proactive", n_replicas=r) for r in (1, 2)]
    grow = [ScenarioSpec(w, "proactive", n_replicas=4)
            for w in WORKLOAD_POOL] + \
        [ScenarioSpec("ycsb", "baseline", link_bw_gbps=40.0)]
    with server(batch_cells=8, row_pad=4) as srv:
        first = srv.query_batch(base)
        assert srv.stats()["bank_uploads"] == 1
        cap0 = srv.stats()["bank_capacity"]
        grown = srv.query_batch(grow)
        st_ = srv.stats()
        assert st_["bank_uploads"] == 2
        assert st_["bank_capacity"][1] > cap0[1]
        assert _row_capacity(st_["bank_rows"], 4) >= \
            st_["bank_capacity"][1] \
            or st_["bank_capacity"][1] > st_["dev_rows"][1]
        recheck = srv.query_batch(base)
        assert all(r.meta["cache"] == "hit" for r in recheck)
    assert [fields(r) for r in first + grown] == jax_oracle(base + grow)


# ---------------------------------------------------------------------------
# Steady state builds no tile program
# ---------------------------------------------------------------------------


def test_steady_state_serving_builds_zero_programs():
    """After warmup, 100 mixed queries (hits, novel in-capacity misses,
    batches, singles) build zero new tile programs."""
    novel = sweep_grid(workloads=WORKLOAD_POOL,
                       configs=("proactive", "baseline"),
                       seeds=(0, 1, 2), n_replicas=(2,), sb_sizes=(None, 48))
    rng = np.random.default_rng(7)
    queries = [WARM_GRID[rng.integers(len(WARM_GRID))]
               if rng.random() < 0.5 else novel[rng.integers(len(novel))]
               for _ in range(100)]
    with server(batch_cells=8) as srv:
        srv.warm(WARM_GRID)
        srv.reset_stats()
        tc0 = E.trace_count()
        singles = [srv.query(q) for q in queries[:50]]
        batched = srv.query_batch(queries[50:])
        st_ = srv.stats()
        assert E.trace_count() == tc0
        assert st_["compiled_programs"] == 0
        assert st_["lane_misses"] > 0
        assert st_["lane_hits"] > 0
    uniq = list(dict.fromkeys(queries))
    want = dict(zip(uniq, jax_oracle(uniq)))
    assert [fields(r) for r in singles + batched] == \
        [want[q] for q in queries]


def test_warm_without_populate_builds_and_launches_every_program():
    """``warm(populate=False)`` builds the grid's programs and launches
    each once against the capacity bank; the first flush then builds
    nothing."""
    fresh_caches()
    with server(batch_cells=8) as srv:
        srv.warm(WARM_GRID, populate=False)
        built = srv.stats()["compiled_programs"]
        assert built == 2                                 # SB 72 and 48
        tc0 = E.trace_count()
        got = srv.query_batch(WARM_GRID)
        assert E.trace_count() == tc0
    assert [fields(r) for r in got] == jax_oracle(WARM_GRID)


# ---------------------------------------------------------------------------
# Bank-key stability pins
# ---------------------------------------------------------------------------


def test_bank_key_stability_pins():
    """mega_grid keeps the JAX package's 27 + 1298 rows and 2 700 lanes,
    and the coupled mega-grids keep their lane counts."""
    mega = mega_grid()
    trace_map, wv_map = S.bank_row_maps(mega)
    assert (len(trace_map), len(wv_map)) == (27, 1298)
    jt, jw = JS.bank_row_maps(jax_specs(mega))
    assert list(trace_map) == list(jt) and len(jw) == len(wv_map)
    assert lane_count(mega) == 2700
    assert lane_count(contention_mega_grid()) == 990
    assert lane_count(directory_mega_grid()) == 2160


def test_bank_bytes_stable_across_serving():
    """Serving a grid builds the same columns (same bytes, same row
    order) as a from-scratch bank, and as the JAX package's."""
    sub = mega_grid(seeds=(0,), replicas=(1, 3), bandwidths=(160.0, 40.0),
                    cn_counts=(16,), sb_sizes=(72, 48))
    scratch = JS._make_trace_bank(tuple(jax_specs(sub)), N,
                                  JS.PAPER_CLUSTER)
    with server(batch_cells=8) as srv:
        srv.warm(sub, populate=False)
        srv.query_batch(sub[: len(sub) // 2])
        bank = srv._bank
        assert len(bank.trace_row) == len(scratch.trace_row)
        assert len(bank.wv_row) == len(scratch.wv_row)
        assert bank.arrivals.tobytes() == scratch.arrivals.tobytes()
        assert bank.w.tobytes() == scratch.w.tobytes()
        assert bank.v.tobytes() == scratch.v.tobytes()
        assert bank.pr_nc.tobytes() == scratch.pr_nc.tobytes()


# ---------------------------------------------------------------------------
# LRU bounds: lane eviction + bank compaction
# ---------------------------------------------------------------------------


def test_lru_lane_eviction_reask_equal():
    grid = sweep_grid(workloads=WORKLOAD_POOL, configs=("proactive", "wb"),
                      n_replicas=(None, 2))
    assert lane_count(grid) > 6
    with server(batch_cells=8, max_lanes=6) as srv:
        first = srv.query_batch(grid)
        st_ = srv.stats()
        assert st_["lanes_cached"] == 6
        assert st_["lane_evictions"] == lane_count(grid) - 6
        re0 = srv.query(grid[0])
        assert re0.meta["cache"] == "miss"
        assert fields(re0) == fields(first[0])
        re_last = srv.query(grid[-1])
        assert re_last.meta["cache"] == "hit"
        assert fields(re_last) == fields(first[-1])
        for _ in range(4):
            srv.query_batch([grid[-1], grid[0]])
        assert srv.query(grid[0]).meta["cache"] == "hit"
    assert [fields(r) for r in first] == jax_oracle(grid)


def test_bank_compaction_bounds_rows_and_stays_equal():
    grid = sweep_grid(workloads=WORKLOAD_POOL,
                      configs=("proactive", "wb", "baseline"),
                      n_replicas=(None, 2, 3))
    with server(batch_cells=8, row_pad=4, max_lanes=4,
                max_bank_rows=12) as srv:
        served = [srv.query(s) for s in grid]
        st_ = srv.stats()
        assert st_["bank_compactions"] >= 1
        assert st_["lane_evictions"] > 0
        assert st_["bank_rows"] < lane_count(grid) * 2
        again = [srv.query(s) for s in grid]
    oracle = jax_oracle(grid)
    assert [fields(r) for r in served] == oracle
    assert [fields(r) for r in again] == oracle
    with pytest.raises(ValueError):
        server(max_lanes=0)
    with pytest.raises(ValueError):
        server(max_bank_rows=1)
    with pytest.raises(ValueError):
        server(n_shards=0)


# ---------------------------------------------------------------------------
# Query translation: grid deltas and downtime requests
# ---------------------------------------------------------------------------


def test_grid_delta_translation():
    axes = dict(workloads=("ycsb", "canneal"), configs=("wb", "proactive"),
                sb_sizes=(None, 48), n_replicas=(None, 3, 4))
    delta = grid_delta(WARM_GRID, **axes)
    full = sweep_grid(**axes)
    assert delta == [s for s in full if s not in set(WARM_GRID)]
    assert all(s.n_replicas == 4 for s in delta)
    assert grid_delta(full, **axes) == []
    with server(batch_cells=8) as srv:
        srv.warm(WARM_GRID)
        srv.reset_stats()
        served = srv.query_grid(**axes)
        st_ = srv.stats()
    assert st_["lane_hits"] >= len(full) - len(delta)
    assert [fields(r) for r in served] == jax_oracle(full)


def test_downtime_queries_match_recovery_model_and_jax():
    est = downtime_query("ycsb", 50.0, n_cns=8)
    sweep = recovery_sweep(workloads=("ycsb",), fail_times_ms=(50.0,),
                           cn_counts=(8,), device=CPU)
    assert np.isclose(est.total_ns, float(sweep.total_ns[0, 0, 0]),
                      rtol=1e-9)
    jest = jax_downtime_query("ycsb", 50.0, n_cns=8)
    assert np.isclose(est.total_ns, jest.total_ns, rtol=1e-9)
    loaded = downtime_query("ycsb", 50.0, n_cns=8, directory_load=0.5)
    assert loaded.directory_ns > est.directory_ns
    with server() as srv:
        got = srv.query_downtime("ycsb", 50.0, n_cns=8)
        assert got == est
        assert srv.stats()["downtime_queries"] == 1


# ---------------------------------------------------------------------------
# Async batching + threaded stress vs clear_sim_caches()
# ---------------------------------------------------------------------------


def test_submit_futures_batch_and_resolve():
    with server(batch_cells=64, batch_window_ms=100.0) as srv:
        srv.warm(WARM_GRID)
        srv.reset_stats()
        futs = [srv.submit(s) for s in WARM_GRID + WARM_GRID]
        got = [f.result(timeout=120) for f in futs]
        st_ = srv.stats()
        assert st_["queries"] == 2 * len(WARM_GRID)
        assert 1 <= st_["batches"] <= 8
    assert [fields(r) for r in got] == 2 * jax_oracle(WARM_GRID)
    with pytest.raises(RuntimeError):
        srv.submit(WARM_GRID[0])


def test_concurrent_queries_race_cache_clears_equal():
    """Threads hammer the daemon (sync + async paths) while another
    thread repeatedly drops every host cache and tile program: no
    deadlock, no bank double-build, every answer still == the JAX
    package's oracle."""
    novel = [ScenarioSpec(w, "proactive", seed=2, n_replicas=2)
             for w in WORKLOAD_POOL]
    want = dict(zip(WARM_GRID + novel, jax_oracle(WARM_GRID + novel)))
    with server(batch_cells=8, batch_window_ms=1.0) as srv:
        srv.warm(WARM_GRID)
        stop = threading.Event()
        errors = []

        def clearer():
            # the plain scan on the CPU gives up the GIL at every torch
            # op; a clearer that never sleeps would hold each hand-back
            # for a whole switch interval, so it pauses a millisecond
            # between clears (still hundreds of clears per flush)
            while not stop.is_set():
                S.clear_sim_caches()
                time.sleep(0.001)

        def worker(seed):
            rng = np.random.default_rng(seed)
            pool = WARM_GRID + novel
            try:
                for _ in range(6):
                    picks = [pool[rng.integers(len(pool))]
                             for _ in range(4)]
                    if rng.random() < 0.5:
                        got = srv.query_batch(picks)
                    else:
                        got = [f.result(timeout=120)
                               for f in map(srv.submit, picks)]
                    for s, r in zip(picks, got):
                        if fields(r) != want[s]:
                            errors.append((s, r))
            except Exception as e:                  # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(6)]
        clr = threading.Thread(target=clearer)
        clr.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        stop.set()
        clr.join(timeout=60)
        alive = [t for t in threads + [clr] if t.is_alive()]
        assert not alive, f"deadlocked threads: {alive}"
        assert not errors, errors[:3]
        assert srv.stats()["bank_builds"] == 1


def test_submit_timeout_fails_future_with_diagnostic():
    with server(batch_cells=8) as srv:
        srv._lock.acquire()
        try:
            fut = srv.submit(WARM_GRID[0], timeout_ms=50)
            with pytest.raises(TimeoutError, match="timed out"):
                fut.result(timeout=30)
        finally:
            srv._lock.release()
        assert srv.stats()["submit_timeouts"] >= 1
        ok = srv.submit(WARM_GRID[0], timeout_ms=60_000).result(timeout=120)
        assert [fields(ok)] == jax_oracle([WARM_GRID[0]])
    with pytest.raises(ValueError):
        server(submit_timeout_ms=0)


def test_watchdog_fails_wedged_flush():
    with server(batch_cells=8, watchdog_ms=100) as srv:
        srv._lock.acquire()
        try:
            futs = [srv.submit(s) for s in WARM_GRID[:2]]
            for f in futs:
                with pytest.raises(TimeoutError, match="watchdog"):
                    f.result(timeout=30)
        finally:
            srv._lock.release()
        assert srv.stats()["watchdog_flush_failures"] >= 1


def test_watchdog_fails_entries_queued_behind_a_wedged_flush():
    """A submit that arrives after the daemon wedged in a flush is not in
    that flush's batch: it fails with the watchdog's error all the same
    once it has waited ``watchdog_ms``, not at the caller's timeout."""
    with server(batch_cells=8, watchdog_ms=100) as srv:
        srv._lock.acquire()
        try:
            first = srv.submit(WARM_GRID[0])
            with pytest.raises(TimeoutError, match="watchdog"):
                first.result(timeout=30)
            late = srv.submit(WARM_GRID[1])
            with pytest.raises(TimeoutError, match="watchdog"):
                late.result(timeout=30)
        finally:
            srv._lock.release()
        assert srv.stats()["watchdog_flush_failures"] == 1


def test_close_drains_or_fails_pending_deterministically():
    srv = server(batch_cells=8)
    srv._lock.acquire()
    fut = srv.submit(WARM_GRID[0])
    closer = threading.Thread(target=srv.close)
    closer.start()
    srv._lock.release()
    closer.join(timeout=120)
    assert not closer.is_alive(), "close() hung on a pending queue"
    try:
        res = fut.result(timeout=30)
        assert [fields(res)] == jax_oracle([WARM_GRID[0]])
    except RuntimeError:
        pass
    with pytest.raises(RuntimeError):
        srv.submit(WARM_GRID[0])


def test_stats_snapshot_is_deep_copied_and_consistent():
    with server(batch_cells=8) as srv:
        srv.warm(WARM_GRID)
        srv.reset_stats()
        snaps = []
        errors = []
        stop = threading.Event()

        def reader():
            while not stop.is_set():
                st_ = srv.stats()
                if st_["lane_hits"] + st_["lane_misses"] != st_["queries"]:
                    errors.append(st_)
                snaps.append(st_)

        rd = threading.Thread(target=reader)
        rd.start()
        rng = np.random.default_rng(7)
        for _ in range(40):
            picks = [WARM_GRID[rng.integers(len(WARM_GRID))]
                     for _ in range(3)]
            srv.query_batch(picks)
        stop.set()
        rd.join(timeout=60)
        assert not rd.is_alive(), "stats() reader deadlocked"
        assert not errors, f"torn snapshot(s): {errors[:2]}"
        assert snaps and snaps[-1]["queries"] <= 120
        frozen = srv.stats()
        before = frozen["queries"]
        srv.query_batch([WARM_GRID[0]])
        assert frozen["queries"] == before
        frozen["lane_hits"] = -1
        frozen["bank_capacity"] = None
        live = srv.stats()
        assert live["queries"] == before + 1
        assert live["lane_hits"] >= 0 and live["bank_capacity"] is not None
        # the resident bank is the server's own: one card, one copy
        assert live["bank_dev_bytes"] == live["bank_dev_bytes_per_shard"] > 0
