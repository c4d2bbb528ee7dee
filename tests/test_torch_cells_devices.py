"""The evaluation's ``cells`` shards over several placements, against the
JAX package's ``cells`` mesh.

``devices=("cpu",) * D`` gives the port's streaming engine and scenario
server one placement per shard -- the JAX package's layout, in one
process -- and the JAX package runs at ``n_shards = D`` on the 8 host
devices of ``tests/conftest.py``. Every ``SimResult`` field but ``meta``
must be ``==``, and so must the four byte keys of ``bank_stats()``
(``h2d_bytes``, ``bank_dev_bytes``, ``bank_dev_bytes_per_shard``,
``bank_fabric_bytes``) and each cell's ``meta["bank_fabric_bytes"]``.
A shard loss is recovered on every placement from the survivor's
replica block (the lost placement poisoned with NaN before it is freed,
so a read of it would show), the degraded mode finishes on the surviving
placements, and two planted faults -- a lane gathered from its
neighbour's placement, a rebuild read from the lost placement -- fail
their checks. Every draw is seeded.
"""

import contextlib
import dataclasses
import io

import jax
import numpy as np
import pytest
import torch

from repro.core import chaos as JC
from repro.core import engine as JE
from repro.core import simulator as JS
from repro.core.serving import ScenarioServer as JaxServer
from repro_torch.core import chaos
from repro_torch.core import engine as E
from repro_torch.core import simulator as S
from repro_torch.core.chaos import ChaosConfig, IntegrityError
from repro_torch.core.scenarios import run_sweep, sweep_grid
from repro_torch.core.serving import ScenarioServer
from repro_torch.distributed.context import cells_devices
from repro_torch.launch import serve_scenarios

N = 256
CPU = "cpu"
#: the blocked scan's block length: it changes no result, and a short one
#: keeps the JAX side's compiles short
CHUNK = 8
RUN = dict(n_stores=N, tile_cells=16, chunk_size=CHUNK)
WORKLOAD_POOL = ("ycsb", "canneal", "barnes", "raytrace", "ocean_ncp")
BYTE_KEYS = ("h2d_bytes", "bank_dev_bytes", "bank_dev_bytes_per_shard",
             "bank_fabric_bytes")
META_KEYS = ("engine", "chunk", "auto_chunk", "tile_cells", "n_shards",
             "data_plane", "bank_partition", "bank_rows", "h2d_bytes",
             "bank_fabric_bytes")
LAYOUTS = {"sub-k1": dict(k_replicas=1), "sub-k2": dict(k_replicas=2),
           "replicated": dict(bank_partition="replicated"),
           "stacked": dict(data_plane="stacked")}


def fields(r):
    return tuple(getattr(r, f.name) for f in dataclasses.fields(r)
                 if f.name != "meta")


def jax_specs(specs):
    return [JS.ScenarioSpec(**dataclasses.asdict(s)) for s in specs]


def cpus(d):
    return (CPU,) * d


def ragged_grid(seed: int, n: int = 18, sb=None):
    """A ragged grid at one store-buffer depth (one tile signature a
    layout keeps the JAX side's compiles few), contention and directory
    knobs included (their rows interleave ownership), drawn from a numpy
    seed."""
    rng = np.random.default_rng(seed)

    def pick(xs):
        return xs[int(rng.integers(len(xs)))]

    return [S.ScenarioSpec(
        pick(WORKLOAD_POOL), pick(S.CONFIGS), seed=int(rng.integers(2)),
        n_replicas=pick((None, 2, 3)), link_bw_gbps=pick((None, 40.0)),
        sb_size=sb, read_share=pick((None, 0.3)),
        directory_load=pick((None, 0.5))) for _ in range(n)]


GRID = ragged_grid(7)


@pytest.fixture(scope="module")
def oracle():
    return [fields(r) for r in JS.simulate_batch(
        jax_specs(GRID), n_stores=N, chunk_size=CHUNK)]


def fresh_banks():
    """Drop both packages' memoized banks (so each run counts its bank's
    upload), but not the JAX package's compiled tile programs, which
    later cases of the same layout reuse."""
    S.clear_sim_caches()
    JS._BANK_CACHE.clear()


def needs(d):
    if jax.device_count() < d:
        pytest.skip(f"needs {d} host devices for the JAX side")


@pytest.fixture
def launches(monkeypatch):
    """Lane counts of every bank-scan call the engine's tile programs
    make (the CPU route counts no kernel launch)."""
    calls = []

    def counted(a, w, v, p, tr, wv, **kw):
        calls.append(int(tr.shape[0]))
        return bank_scan(a, w, v, p, tr, wv, **kw)

    bank_scan = E.bank_scan
    monkeypatch.setattr(E, "bank_scan", counted)
    return calls


# ---------------------------------------------------------------------------
# The streaming engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("d", [2, 4])
def test_run_grid_over_placements_equals_jax(d, layout, oracle, launches):
    """Results, the four byte keys and every cell's fabric bytes ``==``
    the JAX package's at ``n_shards = d``; one launch per placement a
    tile, each over ``b_pad / d`` lanes."""
    needs(d)
    kw = LAYOUTS[layout]
    fresh_banks()
    got = E.run_grid(GRID, **RUN, n_shards=d,
                     devices=cpus(d), **kw)
    stats = E.bank_stats()
    ref = JE.run_grid(jax_specs(GRID), **RUN,
                      n_shards=d, **kw)
    jstats = JE.bank_stats()
    assert [fields(r) for r in got] == [fields(r) for r in ref] == oracle
    for key in BYTE_KEYS + ("scan_lanes", "trace_rows", "wv_rows",
                            "stacked_h2d_bytes", "k_replicas"):
        assert stats[key] == jstats[key], (layout, key)
    for p, j in zip(got, ref):
        assert {k: p.meta[k] for k in META_KEYS} \
            == {k: j.meta[k] for k in META_KEYS}, (p.meta, j.meta)
    assert stats["placements"] == d
    assert len(launches) == d * stats["tiles"]
    assert set(launches) == {r.meta["tile_cells"] // d for r in got}
    if layout != "stacked":
        assert stats["bank_fabric_bytes"] > 0
        assert stats["bank_dev_bytes_per_shard"] < stats["bank_dev_bytes"]


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("d", [2, 4])
def test_each_placement_holds_only_its_shard(d, k):
    """Placement ``s`` holds shard ``s``'s ``(1, k * local, n)`` slice of
    each stack and a copy of the arrivals, in memory of its own; the
    bytes are the host slices' and the arrivals' copies are fabric."""
    S.clear_sim_caches()
    bank = S.get_trace_bank(GRID, N)
    host = bank.sub_bank_host(d, k)
    placements = cells_devices(d, cpus(d))
    h2d, fabric, parts = bank.placed_sub(d, placements, k_replicas=k)
    assert h2d == sum(int(x.nbytes) for x in host)
    assert fabric == bank.arrivals.nbytes * (d - 1)
    local = S.sub_bank_rows(bank.wv_rows, d)
    ptrs = set()
    for s, part in enumerate(parts):
        assert torch.equal(part[0], torch.from_numpy(bank.arrivals))
        for t, h in zip(part[1:], host[1:]):
            assert tuple(t.shape) == (1, k * local, N)
            assert np.array_equal(t.numpy(), h[s:s + 1])
        ptrs.update(t.data_ptr() for t in part)
    assert len(ptrs) == 4 * d
    assert bank.arrivals.ctypes.data not in ptrs
    assert bank.placed_sub(d, placements, k_replicas=k)[:2] == (0, 0)
    assert S.sub_key(d, k, placements) != S.sub_key(d, k, placements[0])


# ---------------------------------------------------------------------------
# Shard loss, degraded mode, planted faults
# ---------------------------------------------------------------------------


@pytest.fixture
def poison_freed(monkeypatch):
    """Fill a placement with NaN (and its bool plane with True) just
    before the engine frees it, so any later read of it would show."""
    freed = []
    free = S.TraceBank.free_placement

    def poisoning(self, key, index):
        part = self._device[key][1][index]
        for t in part:
            t.fill_(True if t.dtype == torch.bool else float("nan"))
        freed.append(index)
        free(self, key, index)

    monkeypatch.setattr(S.TraceBank, "free_placement", poisoning)
    return freed


@pytest.mark.parametrize("lost", [0, 1, 2, 3])
def test_shard_loss_on_every_placement_equals_jax(lost, oracle,
                                                  poison_freed):
    """A shard lost mid-grid at d = 4, k 2: the lost placement freed
    (poisoned first), its rows rebuilt from the survivor's replica block,
    only it placed again -- zero new tile programs, results ``==`` the
    JAX package's chaos run."""
    needs(4)
    cfg = dict(lose_shard=lost, lose_at_dispatch=2)
    S.clear_sim_caches()
    E.run_grid(GRID, **RUN, n_shards=4, k_replicas=2,
               devices=cpus(4))
    tc0 = E.trace_count()
    with chaos.inject(ChaosConfig(**cfg)) as cs:
        got = E.run_grid(GRID, **RUN, n_shards=4,
                         k_replicas=2, devices=cpus(4))
    with JC.inject(JC.ChaosConfig(**cfg)):
        ref = JE.run_grid(jax_specs(GRID), **RUN,
                          n_shards=4, k_replicas=2)
    assert [fields(r) for r in got] == [fields(r) for r in ref] == oracle
    assert E.trace_count() == tc0
    assert poison_freed == [lost]
    rec = cs.report()["recoveries"]
    assert len(rec) == 1 and rec[0]["shard"] == lost \
        and rec[0]["source"] == "replica"
    stats = E.bank_stats()
    assert stats["bank_dev_bytes"] == 4 * stats["bank_dev_bytes_per_shard"]


def test_shard_loss_without_replicas_respares_from_the_host(oracle,
                                                             poison_freed):
    """At k 1 the engine's bank keeps no journal: the lost placement is
    freed and placed again from the host columns, results ``==``."""
    S.clear_sim_caches()
    with chaos.inject(ChaosConfig(lose_shard=1, lose_at_dispatch=2)) as cs:
        got = E.run_grid(GRID, **RUN, n_shards=4,
                         k_replicas=1, devices=cpus(4))
    assert [fields(r) for r in got] == oracle and poison_freed == [1]
    assert cs.report()["recoveries"][0]["source"] == "host"


@pytest.mark.parametrize("d", [2, 4])
def test_degraded_over_placements_equals_jax(d, oracle, poison_freed):
    """No spare: the unfinished cells finish on the d - 1 surviving
    placements with the bank replicated (the lost one freed, poisoned
    first), ``==`` the JAX package's results (its degraded run takes its
    first d - 1 devices; ``tests/test_chaos.py`` holds that run ``==``
    its oracle)."""
    S.clear_sim_caches()
    with chaos.inject(ChaosConfig(lose_shard=d - 1, lose_at_dispatch=1,
                                  recovery="degraded")) as cs:
        got = E.run_grid(GRID, **RUN, n_shards=d,
                         devices=cpus(d))
    assert [fields(r) for r in got] == oracle
    assert E.bank_stats()["degraded"] and poison_freed == [d - 1]
    assert all(r.meta["n_shards"] == d - 1 for r in got)
    assert cs.report()["recoveries"][0]["source"] == "degraded-mesh"


def test_planted_neighbour_gather_fails(oracle, monkeypatch):
    """Planted fault: every slot block gathers from its neighbour's
    placement. The results must leave the oracle."""
    launch = E.launch_tile

    def neighbour(sig, placed, placements, bank_parts=None, costs=None):
        if bank_parts is not None:
            bank_parts = tuple(bank_parts[1:]) + tuple(bank_parts[:1])
        return launch(sig, placed, placements, bank_parts, costs)

    S.clear_sim_caches()
    good = E.run_grid(GRID, **RUN, n_shards=4,
                      devices=cpus(4))
    assert [fields(r) for r in good] == oracle
    monkeypatch.setattr(E, "launch_tile", neighbour)
    bad = E.run_grid(GRID, **RUN, n_shards=4,
                     devices=cpus(4))
    assert [fields(r) for r in bad] != oracle


@pytest.mark.parametrize("lost", [0, 3])
def test_planted_rebuild_from_the_lost_placement_fails(lost, monkeypatch):
    """Planted fault: the rebuild reads the lost placement (poisoned)
    instead of the survivor's replica block. The digest check of the
    rebuilt rows must refuse it; the true rebuild passes."""
    S.clear_sim_caches()
    bank = S.get_trace_bank(GRID, N)
    placements = cells_devices(4, cpus(4))
    _, _, parts = bank.placed_sub(4, placements, k_replicas=2)
    for t in parts[lost]:
        t.fill_(True if t.dtype == torch.bool else float("nan"))
    kw = dict(n_shards=4, k_replicas=2,
              local_cap=S.sub_bank_rows(bank.wv_rows, 4),
              wv_rows=bank.wv_rows)
    chaos.verify_rebuild(bank, chaos.replica_rebuild(parts, lost, **kw),
                         lost, 4)
    monkeypatch.setattr(chaos, "replica_source", lambda lost, n: lost)
    with pytest.raises(IntegrityError):
        chaos.verify_rebuild(bank, chaos.replica_rebuild(parts, lost, **kw),
                             lost, 4)


# ---------------------------------------------------------------------------
# The scenario server
# ---------------------------------------------------------------------------


SERVE_WARM = sweep_grid(workloads=("ycsb", "raytrace"), configs=S.CONFIGS)
SERVE_NOVEL = sweep_grid(workloads=("barnes",),
                         configs=("baseline", "proactive"),
                         n_replicas=(2, 3))


def serve_stream(seed: int, n: int = 24):
    rng = np.random.default_rng(seed)
    return [SERVE_WARM[rng.integers(len(SERVE_WARM))] if rng.random() < 0.6
            else SERVE_NOVEL[rng.integers(len(SERVE_NOVEL))]
            for _ in range(n)]


@pytest.mark.parametrize("d", [2, 4])
def test_server_over_placements_equals_jax(d):
    """A seeded stream served over d placements: answers and ``meta``
    ``==`` the JAX server's at ``n_shards = d``, zero new programs after
    warm, the resident bytes ``==`` the JAX server's measured ones."""
    needs(d)
    stream = serve_stream(d)
    fresh_banks()
    with ScenarioServer(n_stores=N, n_shards=d, batch_cells=8,
                        chunk_size=CHUNK, devices=cpus(d)) as srv:
        srv.warm(SERVE_WARM)
        srv.reset_stats()
        tc0 = E.trace_count()
        got = [srv.query(s) for s in stream]
        st = srv.stats()
        new_programs = E.trace_count() - tc0
    with JaxServer(n_stores=N, n_shards=d, batch_cells=8,
                   chunk_size=CHUNK) as jsrv:
        jsrv.warm(jax_specs(SERVE_WARM))
        jsrv.reset_stats()
        ref = [jsrv.query(s) for s in jax_specs(stream)]
        jst = jsrv.stats()
    assert [fields(r) for r in got] == [fields(r) for r in ref]
    assert [r.meta for r in got] == [r.meta for r in ref]
    assert new_programs == 0 and st["compiled_programs"] == 0
    for key in ("h2d_bytes", "bank_dev_bytes", "bank_dev_bytes_per_shard",
                "bank_capacity", "lane_misses"):
        assert st[key] == jst[key], key
    assert st["bank_dev_bytes"] == d * st["bank_dev_bytes_per_shard"]


@pytest.fixture(scope="module")
def serve_ref():
    return [fields(r) for r in JS.simulate_batch(
        jax_specs(SERVE_NOVEL + SERVE_WARM[:6]), n_stores=N,
        chunk_size=CHUNK)]


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("d", [2, 4])
def test_server_shard_loss_over_placements(d, k, serve_ref):
    """A shard lost mid-stream on d placements: recovered from the
    survivor's replica block (k 2) or the Logging-Unit journal (k 1),
    only the lost placement placed again, zero new programs, answers
    ``==`` the JAX oracle before and after."""
    ref = serve_ref
    S.clear_sim_caches()
    with chaos.inject(ChaosConfig(lose_shard=d - 1,
                                  lose_at_dispatch=1 << 30)) as cs:
        with ScenarioServer(n_stores=N, n_shards=d, batch_cells=8,
                            chunk_size=CHUNK, k_replicas=k,
                            devices=cpus(d)) as srv:
            srv.warm(SERVE_WARM)
            srv.reset_stats()
            tc0 = E.trace_count()
            cs.arm_after(1)
            got = srv.query_batch(SERVE_NOVEL)
            again = srv.query_batch(SERVE_NOVEL + SERVE_WARM[:6])
            st = srv.stats()
    assert [fields(r) for r in got] == ref[:len(SERVE_NOVEL)]
    assert [fields(r) for r in again] == ref
    assert E.trace_count() == tc0 and st["compiled_programs"] == 0
    assert st["recoveries"] == 1 and st["bank_uploads"] == 0
    rec = cs.report()["recoveries"]
    assert rec[0]["source"] == ("replica" if k == 2 else "journal")
    assert rec[0]["shard"] == d - 1


def test_server_warm_without_populate_over_placements(serve_ref):
    """``warm(populate=False)`` builds and launches every program on
    every placement; the stream then builds none, answers ``==``."""
    S.clear_sim_caches()
    with ScenarioServer(n_stores=N, n_shards=4, batch_cells=8,
                        chunk_size=CHUNK, devices=cpus(4)) as srv:
        srv.warm(SERVE_WARM, populate=False)
        tc0 = E.trace_count()
        got = srv.query_batch(SERVE_WARM[:6])
        assert E.trace_count() == tc0
    assert [fields(r) for r in got] == serve_ref[len(SERVE_NOVEL):]


# ---------------------------------------------------------------------------
# Refusals, defaults, the sweep and the launcher
# ---------------------------------------------------------------------------


REFUSALS = {
    "cells_devices, 3 of 2": (ValueError, lambda: cells_devices(
        2, cpus(3))),
    "run_grid, 3 of 4": (ValueError, lambda: E.run_grid(
        GRID[:4], n_stores=N, n_shards=4, devices=cpus(3))),
    "server, 2 of 4": (ValueError, lambda: ScenarioServer(
        n_stores=N, n_shards=4, devices=cpus(2))),
    "simulate_grid, 2 of 1": (ValueError, lambda: E.simulate_grid(
        GRID[:4], n_stores=N, devices=cpus(2))),
    "run_grid, cuda without a card": (RuntimeError, lambda: E.run_grid(
        GRID[:4], n_stores=N, n_shards=2, devices=("cuda:0", "cuda:1"))),
    "server, cuda without a card": (RuntimeError, lambda: ScenarioServer(
        n_stores=N, n_shards=2, devices=("cuda", "cuda"))),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals(case):
    """A length not in {1, n_shards} and a CUDA placement without a card
    raise; nothing falls back."""
    if "cuda" in case and torch.cuda.is_available():
        pytest.skip("a card is present")
    err, call = REFUSALS[case]
    with pytest.raises(err):
        call()


def test_default_is_one_placement_one_launch_a_tile(oracle, launches):
    """``devices=None`` (and one device) keeps every shard on one
    placement: one launch a tile, no fabric bytes, the same results."""
    for devices in (None, (CPU,)):
        launches.clear()
        S.clear_sim_caches()
        got = E.run_grid(GRID, **RUN, n_shards=4,
                         device=CPU, devices=devices)
        stats = E.bank_stats()
        assert [fields(r) for r in got] == oracle
        assert stats["placements"] == 1 and stats["bank_fabric_bytes"] == 0
        assert len(launches) == stats["tiles"]
        assert stats["bank_dev_bytes"] == stats["bank_dev_bytes_per_shard"]


def test_devices_reach_the_stream_tier_through_run_sweep(oracle, launches):
    """``run_sweep`` forwards ``devices`` to ``run_grid`` through
    ``simulate_grid``'s tier choice; below the stream threshold the
    one-shot batch runs on one device."""
    S.clear_sim_caches()
    got = run_sweep(GRID, n_stores=N, engine="stream", tile_cells=16,
                    chunk_size=CHUNK, n_shards=2, devices=cpus(2))
    assert [fields(r) for r in got] == oracle
    assert E.bank_stats()["placements"] == 2
    assert len(launches) == 2 * E.bank_stats()["tiles"]
    launches.clear()
    small = run_sweep(GRID, n_stores=N, n_shards=2, devices=cpus(2))
    assert [fields(r) for r in small] == oracle
    assert all(r.meta["engine"] == "blocked" for r in small)
    assert len(launches) == 0


def run_launcher(cards: int) -> str:
    S.clear_sim_caches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_scenarios.main(["--stores", "300", "--queries", "30",
                              "--device", CPU, "--shards", "2",
                              "--cards", str(cards), "--check"])
    return buf.getvalue()


def test_launcher_cards_equal_one_card():
    """``--device cpu --cards 2 --shards 2 --check`` reaches its end, and
    its answers are ``==`` ``--cards 1``'s (both ``==`` the oracle, and
    every line that is not a time is the same)."""
    two, one = run_launcher(2), run_launcher(1)
    assert "placements: cpu, cpu" in two and "placements: cpu\n" in one
    for out in (one, two):
        assert "oracle check: 30 answers bit-identical" in out

    def steady(text):
        return [ln for ln in text.splitlines()
                if ln.startswith(("cache-hit", "marginal", "grid-delta",
                                  "oracle"))]
    assert steady(two) == steady(one)
    with pytest.raises(SystemExit):
        serve_scenarios.main(["--device", CPU, "--shards", "2",
                              "--cards", "3"])
