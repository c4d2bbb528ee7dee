"""The port's evaluation path against the JAX package, end to end.

``run_sweep`` / ``simulate_batch`` / ``run_grid`` of the port run on the
CPU (``device="cpu"``: the plain torch scan) and must give every
``SimResult`` field ``==`` the JAX package's on the same grid, with the
same geomeans, the same engine metadata, and the same tile plan.
"""

import dataclasses

import pytest

from repro.core import engine as JE
from repro.core import scenarios as JSc
from repro.core import simulator as JS
from repro_torch.core import engine as TE
from repro_torch.core import scenarios as TSc
from repro_torch.core import simulator as TS
from repro_torch.core import telemetry as TT

N_FIG10 = 2000
N = 1003                                  # ragged against every chunk

MIXED = dict(workloads=("ycsb", "barnes"),
             configs=("wb", "baseline", "proactive"), sb_sizes=(72, 7, 30),
             conflict_rate=(None, 0.2), directory_load=(None, 0.4),
             n_cns=(16, 8))
STREAM = dict(workloads=("ycsb", "canneal", "raytrace"), sb_sizes=(72, 24),
              n_cns=(16, 8))
META_KEYS = ("engine", "chunk", "auto_chunk", "data_plane", "bank_partition",
             "bank_rows", "scan_lanes", "h2d_bytes", "tile_cells",
             "n_shards")


def fields(r):
    return tuple(getattr(r, f.name) for f in dataclasses.fields(r)
                 if f.name != "meta")


def assert_same(port, ref):
    assert len(port) == len(ref)
    for i, (p, j) in enumerate(zip(port, ref)):
        assert fields(p) == fields(j), i
        assert {k: p.meta.get(k) for k in META_KEYS} \
            == {k: j.meta.get(k) for k in META_KEYS}, i


@pytest.fixture(scope="module")
def fig10():
    port = TSc.run_sweep(TSc.fig10_grid(), n_stores=N_FIG10, device="cpu")
    ref = JSc.run_sweep(JSc.fig10_grid(), n_stores=N_FIG10)
    return port, ref


def test_fig10_fields_and_meta(fig10):
    assert_same(*fig10)
    assert fig10[0][0].meta["engine"] == "blocked"


def test_fig10_geomeans(fig10):
    port, ref = fig10
    gm = TS.geomean_slowdowns(TS.slowdowns_from_results(port))
    assert gm == JS.geomean_slowdowns(JS.slowdowns_from_results(ref))
    table = TS.slowdown_table(n_stores=N_FIG10, device="cpu")
    assert table == JS.slowdown_table(n_stores=N_FIG10)
    assert TS.geomean_slowdowns(table) == {c: gm[c] for c in TS.CONFIGS}


def test_mixed_sb_contention_directory_batch():
    port = TS.simulate_batch(TSc.sweep_grid(**MIXED), n_stores=N,
                             device="cpu")
    ref = JS.simulate_batch(JSc.sweep_grid(**MIXED), n_stores=N)
    assert_same(port, ref)
    assert port[0].meta["scan_lanes"] < len(port)   # the CN axis dedups


@pytest.fixture(scope="module")
def stream():
    before = TE.trace_count()
    port = TSc.run_sweep(TSc.sweep_grid(**STREAM), n_stores=N,
                         engine="stream", tile_cells=16, device="cpu")
    built = TE.trace_count() - before
    ref = JSc.run_sweep(JSc.sweep_grid(**STREAM), n_stores=N,
                        engine="stream", tile_cells=16, n_shards=1)
    return port, ref, built, TE.bank_stats()


def test_stream_tier_fields_and_meta(stream):
    port, ref, _, _ = stream
    assert_same(port, ref)
    assert {r.meta["engine"] for r in port} == {"streamed"}


def test_stream_tier_equals_one_shot_batch(stream):
    port = stream[0]
    batch = TS.simulate_batch(TSc.sweep_grid(**STREAM), n_stores=N,
                              device="cpu")
    assert [fields(r) for r in port] == [fields(r) for r in batch]


def test_stream_bank_stats_and_programs(stream):
    port, _, built, stats = stream
    assert stats["cells"] == len(port) == 60
    assert stats["scan_lanes"] == 30          # the CN axis collapses
    assert stats["tiles"] == 2                # one per SB group
    assert built <= 2                         # one program per signature
    bank = TS.get_trace_bank(TSc.sweep_grid(**STREAM), N)
    assert stats["bank_dev_bytes"] == bank.nbytes
    assert stats["h2d_bytes"] == bank.nbytes + 2 * 16 * 8   # bank + idx
    before = TE.trace_count()
    TE.run_grid(TSc.sweep_grid(**STREAM), n_stores=N, tile_cells=16,
                device="cpu")
    assert TE.trace_count() == before         # programs are reused


@pytest.mark.parametrize("kw", [
    dict(), dict(tile_cells=16), dict(tile_cells=16, chunk_size=5),
    dict(tile_cells=40, small_pad=False)])
def test_plan_tiles_identical(kw):
    specs_t = TSc.sweep_grid(**MIXED)
    specs_j = JSc.sweep_grid(**MIXED)
    t = TE.plan_tiles(specs_t, n_stores=N, **kw)
    j = JE.plan_tiles(specs_j, n_stores=N, **kw)
    assert [x.indices for x in t] == [y.indices for y in j]
    assert [dataclasses.astuple(x.sig) for x in t] \
        == [dataclasses.astuple(y.sig) for y in j]


def test_plan_tiles_owner_slots_identical():
    specs_t = TSc.sweep_grid(**STREAM)
    specs_j = JSc.sweep_grid(**STREAM)
    owners = [i % 4 for i in range(len(specs_t))]
    t = TE.plan_tiles(specs_t, n_stores=N, tile_cells=16, n_shards=4,
                      small_pad=False, owners=owners)
    j = JE.plan_tiles(specs_j, n_stores=N, tile_cells=16, n_shards=4,
                      small_pad=False, owners=owners)
    assert [(x.indices, x.slots) for x in t] \
        == [(y.indices, y.slots) for y in j]


def test_tile_geometry_at_paper_scale():
    assert TE._default_tile_cells(50_000) == JE._default_tile_cells(50_000) \
        == 157
    assert TE.STREAM_THRESHOLD == JE.STREAM_THRESHOLD
    assert TE.MAX_IN_FLIGHT_TILES == JE.MAX_IN_FLIGHT_TILES
    for n, sb, cells in ((50_000, 72, 48), (50_000, 48, 160),
                         (2000, 7, None), (1003, 72, 300)):
        assert TS.auto_chunk(n, sb, cells) == JS.auto_chunk(n, sb, cells)


def test_replicated_partition_and_telemetry():
    specs = TSc.sweep_grid(**STREAM)
    with TT.recording() as rec:
        rep = TE.simulate_grid(specs, n_stores=N, engine="stream",
                               tile_cells=16, bank_partition="replicated",
                               device="cpu")
        stats = TE.bank_stats()
    sub = TE.simulate_grid(specs, n_stores=N, engine="stream",
                           tile_cells=16, device="cpu")
    assert [fields(r) for r in rep] == [fields(r) for r in sub]
    summ = rec.summary()
    for span in ("bank/build", "bank/place", "tile/prep", "tile/h2d",
                 "tile/dispatch", "tile/drain"):
        assert summ["spans"][span]["count"] >= 1, span
    assert summ["counters"]["proto/cells"] == len(specs)
    assert stats["bank_partition"] == "replicated"
    assert rep[0].meta["telemetry"] is stats["telemetry"]


def test_auto_tier_selection():
    small = TE.simulate_grid(TSc.sweep_grid(workloads=("ycsb",)),
                             n_stores=200, device="cpu")
    assert small[0].meta["engine"] == "blocked"
    assert TE.STREAM_THRESHOLD == 2048


@pytest.mark.parametrize("call", [
    lambda: TE.run_grid(TSc.fig10_grid(), n_stores=100, n_shards=2,
                        device="cpu"),
    lambda: TE.run_grid(TSc.fig10_grid(), n_stores=100, k_replicas=2,
                        device="cpu"),
    lambda: TE.run_grid(TSc.fig10_grid(), n_stores=100,
                        worker_timeout_s=5.0, device="cpu"),
])
def test_later_slices_raise_not_implemented(call):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        call()
