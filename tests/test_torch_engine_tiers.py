"""The port's serial oracle, per-step engine and stacked plane against the
JAX package.

``simulate`` / ``simulate_spec``, ``simulate_batch(chunk_size=0)``,
``simulate_batch(data_plane="stacked")``, ``run_grid(data_plane=
"stacked")``, ``simulate_grid(engine="serial"|"perstep")`` and
``slowdown_table(batched=False)`` run on the CPU (``device="cpu"``: the
plain torch scans) and must give every ``SimResult`` field ``==`` the
JAX package's on the same specs, with the same engine metadata. The
twins of ``tests/test_batch_sim.py``'s engine-equivalence tests hold
every engine and plane of the port ``==`` its own serial oracle.
"""

import dataclasses

import pytest
from hypothesis import given, settings, strategies as st

from repro.core import engine as JE
from repro.core import simulator as JS
from repro_torch.core import engine as TE
from repro_torch.core import scenarios as TSc
from repro_torch.core import simulator as TS

N = 700                                   # ragged against sb 72
CPU = "cpu"
META_KEYS = ("engine", "chunk", "auto_chunk", "data_plane", "bank_partition",
             "bank_rows", "scan_lanes", "h2d_bytes", "tile_cells",
             "n_shards", "bank_fabric_bytes")
GRID = dict(workloads=("ycsb", "barnes"), configs=TS.CONFIGS,
            sb_sizes=(72, 7), conflict_rate=(None, 0.2),
            directory_load=(None, 0.4))
WORKLOAD_POOL = ("ycsb", "canneal", "barnes", "raytrace", "ocean_ncp")


def fields(r):
    return tuple(getattr(r, f.name) for f in dataclasses.fields(r)
                 if f.name != "meta")


def jax_specs(specs):
    return [JS.ScenarioSpec(**dataclasses.asdict(s)) for s in specs]


def assert_same(port, ref):
    assert len(port) == len(ref)
    for i, (p, j) in enumerate(zip(port, ref)):
        assert fields(p) == fields(j), i
        assert {k: p.meta.get(k) for k in META_KEYS} \
            == {k: j.meta.get(k) for k in META_KEYS}, (i, p.meta, j.meta)


@pytest.fixture(scope="module")
def grid():
    return TSc.sweep_grid(**GRID)


@pytest.fixture(scope="module")
def jax_batch(grid):
    return JS.simulate_batch(jax_specs(grid), n_stores=N)


SERIAL_CELLS = [
    dict(workload="ycsb", config="wb"),
    dict(workload="canneal", config="wt", seed=2),
    dict(workload="barnes", config="baseline", link_bw_gbps=20.0),
    dict(workload="raytrace", config="parallel", n_replicas=4),
    dict(workload="ocean_ncp", config="proactive", sb_size=16),
    dict(workload="ycsb", config="proactive", coalescing=False, n_cns=8),
    dict(workload="barnes", config="proactive", conflict_rate=0.2,
         read_share=0.3, consistency_schedule="eager"),
    dict(workload="canneal", config="baseline", directory_load=0.4),
]


@pytest.mark.parametrize("kw", SERIAL_CELLS,
                         ids=[f"{k['workload']}-{k['config']}"
                              for k in SERIAL_CELLS])
def test_simulate_equals_jax(kw):
    kw = dict(kw)
    workload, config = kw.pop("workload"), kw.pop("config")
    port = TS.simulate(workload, config, n_stores=N, device=CPU, **kw)
    ref = JS.simulate(workload, config, n_stores=N, **kw)
    assert fields(port) == fields(ref)
    assert port.meta == ref.meta == {"engine": "serial",
                                     "data_plane": "stacked",
                                     "bank_partition": None}


def test_simulate_spec_maps_every_knob():
    kw = dict(seed=1, n_replicas=2, link_bw_gbps=40.0, n_cns=8, sb_size=24,
              coalescing=False, read_share=0.3, conflict_rate=0.05,
              consistency_schedule="epoch", directory_load=0.5)
    port = TS.simulate_spec(TS.ScenarioSpec("ocean_cp", "proactive", **kw),
                            n_stores=N, device=CPU)
    ref = JS.simulate_spec(JS.ScenarioSpec("ocean_cp", "proactive", **kw),
                           n_stores=N)
    assert fields(port) == fields(ref)


def test_perstep_equals_jax(grid, jax_batch):
    port = TS.simulate_batch(grid, n_stores=N, chunk_size=0, device=CPU)
    ref = JS.simulate_batch(jax_specs(grid), n_stores=N, chunk_size=0)
    assert_same(port, ref)
    assert [fields(r) for r in port] == [fields(r) for r in jax_batch]
    assert port[0].meta["engine"] == "perstep"


@pytest.mark.parametrize("chunk", [None, 5])
def test_stacked_plane_equals_jax(grid, jax_batch, chunk):
    port = TS.simulate_batch(grid, n_stores=N, chunk_size=chunk,
                             data_plane="stacked", device=CPU)
    ref = JS.simulate_batch(jax_specs(grid), n_stores=N, chunk_size=chunk,
                            data_plane="stacked")
    assert_same(port, ref)
    assert [fields(r) for r in port] == [fields(r) for r in jax_batch]
    assert port[0].meta["data_plane"] == "stacked"


def test_stream_stacked_equals_jax(grid, jax_batch):
    port = TSc.run_sweep(grid, n_stores=N, engine="stream",
                            data_plane="stacked", tile_cells=16, device=CPU)
    stats = TE.bank_stats()
    ref = JE.run_grid(jax_specs(grid), n_stores=N, data_plane="stacked",
                      tile_cells=16, n_shards=1)
    jstats = JE.bank_stats()
    assert_same(port, ref)
    assert [fields(r) for r in port] == [fields(r) for r in jax_batch]
    # the JAX package's keys, but the chaos ones the port has not ported
    for key, value in jstats.items():
        if key not in ("degraded", "chaos"):
            assert stats[key] == value, key
    assert stats["tiles"] == len(TE.plan_tiles(grid, n_stores=N,
                                               tile_cells=16))
    assert stats["data_plane"] == "stacked"
    assert stats["bank_partition"] is None
    assert stats["dedup_ratio"] == 1.0
    assert stats["h2d_bytes"] == stats["stacked_h2d_bytes"] > 0


def test_stream_stacked_spans_and_programs(grid):
    from repro_torch.core import telemetry as TT
    before = TE.trace_count()
    with TT.recording() as rec:
        TE.run_grid(grid, n_stores=N, data_plane="stacked", tile_cells=16,
                    device=CPU)
    summ = rec.summary()
    for span in ("tile/prep", "tile/h2d", "tile/dispatch", "tile/drain"):
        assert summ["spans"][span]["count"] == TE.bank_stats()["tiles"], span
    assert "bank/build" not in summ["spans"]
    sigs = {t.sig for t in TE.plan_tiles(grid, n_stores=N, tile_cells=16)}
    assert TE.trace_count() - before <= len(sigs)
    again = TE.trace_count()
    TE.run_grid(grid, n_stores=N, data_plane="stacked", tile_cells=16,
                device=CPU)
    assert TE.trace_count() == again          # programs are reused


@pytest.mark.parametrize("engine", ["serial", "perstep"])
def test_simulate_grid_tiers_equal_jax(engine):
    specs = TSc.sweep_grid(workloads=("ycsb", "raytrace"),
                           sb_sizes=(None, 16), n_cns=(16, 8))
    port = TE.simulate_grid(specs, n_stores=N, engine=engine, device=CPU)
    ref = JE.simulate_grid(jax_specs(specs), n_stores=N, engine=engine)
    assert_same(port, ref)
    assert {r.meta["engine"] for r in port} == {engine}


def test_simulate_grid_tier_validation():
    specs = TSc.sweep_grid(workloads=("ycsb",), configs=("wb",))
    with pytest.raises(ValueError, match="banked plane"):
        TE.simulate_grid(specs, n_stores=N, engine="perstep",
                         data_plane="bank", device=CPU)
    with pytest.raises(ValueError):
        TE.simulate_grid([TS.ScenarioSpec("ycsb", "nosuch")], n_stores=N,
                         engine="serial", device=CPU)
    with pytest.raises(ValueError):
        TE.simulate_grid(specs, n_stores=N, engine="serial",
                         bank_partition="sub", device=CPU)
    with pytest.raises(ValueError):
        TS.simulate_batch(specs, n_stores=N, chunk_size=0,
                          data_plane="bank", device=CPU)


def test_slowdown_table_serial_equals_jax_and_batched():
    workloads = ("ycsb", "raytrace")
    port = TS.slowdown_table(workloads=workloads, n_stores=N,
                             batched=False, device=CPU)
    assert port == JS.slowdown_table(workloads=workloads, n_stores=N,
                                     batched=False)
    assert port == TS.slowdown_table(workloads=workloads, n_stores=N,
                                     device=CPU)


@st.composite
def ragged_grids(draw):
    """Ragged mixed-SB grids over every axis, including the contention
    and directory knobs (as ``tests/test_sub_bank.py`` draws them)."""
    n = draw(st.integers(min_value=1, max_value=10))
    specs = []
    for _ in range(n):
        specs.append(TS.ScenarioSpec(
            draw(st.sampled_from(WORKLOAD_POOL)),
            draw(st.sampled_from(TS.CONFIGS)),
            seed=draw(st.integers(min_value=0, max_value=2)),
            n_replicas=draw(st.sampled_from((None, 2, 3))),
            link_bw_gbps=draw(st.sampled_from((None, 40.0))),
            sb_size=draw(st.sampled_from((None, 16, 48))),
            coalescing=draw(st.booleans()),
            read_share=draw(st.sampled_from((None, 0.3))),
            conflict_rate=draw(st.sampled_from((None, 0.05))),
            directory_load=draw(st.sampled_from((None, 0.5)))))
    return specs


@settings(max_examples=5, deadline=None)
@given(ragged_grids())
def test_every_tier_equals_jax_on_ragged_grids(grid):
    """Serial, per-step, stacked and banked one-shot planes and the
    stacked stream tier, all ``==`` the JAX package's banked batch."""
    ref = [fields(r) for r in JS.simulate_batch(jax_specs(grid), n_stores=N)]
    tiers = {
        "serial": TE.simulate_grid(grid, n_stores=N, engine="serial",
                                   device=CPU),
        "perstep": TS.simulate_batch(grid, n_stores=N, chunk_size=0,
                                     device=CPU),
        "stacked": TS.simulate_batch(grid, n_stores=N, data_plane="stacked",
                                     device=CPU),
        "banked": TS.simulate_batch(grid, n_stores=N, device=CPU),
        "stream-stacked": TE.run_grid(grid, n_stores=N, tile_cells=16,
                                      data_plane="stacked", device=CPU),
    }
    for name, res in tiers.items():
        assert [fields(r) for r in res] == ref, name


# --- twins of tests/test_batch_sim.py's engine-equivalence tests ----------

N_TWIN = 1500                             # ragged against 7, 64 and 72
UNIFORM_GRID = [TS.ScenarioSpec(w, c)
                for w in ("ycsb", "raytrace", "ocean_ncp")
                for c in TS.CONFIGS] + [TS.ScenarioSpec("canneal",
                                                        "proactive", seed=3)]
MIXED_GRID = UNIFORM_GRID[:6] + [
    TS.ScenarioSpec("ycsb", "parallel", sb_size=16),
    TS.ScenarioSpec("barnes", "proactive", sb_size=24),
    TS.ScenarioSpec("bodytrack", "proactive", n_replicas=4),
]


@pytest.fixture(scope="module")
def serial_by_spec():
    """The port's serial oracle, each cell held ``==`` the JAX package's
    the first time it is asked for."""
    cache = {}

    def get(spec, n=N_TWIN):
        key = (spec, n)
        if key not in cache:
            port = TS.simulate_spec(spec, n_stores=n, device=CPU)
            ref = JS.simulate_spec(jax_specs([spec])[0], n_stores=n)
            assert fields(port) == fields(ref), spec
            cache[key] = port
        return cache[key]

    return get


def _assert_bit_identical(specs, batch, oracle, ctx):
    for spec, rb in zip(specs, batch):
        assert fields(rb) == fields(oracle(spec)), (ctx, spec)


@pytest.mark.parametrize("chunk, plane", [
    (0, None), (1, "bank"), (7, "bank"), (72, "bank"), (512, "bank"),
    (1, "stacked"), (7, "stacked"), (72, "stacked"), (512, "stacked")])
def test_uniform_sb_engines_bit_identical(chunk, plane, serial_by_spec):
    """Every engine and plane at a uniform SB vs the serial oracle,
    ``==``; chunk > sb clamps to the SB depth."""
    out = TS.simulate_batch(UNIFORM_GRID, n_stores=N_TWIN, chunk_size=chunk,
                            data_plane=plane, device=CPU)
    _assert_bit_identical(UNIFORM_GRID, out, serial_by_spec,
                          (chunk, plane))


@pytest.mark.parametrize("chunk, plane", [
    (0, None), (1, "bank"), (7, "bank"), (64, "bank"), (1, "stacked"),
    (7, "stacked"), (64, "stacked")])
def test_mixed_sb_engines_bit_identical(chunk, plane, serial_by_spec):
    """Per-cell SB depths: one ring of sb_max slots for the per-step
    engine, one scan launch per depth for the blocked planes."""
    out = TS.simulate_batch(MIXED_GRID, n_stores=N_TWIN, chunk_size=chunk,
                            data_plane=plane, device=CPU)
    _assert_bit_identical(MIXED_GRID, out, serial_by_spec, (chunk, plane))


@pytest.mark.parametrize("n", [50, 100])
def test_short_trace_edge_cases(serial_by_spec, n):
    """n_stores below / barely above the SB depth."""
    specs = [TS.ScenarioSpec("ycsb", "proactive"),
             TS.ScenarioSpec("raytrace", "baseline")]
    for kw in (dict(), dict(chunk_size=0), dict(data_plane="stacked")):
        out = TS.simulate_batch(specs, n_stores=n, device=CPU, **kw)
        for spec, rb in zip(specs, out):
            assert fields(rb) == fields(serial_by_spec(spec, n)), (n, kw)


def test_odd_batch_padding_and_h2d_bytes():
    """Non-multiple-of-8 batches pad by repeating cell 0 without leaking
    padding into the output; h2d_bytes counts the padded arrays."""
    specs = [TS.ScenarioSpec("ycsb", "proactive"),
             TS.ScenarioSpec("raytrace", "wb"),
             TS.ScenarioSpec("barnes", "wt", seed=1)]
    for kw in (dict(chunk_size=0), dict(data_plane="stacked")):
        out = TS.simulate_batch(specs, n_stores=N, device=CPU, **kw)
        assert [(r.workload, r.config) for r in out] == \
            [(s.workload, s.config) for s in specs]
        assert out[0].meta["h2d_bytes"] == 8 * (17 * N + 8)


def test_batch_inputs_memo_is_cleared():
    specs = (TS.ScenarioSpec("ycsb", "wb"), TS.ScenarioSpec("ycsb", "wt"))
    dev = TS.resolve_device(CPU)
    first = TS._batch_inputs(specs, 100, TS.PAPER_CLUSTER, dev)
    assert TS._batch_inputs(specs, 100, TS.PAPER_CLUSTER, dev) is first
    TS.clear_sim_caches()
    assert TS._batch_inputs(specs, 100, TS.PAPER_CLUSTER, dev) is not first
