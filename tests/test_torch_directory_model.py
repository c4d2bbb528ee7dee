"""The port's queueing-coupled directory model (the two-level max-plus
recurrence): the twin of ``tests/test_directory_model.py``.

``repro_torch.core.directory`` is a copy of the JAX package's module
(one import path differs), consumed by the port's simulator, engine and
scenario grids as there. Every contract of the reference file runs
here on the port, on the CPU (``device="cpu"``), with the reference's
numbers:

* directory-coupled timelines are bit-identical (``==``) across the
  pure-Python pre-collapse oracle, the serial oracle, the blocked batch
  (both data planes) and the banked streaming engine, on ragged
  mixed-SB grids spanning the contention axes too (the reference's
  ``max_examples``, derandomized);
* ``directory_load=None`` is inert, outputs and bank keys; ``0.0``
  gives the legacy outputs in a row of its own, shared across CN counts;
* the sharer census is clamped to ``n_cns - 1``;
* baseline slowdown is strictly monotone in load, proactive only weakly;
* the SS VII-E downtime model dilates its directory walk with load.

Parity cases hold the port ``==`` the JAX package on the same seed: the
directory parameters, the service scale and the sharer pool, the serial
oracle and the bank keys of coupled cells, and a coupled grid through
``simulate_batch``.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.core import contention as C
from repro_torch.core import engine as E
from repro_torch.core import simulator as S
from repro_torch.core.contention import ContentionParams, serial_oracle
from repro_torch.core.directory import (
    DirectoryParams,
    directory_service_scale,
    resolve_directory_load,
    sharer_pool,
)
from repro_torch.core.scenarios import (
    directory_mega_grid,
    mega_grid,
    recovery_sweep,
)
from repro_torch.core.simulator import (
    ScenarioSpec,
    bank_row_maps,
    simulate_batch,
    simulate_spec,
)

N = 700                                  # N % 72 != 0: ragged store tail
CPU = "cpu"
FLOAT_FIELDS = ("exec_time_ns", "repl_at_head_frac", "sb_full_frac",
                "max_log_bytes", "cxl_mem_bw_gbps", "log_dump_bw_gbps")
WORKLOAD_POOL = ("ycsb", "canneal", "barnes", "raytrace")


def _assert_identical(a, b, ctx):
    assert a.n_repl_msgs == b.n_repl_msgs, ctx
    for f in FLOAT_FIELDS:
        assert getattr(a, f) == getattr(b, f), (ctx, f)


# ---------------------------------------------------------------------------
# Axis resolution, census clamp, validation
# ---------------------------------------------------------------------------

def test_resolve_directory_load():
    assert resolve_directory_load(None, 16, 3) is None
    zero = resolve_directory_load(0.0, 16, 3)
    assert zero == DirectoryParams(sharer_pool=0, rho_bg=0.0)
    # canonical zero-load params are CN-independent (cross-CN dedup)
    assert zero == resolve_directory_load(0.0, 4, 3)
    p = resolve_directory_load(0.4, 16, 3)
    assert p.sharer_pool == sharer_pool(16, 3) and p.rho_bg > 0.0
    for bad in (1.0, 1.5, -0.1):
        with pytest.raises(ValueError):
            resolve_directory_load(bad, 16, 3)
    with pytest.raises(ValueError):
        simulate_batch([ScenarioSpec("ycsb", "proactive",
                                     directory_load=1.0)], n_stores=N,
                       device=CPU)


def test_sharer_pool_clamped_to_cluster():
    assert sharer_pool(16, 3) == C.SHARER_POOL == 15
    assert sharer_pool(4, 3) == 3      # not 15 phantom peers
    assert sharer_pool(2, 3) == 1
    assert sharer_pool(1, 3) == 0      # nobody to invalidate
    for ncn in (2, 3, 4, 8, 16, 32):
        assert sharer_pool(ncn, 3) <= ncn - 1


def test_contention_census_directory_derived():
    """Resolved coupling replaces the fixed binomial pool with the real
    replica-set census on small clusters (the overcount bugfix)."""
    spec = ScenarioSpec("ycsb", "proactive", n_cns=4, read_share=0.8,
                        conflict_rate=0.4)
    con, _ = S._resolve_coupling(spec, S.PAPER_CLUSTER)
    assert con.sharer_pool == 3
    con16, _ = S._resolve_coupling(
        ScenarioSpec("ycsb", "proactive", read_share=0.8,
                     conflict_rate=0.4), S.PAPER_CLUSTER)
    assert con16.sharer_pool == C.SHARER_POOL
    # read_share == 0: the binomial is identically zero, so the pool is
    # canonicalized to 0 -- keeps the CN axis on one lane (and one key)
    con0, _ = S._resolve_coupling(
        ScenarioSpec("ycsb", "proactive", n_cns=4, conflict_rate=0.4),
        S.PAPER_CLUSTER)
    assert con0.sharer_pool == 0


def test_small_cluster_census_shrinks_invalidations():
    """The clamped 4-CN pool draws strictly fewer sharer invalidations
    than the fixed 15-peer binomial did for the same regime (the CN
    axis also rescales work, so the comparison is at the draw level)."""
    d3 = C.conflict_draws(N, 0, 0.4, 0.8, pool=3)
    d15 = C.conflict_draws(N, 0, 0.4, 0.8, pool=15)
    assert int(d3["sharers"].sum()) < int(d15["sharers"].sum())
    assert int(d3["sharers"].max()) <= 3
    # identical episode structure: the census is the LAST rng draw
    np.testing.assert_array_equal(d3["retries"], d15["retries"])


# ---------------------------------------------------------------------------
# Differential bit-identity across every path (the oracle discipline)
# ---------------------------------------------------------------------------

@st.composite
def coupled_grids(draw):
    """Ragged mixed-SB grids spanning the directory AND contention axes."""
    n = draw(st.integers(min_value=1, max_value=10))
    specs = []
    for _ in range(n):
        specs.append(ScenarioSpec(
            draw(st.sampled_from(WORKLOAD_POOL)),
            draw(st.sampled_from(S.CONFIGS)),
            seed=draw(st.integers(min_value=0, max_value=1)),
            n_replicas=draw(st.sampled_from((None, 4))),
            n_cns=draw(st.sampled_from((None, 8, 4))),
            sb_size=draw(st.sampled_from((None, 16, 24))),
            read_share=draw(st.sampled_from((None, 0.0, 0.4))),
            conflict_rate=draw(st.sampled_from((None, 0.25))),
            directory_load=draw(st.sampled_from((None, 0.0, 0.3, 0.7)))))
    return specs


@settings(max_examples=6, deadline=None, derandomize=True)
@given(coupled_grids())
def test_coupled_paths_bit_identical(specs):
    banked = simulate_batch(specs, n_stores=N, device=CPU)
    stacked = simulate_batch(specs, n_stores=N, data_plane="stacked",
                             device=CPU)
    stream = E.run_grid(specs, n_stores=N, tile_cells=16, device=CPU)
    for i, s in enumerate(specs):
        serial = simulate_spec(s, n_stores=N, device=CPU)
        oracle = serial_oracle(s, n_stores=N)
        _assert_identical(oracle, serial, (s, "oracle-vs-serial"))
        _assert_identical(banked[i], serial, (s, "banked-vs-serial"))
        _assert_identical(stacked[i], serial, (s, "stacked-vs-serial"))
        _assert_identical(stream[i], serial, (s, "stream-vs-serial"))


def test_load_zero_reproduces_legacy_bits_in_new_row():
    """``directory_load=0.0`` must equal the axis-off cell bit-for-bit
    -- the epoch delays are exactly zero -- while occupying its own
    bank row (the in-grid normalization cell)."""
    legacy = ScenarioSpec("ycsb", "proactive")
    zero = ScenarioSpec("ycsb", "proactive", directory_load=0.0)
    a, b = simulate_batch([legacy, zero], n_stores=N, device=CPU)
    _assert_identical(a, b, "zero-load-vs-legacy")
    bank = S.get_trace_bank([legacy, zero], N)
    assert bank.rows_for(legacy)[1] != bank.rows_for(zero)[1]
    assert bank.rows_for(legacy)[0] == bank.rows_for(zero)[0]  # trace


def test_wb_wt_rows_stay_constant_under_directory_load():
    """WB/WT commit locally and never consult the directory: their
    constant bank rows survive a coupled grid bit-for-bit."""
    specs = [ScenarioSpec("ycsb", c, directory_load=dl)
             for c in ("wb", "wt") for dl in (None, 0.7)]
    bank = S.get_trace_bank(specs, N)
    assert bank.wv_rows == 2
    res = simulate_batch(specs, n_stores=N, device=CPU)
    _assert_identical(res[0], res[1], "wb-coupled")
    _assert_identical(res[2], res[3], "wt-coupled")


# ---------------------------------------------------------------------------
# No bank-key churn for legacy grids; coupled keys extend the tail
# ---------------------------------------------------------------------------

def test_legacy_plane_keys_unchanged_by_directory_axis():
    """Axis-off specs keep the exact PR-4/PR-5 key format; coupled
    specs append typed params in fixed (contention, directory) order."""
    tk, wk = S._plane_keys(ScenarioSpec("ycsb", "proactive"),
                           S.PAPER_CLUSTER)
    assert tk == ("ycsb", 0)
    assert wk == ("proactive", "ycsb", 0, 3, 160.0, True)
    _, wk = S._plane_keys(ScenarioSpec("ycsb", "wb", directory_load=0.5),
                          S.PAPER_CLUSTER)
    assert wk == ("wb",)
    _, wk = S._plane_keys(
        ScenarioSpec("ycsb", "proactive", directory_load=0.5),
        S.PAPER_CLUSTER)
    assert len(wk) == 7 and isinstance(wk[6], DirectoryParams)
    _, wk = S._plane_keys(
        ScenarioSpec("ycsb", "proactive", conflict_rate=0.5,
                     directory_load=0.5), S.PAPER_CLUSTER)
    assert len(wk) == 8
    assert isinstance(wk[6], ContentionParams)
    assert isinstance(wk[7], DirectoryParams)


def test_mega_grid_bank_rows_unchanged_by_directory_axis():
    """The 12 960-cell legacy mega-grid keeps its PR-4 dedup (27 trace
    + 1 298 max-plus rows): the directory axis adds zero churn."""
    specs = mega_grid()
    trace_map, wv_map = bank_row_maps(specs)
    assert (len(trace_map), len(wv_map)) == (27, 1298)


def test_load_zero_cells_share_one_lane_across_cn_counts():
    """The canonical zero-load params carry no pool, so the CN axis of
    the normalization column collapses to one scan lane."""
    specs = [ScenarioSpec("ycsb", "proactive", n_cns=ncn,
                          directory_load=0.0)
             for ncn in (16, 8, 4, 2)]
    res = simulate_batch(specs, n_stores=N, device=CPU)
    assert res[0].meta["scan_lanes"] == 1
    # loaded cells at different CN counts resolve different rho_bg and
    # must NOT share a lane
    keys = {S._plane_keys(ScenarioSpec("ycsb", "proactive", n_cns=ncn,
                                       directory_load=0.4),
                          S.PAPER_CLUSTER)[1] for ncn in (16, 4)}
    assert len(keys) == 2


# ---------------------------------------------------------------------------
# Semantics: monotone slowdown (baseline), absorption (proactive)
# ---------------------------------------------------------------------------

def test_baseline_slowdown_strictly_monotone_in_load():
    loads = (0.0, 0.3, 0.7)
    t = [simulate_spec(ScenarioSpec("ycsb", "baseline",
                                    directory_load=dl),
                       n_stores=N, device=CPU).exec_time_ns for dl in loads]
    assert t[0] < t[1] < t[2], t


def test_proactive_absorbs_directory_wait():
    """Proactive's decoupled drain chain dominates the collapse, so the
    w-side epoch delays may vanish entirely -- only weak monotonicity
    holds (the capacity-vs-resilience contrast the bench reports)."""
    loads = (0.0, 0.3, 0.7)
    t = [simulate_spec(ScenarioSpec("ycsb", "proactive",
                                    directory_load=dl),
                       n_stores=N, device=CPU).exec_time_ns for dl in loads]
    assert t[0] <= t[1] <= t[2], t
    base = [simulate_spec(ScenarioSpec("ycsb", "baseline",
                                       directory_load=dl),
                          n_stores=N, device=CPU).exec_time_ns for dl in loads]
    # proactive hides strictly more of the wait than baseline does
    assert t[2] / t[0] < base[2] / base[0]


def test_directory_mega_grid_constructor():
    specs = directory_mega_grid()
    assert len(specs) == 2592
    assert len(specs) >= E.STREAM_THRESHOLD   # auto-routes to streaming
    assert any(s.directory_load == 0.0 for s in specs)   # normalization
    assert any(s.n_cns == 4 for s in specs)              # clamp exercise
    assert {s.config for s in specs} >= {"baseline", "proactive"}


# ---------------------------------------------------------------------------
# Recovery coupling (background load dilates the directory walk)
# ---------------------------------------------------------------------------

def test_directory_service_scale():
    assert directory_service_scale(None) == 1.0
    assert directory_service_scale(resolve_directory_load(0.0, 16, 3)) \
        == 1.0
    s3 = directory_service_scale(resolve_directory_load(0.3, 16, 3))
    s7 = directory_service_scale(resolve_directory_load(0.7, 16, 3))
    assert 1.0 < s3 < s7 <= 1.0 / (1.0 - 0.95) + 1e-6


def test_recovery_sweep_monotone_in_directory_load():
    base = recovery_sweep(workloads=("ycsb",), cn_counts=(16,), device=CPU)
    mid = recovery_sweep(workloads=("ycsb",), cn_counts=(16,),
                         directory_load=0.3, device=CPU)
    hot = recovery_sweep(workloads=("ycsb",), cn_counts=(16,),
                         directory_load=0.7, device=CPU)
    t_mid = base.fail_times_ms[1]
    b, m, h = (s.total_ms("ycsb", t_mid, 16) for s in (base, mid, hot))
    assert b < m < h, (b, m, h)
    with pytest.raises(ValueError):
        recovery_sweep(workloads=("ycsb",), directory_load=1.5, device=CPU)


# ---------------------------------------------------------------------------
# Parity with the JAX package on the same seed
# ---------------------------------------------------------------------------

PARITY_SPECS = [
    ScenarioSpec("ycsb", "baseline", directory_load=0.5),
    ScenarioSpec("canneal", "proactive", seed=1, directory_load=0.0,
                 n_cns=4, sb_size=24),
    ScenarioSpec("barnes", "parallel", directory_load=0.8,
                 conflict_rate=0.25, read_share=0.4),
    ScenarioSpec("raytrace", "wt", directory_load=0.8),
    ScenarioSpec("ycsb", "proactive", directory_load=0.3, n_replicas=4,
                 consistency_schedule="epoch"),
]


def _jax_spec(s):
    from repro.core.simulator import ScenarioSpec as JSpec
    return JSpec(**{f: getattr(s, f) for f in s.__dataclass_fields__})


def test_directory_params_match_jax():
    from repro.core import directory as JD
    for n_cns in (2, 4, 8, 16):
        for n_replicas in (1, 3, 4):
            if n_replicas >= n_cns:
                continue
            assert sharer_pool(n_cns, n_replicas) == \
                JD.sharer_pool(n_cns, n_replicas)
            for load in (None, 0.0, 0.3, 0.8, 0.99):
                p = resolve_directory_load(load, n_cns, n_replicas)
                q = JD.resolve_directory_load(load, n_cns, n_replicas)
                assert repr(p).split("(", 1)[-1] == \
                    repr(q).split("(", 1)[-1]
                assert directory_service_scale(p) == \
                    JD.directory_service_scale(q)


def test_coupled_oracle_and_keys_match_jax():
    from repro.core import contention as JC
    from repro.core import simulator as JS
    for s in PARITY_SPECS:
        js = _jax_spec(s)
        _assert_identical(serial_oracle(s, n_stores=N),
                          JC.serial_oracle(js, n_stores=N), s)
        assert repr(S._plane_keys(s, S.PAPER_CLUSTER)) == \
            repr(JS._plane_keys(js, JS.PAPER_CLUSTER))


def test_coupled_batch_matches_jax():
    from repro.core import simulator as JS
    port = simulate_batch(PARITY_SPECS, n_stores=N, device=CPU)
    ref = JS.simulate_batch([_jax_spec(s) for s in PARITY_SPECS],
                            n_stores=N)
    for s, a, b in zip(PARITY_SPECS, port, ref):
        _assert_identical(a, b, s)
