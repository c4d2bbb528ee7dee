"""The port's contention and crash-consistency axes: the twin of
``tests/test_contention.py``.

``repro_torch.core.contention`` is a copy of the JAX package's module
(import paths aside), and the port's simulator, engine and scenario
grids consume it as the JAX package's do. Every contract of the
reference file runs here on the port, on the CPU (``device="cpu"``),
with the reference's numbers and bands:

* contended timelines are bit-identical (``==``) across the
  pure-Python pre-collapse oracle, the serial oracle, the blocked batch
  (both data planes) and the banked streaming engine, on ragged
  mixed-SB grids (the reference's ``max_examples``, derandomized);
* all-``None`` axes are inert and keep the legacy bank keys and the
  12 960-cell mega-grid's 27 + 1 298 rows; neutral values give the
  legacy outputs in a row of their own;
* slowdown is monotone in the knobs, and the SS VII-E downtime model
  varies with the contention regime;
* ``clear_sim_caches()`` drops the contention memos.

Parity cases hold the port's cheap functions ``==`` the JAX package's
on the same seed: the conflict draws and flush schedules, the dirty-line
scales, the serial oracle, the bank keys, and a contended grid through
``simulate_batch``.
"""

import gc
import weakref

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.configs.recxl_paper import WORKLOADS
from repro_torch.core import contention as C
from repro_torch.core import engine as E
from repro_torch.core import simulator as S
from repro_torch.core.contention import (
    CONSISTENCY_SCHEDULES,
    ContentionParams,
    dirty_line_scale,
    resolve_contention,
    serial_oracle,
    undumped_log_scale,
)
from repro_torch.core.scenarios import (
    contention_grid,
    contention_mega_grid,
    mega_grid,
    recovery_sweep,
)
from repro_torch.core.simulator import (
    ScenarioSpec,
    bank_row_maps,
    clear_sim_caches,
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
# Axis resolution + validation
# ---------------------------------------------------------------------------

def test_resolve_contention_none_and_partial():
    assert resolve_contention(None, None, None) is None
    p = resolve_contention(None, 0.3, None)
    assert p == ContentionParams(read_share=0.0, conflict_rate=0.3,
                                 schedule="lazy")
    p = resolve_contention(0.5, None, "eager")
    assert p.schedule == "eager" and p.conflict_rate == 0.0


def test_contention_validation_rejected():
    for bad in (ScenarioSpec("ycsb", "proactive", conflict_rate=1.0),
                ScenarioSpec("ycsb", "proactive", conflict_rate=-0.1),
                ScenarioSpec("ycsb", "proactive", read_share=1.5),
                ScenarioSpec("ycsb", "proactive",
                             consistency_schedule="nosuch")):
        with pytest.raises(ValueError):
            simulate_batch([bad], n_stores=N, device=CPU)
    with pytest.raises(ValueError):
        C.schedule_flush_ns("nosuch", 8, S.PAPER_CLUSTER)


# ---------------------------------------------------------------------------
# Differential bit-identity across every path (the oracle discipline)
# ---------------------------------------------------------------------------

@st.composite
def contended_grids(draw):
    """Ragged mixed-SB grids spanning every contention axis."""
    n = draw(st.integers(min_value=1, max_value=10))
    specs = []
    for _ in range(n):
        specs.append(ScenarioSpec(
            draw(st.sampled_from(WORKLOAD_POOL)),
            draw(st.sampled_from(S.CONFIGS)),
            seed=draw(st.integers(min_value=0, max_value=1)),
            n_replicas=draw(st.sampled_from((None, 4))),
            n_cns=draw(st.sampled_from((None, 8))),
            sb_size=draw(st.sampled_from((None, 16, 24))),
            read_share=draw(st.sampled_from((None, 0.0, 0.4, 0.8))),
            conflict_rate=draw(st.sampled_from((None, 0.0, 0.25, 0.6))),
            consistency_schedule=draw(st.sampled_from(
                (None,) + CONSISTENCY_SCHEDULES))))
    return specs


@settings(max_examples=6, deadline=None, derandomize=True)
@given(contended_grids())
def test_contended_paths_bit_identical(specs):
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


def test_neutral_axes_reproduce_legacy_bits_in_new_row():
    """(0.0, 0.0, "lazy") must equal the axes-off cell bit-for-bit --
    the delays are exactly zero -- while occupying its own bank row."""
    legacy = ScenarioSpec("ycsb", "proactive")
    neutral = ScenarioSpec("ycsb", "proactive", read_share=0.0,
                           conflict_rate=0.0, consistency_schedule="lazy")
    a, b = simulate_batch([legacy, neutral], n_stores=N, device=CPU)
    _assert_identical(a, b, "neutral-vs-legacy")
    bank = S.get_trace_bank([legacy, neutral], N)
    assert bank.rows_for(legacy)[1] != bank.rows_for(neutral)[1]
    assert bank.rows_for(legacy)[0] == bank.rows_for(neutral)[0]  # trace


def test_wb_wt_rows_stay_constant_under_contention():
    """WB/WT commit locally: contention never perturbs them, so their
    constant bank rows (and the WB normalization baseline) survive a
    contended grid."""
    specs = [ScenarioSpec("ycsb", c, conflict_rate=cr)
             for c in ("wb", "wt") for cr in (None, 0.6)]
    bank = S.get_trace_bank(specs, N)
    assert bank.wv_rows == 2
    res = simulate_batch(specs, n_stores=N, device=CPU)
    _assert_identical(res[0], res[1], "wb-contended")
    _assert_identical(res[2], res[3], "wt-contended")


# ---------------------------------------------------------------------------
# No bank-key churn for legacy grids
# ---------------------------------------------------------------------------

def test_legacy_plane_keys_unchanged():
    """Axes-off specs must produce the exact PR-4 key format (no
    appended contention component)."""
    tk, wk = S._plane_keys(ScenarioSpec("ycsb", "proactive"),
                           S.PAPER_CLUSTER)
    assert tk == ("ycsb", 0)
    assert wk == ("proactive", "ycsb", 0, 3, 160.0, True)
    _, wk = S._plane_keys(ScenarioSpec("ycsb", "wb", conflict_rate=0.5),
                          S.PAPER_CLUSTER)
    assert wk == ("wb",)
    _, wk = S._plane_keys(
        ScenarioSpec("ycsb", "proactive", conflict_rate=0.5),
        S.PAPER_CLUSTER)
    assert len(wk) == 7 and isinstance(wk[6], ContentionParams)


def test_mega_grid_bank_rows_unchanged():
    """The 12 960-cell legacy mega-grid keeps its PR-4 dedup: 27 trace
    rows (workload x seed) + 1 298 max-plus rows (2 constants + the
    replicating cross-product) -- contention axes add zero churn."""
    specs = mega_grid()
    assert len(specs) == 12_960
    trace_map, wv_map = bank_row_maps(specs)
    w = len(WORKLOADS)
    assert len(trace_map) == w * 3
    assert len(wv_map) == 2 + 3 * w * 3 * 4 * 4
    assert (len(trace_map), len(wv_map)) == (27, 1298)


# ---------------------------------------------------------------------------
# Semantics: monotone slowdowns, schedule ordering, lane sharing
# ---------------------------------------------------------------------------

def test_slowdown_monotone_in_conflict_rate():
    rates = (0.0, 0.25, 0.6)
    specs = [ScenarioSpec("ycsb", "proactive", conflict_rate=r)
             for r in rates]
    t = [r.exec_time_ns
         for r in simulate_batch(specs, n_stores=N, device=CPU)]
    assert t[0] < t[1] < t[2], t


def test_schedule_ordering_and_epoch_barriers():
    specs = [ScenarioSpec("ycsb", "proactive", consistency_schedule=sc)
             for sc in CONSISTENCY_SCHEDULES]
    t = {sc: r.exec_time_ns
         for sc, r in zip(CONSISTENCY_SCHEDULES,
                          simulate_batch(specs, n_stores=N, device=CPU))}
    assert t["lazy"] < t["epoch"] < t["eager"], t
    flush = C.schedule_flush_ns("epoch", 3 * C.EPOCH_LEN, S.PAPER_CLUSTER)
    assert np.count_nonzero(flush) == 3
    assert C.schedule_flush_ns("lazy", 16, S.PAPER_CLUSTER).any() == False  # noqa: E712


def test_cn_axis_shares_contended_lanes():
    """Contention keys exclude n_cns, so the CN weak-scaling axis still
    collapses to one scan lane per contended regime."""
    specs = [ScenarioSpec("ycsb", "proactive", n_cns=ncn,
                          conflict_rate=0.4, consistency_schedule="epoch")
             for ncn in (16, 8, 4, 2)]
    res = simulate_batch(specs, n_stores=N, device=CPU)
    assert res[0].meta["scan_lanes"] == 1
    E.run_grid(specs, n_stores=N, tile_cells=16, device=CPU)
    assert E.bank_stats()["scan_lanes"] == 1


def test_contention_grid_constructors():
    assert len(contention_grid()) == 3 * 2 * 3 * 2 * 3
    specs = contention_mega_grid()
    assert len(specs) == len(WORKLOADS) * 2 * 2 * 2 * 2 * 3 * 2 * 3
    assert len(specs) >= E.STREAM_THRESHOLD   # auto-routes to streaming
    assert any(s.conflict_rate == 0.5 for s in specs)
    # the neutral normalization corner is present
    assert any(s.conflict_rate == 0.0 and s.read_share == 0.0
               and s.consistency_schedule == "lazy" for s in specs)


def test_contended_streaming_compiles_and_dedup():
    """A contended multi-regime grid still runs on a handful of
    compiled tile programs with scan-lane dedup active."""
    clear_sim_caches()
    specs = contention_mega_grid(
        workloads=("ycsb", "canneal"), seeds=(0,), replicas=(1,),
        cn_counts=(16, 8), conflict_rates=(0.0, 0.5),
        read_shares=(0.0,), schedules=("lazy", "eager"))
    t0 = E.trace_count()
    E.run_grid(specs, n_stores=N, tile_cells=32, device=CPU)
    assert E.trace_count() - t0 <= 3
    stats = E.bank_stats()
    assert stats["scan_lanes"] < stats["cells"] == len(specs)
    assert stats["data_plane"] == "bank"


# ---------------------------------------------------------------------------
# Recovery coupling (conflict-dependent dirty lines -> downtime)
# ---------------------------------------------------------------------------

def test_dirty_line_scales_monotone():
    base = ContentionParams()
    assert dirty_line_scale(base) == 1.0
    assert undumped_log_scale(base) == 1.0
    hot = ContentionParams(conflict_rate=0.6)
    assert dirty_line_scale(hot) > 1.0
    assert undumped_log_scale(hot) > 1.0
    ready = ContentionParams(read_share=0.8)
    assert dirty_line_scale(ready) < 1.0
    eager = ContentionParams(schedule="eager")
    epoch = ContentionParams(schedule="epoch")
    assert dirty_line_scale(eager) < dirty_line_scale(epoch) < 1.0
    assert undumped_log_scale(eager) < undumped_log_scale(epoch) < 1.0


def test_recovery_sweep_varies_with_contention():
    base = recovery_sweep(workloads=("ycsb",), cn_counts=(16,), device=CPU)
    hot = recovery_sweep(workloads=("ycsb",), cn_counts=(16,),
                         conflict_rate=0.6, device=CPU)
    eager = recovery_sweep(workloads=("ycsb",), cn_counts=(16,),
                           consistency_schedule="eager", device=CPU)
    t_mid = base.fail_times_ms[1]
    assert hot.total_ms("ycsb", t_mid, 16) > base.total_ms("ycsb", t_mid, 16)
    assert eager.total_ms("ycsb", t_mid, 16) < base.total_ms("ycsb", t_mid,
                                                             16)
    with pytest.raises(ValueError):
        recovery_sweep(workloads=("ycsb",), conflict_rate=2.0,
                       device=CPU)


# ---------------------------------------------------------------------------
# Cache lifecycle (same discipline as the _BANK_CACHE tests)
# ---------------------------------------------------------------------------

def test_clear_sim_caches_drops_contention_memos():
    clear_sim_caches()
    spec = ScenarioSpec("ycsb", "proactive", conflict_rate=0.4,
                        read_share=0.3)
    simulate_batch([spec], n_stores=N, device=CPU)
    draws, delays = C.contention_cache_sizes()
    assert draws > 0 and delays > 0
    d = C.conflict_draws(N, 0, 0.4, 0.3)       # cache hit
    ref = weakref.ref(d["retries"])
    del d
    clear_sim_caches()
    gc.collect()
    assert C.contention_cache_sizes() == (0, 0)
    assert ref() is None, "contention draw arrays leaked past cache clear"


# ---------------------------------------------------------------------------
# Parity with the JAX package on the same seed
# ---------------------------------------------------------------------------

def test_draws_schedules_and_scales_match_jax():
    from repro.core import contention as JC
    for seed in (0, 1):
        for cr, rs in ((0.0, 0.0), (0.25, 0.4), (0.6, 0.8)):
            a = C.conflict_draws(N, seed, cr, rs)
            b = JC.conflict_draws(N, seed, cr, rs)
            assert set(a) == set(b)
            for k in a:
                assert np.array_equal(a[k], np.asarray(b[k])), (seed, k)
    for sc in CONSISTENCY_SCHEDULES:
        assert np.array_equal(
            C.schedule_flush_ns(sc, N, S.PAPER_CLUSTER),
            np.asarray(JC.schedule_flush_ns(sc, N, S.PAPER_CLUSTER)))
        for cr in (0.0, 0.6):
            for rs in (0.0, 0.8):
                p = ContentionParams(read_share=rs, conflict_rate=cr,
                                     schedule=sc)
                q = JC.ContentionParams(read_share=rs, conflict_rate=cr,
                                        schedule=sc)
                assert dirty_line_scale(p) == JC.dirty_line_scale(q)
                assert undumped_log_scale(p) == JC.undumped_log_scale(q)


PARITY_SPECS = [
    ScenarioSpec("ycsb", "proactive", conflict_rate=0.25, read_share=0.4),
    ScenarioSpec("canneal", "baseline", seed=1, conflict_rate=0.6,
                 consistency_schedule="eager", sb_size=16),
    ScenarioSpec("barnes", "parallel", read_share=0.8, n_cns=8,
                 consistency_schedule="epoch"),
    ScenarioSpec("raytrace", "wb", conflict_rate=0.6),
    ScenarioSpec("ycsb", "proactive", read_share=0.0, conflict_rate=0.0,
                 consistency_schedule="lazy", n_replicas=4),
]


def _jax_spec(s):
    from repro.core.simulator import ScenarioSpec as JSpec
    return JSpec(**{f: getattr(s, f) for f in s.__dataclass_fields__})


def test_serial_oracle_and_keys_match_jax():
    from repro.core import contention as JC
    from repro.core import simulator as JS
    for s in PARITY_SPECS:
        js = _jax_spec(s)
        _assert_identical(serial_oracle(s, n_stores=N),
                          JC.serial_oracle(js, n_stores=N), s)
        assert repr(S._plane_keys(s, S.PAPER_CLUSTER)) == \
            repr(JS._plane_keys(js, JS.PAPER_CLUSTER))
    port = bank_row_maps(PARITY_SPECS)
    ref = JS.bank_row_maps([_jax_spec(s) for s in PARITY_SPECS])
    assert [repr(m) for m in port] == [repr(m) for m in ref]


def test_contended_batch_matches_jax():
    from repro.core import simulator as JS
    port = simulate_batch(PARITY_SPECS, n_stores=N, device=CPU)
    ref = JS.simulate_batch([_jax_spec(s) for s in PARITY_SPECS],
                            n_stores=N)
    for s, a, b in zip(PARITY_SPECS, port, ref):
        _assert_identical(a, b, s)
