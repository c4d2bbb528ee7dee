"""The port's protocol simulator against the paper's published claims
(SS VII): the twin of ``tests/test_simulator.py``.

Every band and ordering of the reference file is checked on the port's
simulator on the CPU (``device="cpu"``), at the reference's
``N = 20 000`` stores, with the reference's numbers: the geomeans of WT,
baseline and proactive, parallel's small gain over baseline, the
per-workload ordering, the write-intensive worst cases and the Figs.
11-14 and 16-18 sensitivities.

The reference calls ``simulate`` once per cell. The port's serial
``simulate`` walks the stores one by one on the CPU (~1.5 s a cell at
this N), so the tests' ``simulate`` here reads every cell the file
needs from one ``simulate_batch`` over them (``_CELLS``), which is
``==`` the serial path (``test_torch_engine_tiers.py``, and
``test_serial_simulate_matches_jax`` below).

The reference promises bit-identity for the simulator (ROADMAP, north
star: its max-plus recurrence uses only IEEE add, max and select), so
parity cases hold the port's slowdown table and its ``simulate`` results
``==`` the JAX package's on the same seed.
"""

import numpy as np
import pytest

from repro_torch.configs.recxl_paper import WORKLOADS
from repro_torch.core.simulator import (
    ScenarioSpec,
    geomean_slowdowns,
    simulate_batch,
    slowdown_table,
)

N = 20_000
CPU = "cpu"
FIG16_BWS = (160, 20)
FIELDS = ("exec_time_ns", "n_repl_msgs", "repl_at_head_frac",
          "sb_full_frac", "max_log_bytes", "cxl_mem_bw_gbps",
          "log_dump_bw_gbps")


def _cells():
    cells = []
    for w in WORKLOADS:
        cells += [(w, "proactive", {}), (w, "proactive",
                                         {"coalescing": False})]
    for w in ("bodytrack", "canneal", "ycsb"):
        cells += [(w, "proactive", {"n_replicas": r}) for r in (3, 4)]
    for w, c in (("ycsb", "proactive"), ("ycsb", "wb"),
                 ("streamcluster", "proactive")):
        cells += [(w, c, {"link_bw_gbps": bw}) for bw in FIG16_BWS]
    for c in ("wb", "proactive"):
        cells += [("barnes", c, {"n_cns": n}) for n in (4, 16)]
    return [ScenarioSpec(w, c, **kw) for w, c, kw in cells]


_CELLS = _cells()
_RESULTS = {}


def simulate(workload, config, n_stores=N, **kw):
    """The reference's ``simulate(workload, config, n_stores=N, **kw)``,
    read from one batched run of ``_CELLS`` on the CPU."""
    assert n_stores == N
    if not _RESULTS:
        _RESULTS.update(zip(_CELLS, simulate_batch(_CELLS, n_stores=N,
                                                   device=CPU)))
    return _RESULTS[ScenarioSpec(workload, config, **kw)]


@pytest.fixture(scope="module")
def table():
    return slowdown_table(n_stores=N, device=CPU)


@pytest.fixture(scope="module")
def gm(table):
    return geomean_slowdowns(table)


def test_wt_slowdown_band(gm):
    """Paper: WT = 7.6x geomean."""
    assert 6.0 <= gm["wt"] <= 9.5, gm


def test_baseline_slowdown_band(gm):
    """Paper: ReCXL-baseline = 2.88x geomean."""
    assert 2.3 <= gm["baseline"] <= 3.5, gm


def test_proactive_slowdown_band(gm):
    """Paper: ReCXL-proactive = 1.30x geomean (the headline claim)."""
    assert 1.1 <= gm["proactive"] <= 1.55, gm


def test_parallel_close_to_baseline(gm):
    """Paper: parallel only ~3% better than baseline (exclusive prefetch
    hides the coherence transaction)."""
    gain = 1.0 - gm["parallel"] / gm["baseline"]
    assert 0.0 <= gain <= 0.10, gm


def test_ordering_invariants(table):
    """WB <= proactive <= parallel <= baseline <= WT for every workload."""
    for w, row in table.items():
        assert row["proactive"] <= row["parallel"] * 1.02, (w, row)
        assert row["parallel"] <= row["baseline"] * 1.001, (w, row)
        assert row["baseline"] <= row["wt"] * 1.001, (w, row)


def test_write_intensive_worst(table):
    """Paper: oceans are the WT/baseline-worst workloads."""
    wt = {w: row["wt"] for w, row in table.items()}
    worst = sorted(wt, key=wt.get)[-2:]
    assert set(worst) == {"ocean_ncp", "ocean_cp"}
    assert table["streamcluster"]["wt"] < 2.0     # all schemes fine (Fig 10)


def test_repl_at_head_fraction_fig11():
    """Paper Fig 11: raytrace & fluidanimate send most REPLs at the SB
    head (short bursts) -- that is why proactive barely helps them."""
    fracs = {w: simulate(w, "proactive", n_stores=N).repl_at_head_frac
             for w in WORKLOADS}
    assert fracs["raytrace"] > fracs["ocean_ncp"]
    assert fracs["fluidanimate"] > fracs["ycsb"]


def test_log_sizes_fig13():
    """Paper Fig 13: per-CN log demand varies widely, max ~18 MB
    (the DRAM log size chosen in Table II)."""
    sizes = [simulate(w, "proactive", n_stores=N).max_log_bytes
             for w in WORKLOADS]
    assert max(sizes) < 18e6 * 1.5
    assert min(sizes) < 3e6                        # wide spread
    assert max(sizes) > 5e6


def test_dump_bandwidth_fig14():
    """Paper Fig 14: log-dump bandwidth < 5 GB/s for every app."""
    for w in WORKLOADS:
        r = simulate(w, "proactive", n_stores=N)
        assert r.log_dump_bw_gbps < 5.0 * 4.0      # cluster-wide, slack 4x


def test_nr_sensitivity_fig17():
    """Paper Fig 17: execution time increases slowly with N_r
    (N_r=4 ~2% slower than N_r=3 on average)."""
    ratios = []
    for w in ("bodytrack", "canneal", "ycsb"):
        t3 = simulate(w, "proactive", n_stores=N, n_replicas=3).exec_time_ns
        t4 = simulate(w, "proactive", n_stores=N, n_replicas=4).exec_time_ns
        ratios.append(t4 / t3)
    mean = float(np.mean(ratios))
    assert 0.99 <= mean <= 1.15


def test_link_bw_sensitivity_fig16():
    """Paper Fig 16: low link bandwidth hurts ReCXL-proactive more than
    WB on average; streamcluster unaffected."""
    w = "ycsb"
    pro_hi = simulate(w, "proactive", n_stores=N, link_bw_gbps=160).exec_time_ns
    pro_lo = simulate(w, "proactive", n_stores=N, link_bw_gbps=20).exec_time_ns
    wb_hi = simulate(w, "wb", n_stores=N, link_bw_gbps=160).exec_time_ns
    wb_lo = simulate(w, "wb", n_stores=N, link_bw_gbps=20).exec_time_ns
    assert pro_lo / pro_hi >= wb_lo / wb_hi * 0.999
    sc_hi = simulate("streamcluster", "proactive", n_stores=N,
                     link_bw_gbps=160).exec_time_ns
    sc_lo = simulate("streamcluster", "proactive", n_stores=N,
                     link_bw_gbps=20).exec_time_ns
    assert sc_lo / sc_hi < 1.25


def test_cn_scaling_fig18():
    """Paper Fig 18: 4 -> 16 CNs cuts execution ~3x for both WB and
    ReCXL-proactive (weak-scaling model)."""
    for cfgname in ("wb", "proactive"):
        t4 = simulate("barnes", cfgname, n_stores=N, n_cns=4).exec_time_ns
        t16 = simulate("barnes", cfgname, n_stores=N, n_cns=16).exec_time_ns
        assert 2.5 <= t4 / t16 <= 4.5


def test_coalescing_mixed_effect_fig12():
    """Paper Fig 12: coalescing helps some apps, hurts others (no clear
    trend). We assert both directions exist OR the effect is tiny."""
    deltas = []
    for w in WORKLOADS:
        t_on = simulate(w, "proactive", n_stores=N, coalescing=True).exec_time_ns
        t_off = simulate(w, "proactive", n_stores=N, coalescing=False).exec_time_ns
        deltas.append(t_off / t_on - 1.0)
    assert max(deltas) > -0.02       # coalescing not uniformly harmful
    assert min(deltas) < 0.25        # nor a uniform disaster off


# ---------------------------------------------------------------------------
# Parity with the JAX package (bit-identity, the reference's promise)
# ---------------------------------------------------------------------------

def test_slowdown_table_matches_jax(table):
    from repro.core.simulator import slowdown_table as jax_slowdown_table
    ref = jax_slowdown_table(n_stores=N)
    assert table == ref


@pytest.mark.parametrize("workload,config,kw", [
    ("ycsb", "proactive", {}),
    ("canneal", "proactive", {"n_replicas": 4}),
    ("barnes", "wb", {"n_cns": 4}),
    ("streamcluster", "proactive", {"link_bw_gbps": 20}),
    ("ocean_cp", "proactive", {"coalescing": False}),
])
def test_batched_cells_match_jax(workload, config, kw):
    """The cells' results ``==`` the JAX package's ``simulate``."""
    from repro.core.simulator import simulate as jax_simulate
    a = simulate(workload, config, n_stores=N, **kw)
    b = jax_simulate(workload, config, n_stores=N, **kw)
    for f in FIELDS:
        assert getattr(a, f) == getattr(b, f), f


def test_serial_simulate_matches_jax():
    """The port's serial oracle itself, on one cell of each file's
    figure: ``==`` the JAX package's ``simulate``."""
    from repro.core.simulator import simulate as jax_simulate
    from repro_torch.core.simulator import simulate as port_simulate
    a = port_simulate("raytrace", "proactive", n_stores=N, n_replicas=4,
                      device=CPU)
    b = jax_simulate("raytrace", "proactive", n_stores=N, n_replicas=4)
    for f in FIELDS:
        assert getattr(a, f) == getattr(b, f), f
