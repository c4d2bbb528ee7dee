"""Host layer of the port against the JAX package, byte for byte.

Trace synthesis, the max-plus row collapse, the columnar bank (columns,
row maps, ``extend``, the journal, the sub-bank layout), the grid
builders and the per-store serial oracle all run in numpy on both sides,
so the port must reproduce the JAX package's bytes exactly. Keys hold
each package's own ``ContentionParams`` / ``DirectoryParams`` classes,
so row maps are compared through ``repr``.
"""

import dataclasses

import pytest

from repro.core import contention as JC
from repro.core import scenarios as JSc
from repro.core import simulator as JS
from repro_torch.core import contention as TC
from repro_torch.core import scenarios as TSc
from repro_torch.core import simulator as TS

N = 1000

GRIDS = {
    "fig10": dict(),
    "contention": dict(workloads=("ycsb", "canneal"),
                       configs=("wb", "baseline", "proactive"),
                       conflict_rate=(None, 0.2), read_share=(None, 0.6),
                       consistency_schedule=(None, "epoch")),
    "directory": dict(workloads=("barnes", "ycsb"),
                      configs=("baseline", "parallel", "proactive"),
                      n_cns=(16, 4), directory_load=(None, 0.0, 0.4)),
}


def fields(r):
    return tuple(getattr(r, f.name) for f in dataclasses.fields(r)
                 if f.name != "meta")


def same_bytes(a, b):
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


def same_bank(t, j):
    return (all(same_bytes(getattr(t, c), getattr(j, c))
                for c in ("arrivals", "w", "v", "pr_nc"))
            and repr(list(t.trace_row.items()))
            == repr(list(j.trace_row.items()))
            and repr(list(t.wv_row.items())) == repr(list(j.wv_row.items())))


@pytest.mark.parametrize("seed", [0, 3])
def test_synthesize_trace_bytes(seed):
    for w in TS.WORKLOADS:
        t = TS.synthesize_trace(TS.WORKLOADS[w], N, seed, TS.PAPER_CLUSTER)
        j = JS.synthesize_trace(JS.WORKLOADS[w], N, seed, JS.PAPER_CLUSTER)
        assert t.keys() == j.keys()
        for k in t:
            assert same_bytes(t[k], j[k]), (w, k)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_bank_and_wv_rows_bytes(grid):
    specs_t = TSc.sweep_grid(**GRIDS[grid])
    specs_j = JSc.sweep_grid(**GRIDS[grid])
    assert repr(specs_t) == repr(specs_j)
    tb = TS.get_trace_bank(specs_t, N)
    jb = JS.get_trace_bank(specs_j, N)
    assert same_bank(tb, jb)
    for tk, jk in zip(list(tb.wv_row)[:12], list(jb.wv_row)[:12]):
        for x, y in zip(TS._make_wv_row(tk, N, TS.PAPER_CLUSTER),
                        JS._make_wv_row(jk, N, JS.PAPER_CLUSTER)):
            assert same_bytes(x, y), tk


def test_extend_and_journal_match_from_scratch():
    base_kw = dict(workloads=("ycsb", "barnes"), configs=("wb", "proactive"))
    delta_kw = dict(workloads=("ycsb", "canneal"),
                    configs=("proactive", "parallel"), n_replicas=(2,))
    tbase = TSc.sweep_grid(**base_kw)
    tdelta = TSc.grid_delta(tbase, **delta_kw)
    jbase = JSc.sweep_grid(**base_kw)
    jdelta = JSc.grid_delta(jbase, **delta_kw)
    assert repr(tdelta) == repr(jdelta)

    tb = TS._make_trace_bank(tuple(tbase), N, TS.PAPER_CLUSTER)
    tb.enable_journal()
    t0, p0 = tb.trace_rows, tb.wv_rows
    assert tb.extend(tdelta) == (1, len(tb.wv_row) - p0)
    assert tb.extend(tdelta) == (0, 0)
    assert same_bank(tb, TS.get_trace_bank(tbase + tdelta, N))
    jb = JS._make_trace_bank(tuple(jbase), N, JS.PAPER_CLUSTER)
    jb.extend(jdelta)
    assert same_bank(tb, jb)
    replay = tb.replay_journal()
    assert same_bytes(replay["arrivals"], tb.arrivals[t0:])
    assert same_bytes(replay["w"], tb.w[p0:])
    tb.ack_journal()
    assert tb.journal_entries == 0


@pytest.mark.parametrize("n_shards,k", [(1, 1), (3, 1), (3, 2)])
def test_sub_bank_host_layout(n_shards, k):
    specs_t = TSc.sweep_grid(**GRIDS["contention"])
    specs_j = JSc.sweep_grid(**GRIDS["contention"])
    t = TS.get_trace_bank(specs_t, N).sub_bank_host(n_shards, k)
    j = JS.get_trace_bank(specs_j, N).sub_bank_host(n_shards, k)
    assert all(same_bytes(x, y) for x, y in zip(t, j))


def test_device_args_cpu_placement_and_diff_upload():
    specs = TSc.sweep_grid(workloads=("ycsb",), configs=("wb", "proactive"))
    bank = TS._make_trace_bank(tuple(specs), N, TS.PAPER_CLUSTER)
    nbytes, cols = bank.device_args(device="cpu")
    assert nbytes == bank.nbytes
    assert [str(c.dtype) for c in cols] == ["torch.float32"] * 3 \
        + ["torch.bool"]
    assert bank.device_args(device="cpu")[0] == 0
    bank.extend(TSc.sweep_grid(workloads=("canneal",), configs=("wb",)))
    diff, cols = bank.device_args(device="cpu")
    assert diff == N * 4              # one new arrivals row, no new wv row
    assert same_bytes(cols[0].numpy(), bank.arrivals)


def test_mega_grid_pins_without_rows():
    specs_t = TSc.mega_grid()
    specs_j = JSc.mega_grid()
    assert len(specs_t) == 12_960 and repr(specs_t) == repr(specs_j)
    tr, wv = TS.bank_row_maps(specs_t)
    assert (len(tr), len(wv)) == (27, 1298)
    jtr, jwv = JS.bank_row_maps(specs_j)
    assert repr(list(wv.items())) == repr(list(jwv.items()))
    lanes = {(s.sb_size,) + TS._plane_keys(s, TS.PAPER_CLUSTER)
             for s in specs_t}
    assert len(lanes) == 2700


@pytest.mark.parametrize("builder", [
    "fig10_grid", "fig16_grid", "fig17_grid", "fig18_grid", "chaos_grid",
    "contention_grid", "contention_mega_grid", "directory_mega_grid"])
def test_grid_builders_identical(builder):
    assert repr(getattr(TSc, builder)()) == repr(getattr(JSc, builder)())


@pytest.mark.parametrize("spec_kw", [
    dict(workload="ycsb", config="proactive"),
    dict(workload="canneal", config="baseline", sb_size=7, n_replicas=2),
    dict(workload="barnes", config="proactive", conflict_rate=0.2,
         read_share=0.6, consistency_schedule="epoch"),
    dict(workload="ocean_cp", config="parallel", directory_load=0.4,
         n_cns=4),
])
def test_serial_oracle_matches_jax_and_batch(spec_kw):
    n = 400
    t = TC.serial_oracle(TS.ScenarioSpec(**spec_kw), n_stores=n)
    j = JC.serial_oracle(JS.ScenarioSpec(**spec_kw), n_stores=n)
    assert fields(t) == fields(j)
    batch = TS.simulate_batch([TS.ScenarioSpec(**spec_kw)], n_stores=n,
                              device="cpu")
    assert fields(batch[0]) == fields(t)
