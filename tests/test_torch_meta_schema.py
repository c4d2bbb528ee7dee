"""``SimResult.meta`` provenance schema of the port, pinned across every
tier it has -- the twin of ``tests/test_meta_schema.py``.

Any result must say where it came from: ``meta["engine"]``,
``meta["data_plane"]`` and ``meta["bank_partition"]`` are always
present, with the values the JAX package's tiers report for the same
grid. The sharded tier (more than one shard) and the serving daemon are
not ported yet (ROADMAP.md), so their rows of the reference test have no
twin here.
"""

import dataclasses

import pytest

from repro.core import engine as JE
from repro.core import simulator as JS
from repro_torch.core import engine as TE
from repro_torch.core.scenarios import sweep_grid
from repro_torch.core.simulator import simulate, simulate_batch

N = 500
CPU = "cpu"
GRID = sweep_grid(workloads=("ycsb",), configs=("wb", "proactive"),
                  sb_sizes=(None, 48))
JGRID = [JS.ScenarioSpec(**dataclasses.asdict(s)) for s in GRID]


def _serial():
    return ([simulate("ycsb", "wb", n_stores=N, device=CPU).meta],
            [JS.simulate("ycsb", "wb", n_stores=N).meta])


def _blocked_bank():
    return ([r.meta for r in simulate_batch(GRID, n_stores=N, device=CPU)],
            [r.meta for r in JS.simulate_batch(JGRID, n_stores=N)])


def _blocked_stacked():
    return ([r.meta for r in simulate_batch(GRID, n_stores=N,
                                            data_plane="stacked",
                                            device=CPU)],
            [r.meta for r in JS.simulate_batch(JGRID, n_stores=N,
                                               data_plane="stacked")])


def _perstep():
    return ([r.meta for r in simulate_batch(GRID, n_stores=N, chunk_size=0,
                                            device=CPU)],
            [r.meta for r in JS.simulate_batch(JGRID, n_stores=N,
                                               chunk_size=0)])


def _streamed():
    return ([r.meta for r in TE.run_grid(GRID, n_stores=N, device=CPU)],
            [r.meta for r in JE.run_grid(JGRID, n_stores=N, n_shards=1)])


TIERS = {
    "serial": (_serial, "serial", "stacked", None),
    "blocked-bank": (_blocked_bank, "blocked", "bank", None),
    "blocked-stacked": (_blocked_stacked, "blocked", "stacked", None),
    "perstep": (_perstep, "perstep", "stacked", None),
    "streamed": (_streamed, "streamed", "bank", "sub"),
}


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_meta_provenance_schema(tier):
    run, engine, plane, partition = TIERS[tier]
    metas, _ = run()
    assert metas, tier
    for m in metas:
        assert m is not None, tier
        # the three provenance keys are unconditionally present
        for key in ("engine", "data_plane", "bank_partition"):
            assert key in m, (tier, key, sorted(m))
        assert m["engine"] == engine, (tier, m)
        assert m["data_plane"] == plane, (tier, m)
        assert m["bank_partition"] == partition, (tier, m)


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_meta_keys_and_values_equal_jax(tier):
    """Every key the JAX tier reports, with its value (the port reports
    no key the JAX tier lacks)."""
    metas, jax_metas = TIERS[tier][0]()
    assert len(metas) == len(jax_metas)
    for m, j in zip(metas, jax_metas):
        assert m == j, (tier, m, j)


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_meta_is_per_result_not_aliased(tier):
    """Annotating one result's meta must not leak into its batch
    siblings (frozen dataclass, mutable dict -- aliasing would)."""
    metas, _ = TIERS[tier][0]()
    if len(metas) < 2:
        pytest.skip("single-result tier")
    metas[0]["__scratch__"] = 1
    assert "__scratch__" not in metas[1]
