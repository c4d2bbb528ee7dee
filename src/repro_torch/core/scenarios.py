"""The paper's evaluation grids as ScenarioSpec lists, and the sweep entry.

The sweep half of the JAX package's ``core/scenarios.py``: grids of
:class:`~repro_torch.core.simulator.ScenarioSpec` cells over the paper's
sensitivity space (Figs. 10/16/17/18, the mega-grid, and the contention
and directory grids), identical cell for cell, and :func:`run_sweep`,
which runs one on the right engine tier. The fault scenarios and the
SS VII-E recovery sweeps are later slices of the port (ROADMAP.md).
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Sequence

from repro_torch.configs.recxl_paper import (
    PAPER_CLUSTER,
    WORKLOADS,
    ClusterConfig,
)
from repro_torch.core.simulator import (
    CONFIGS,
    ScenarioSpec,
    SimResult,
    TraceBank,
    get_trace_bank,
)


def sweep_grid(workloads: Sequence[str] = tuple(WORKLOADS),
               configs: Sequence[str] = CONFIGS,
               seeds: Sequence[int] = (0,),
               n_replicas: Sequence[Optional[int]] = (None,),
               link_bw_gbps: Sequence[Optional[float]] = (None,),
               n_cns: Sequence[Optional[int]] = (None,),
               sb_sizes: Sequence[Optional[int]] = (None,),
               coalescing: Sequence[bool] = (True,),
               read_share: Sequence[Optional[float]] = (None,),
               conflict_rate: Sequence[Optional[float]] = (None,),
               consistency_schedule: Sequence[Optional[str]] = (None,),
               directory_load: Sequence[Optional[float]] = (None,),
               ) -> List[ScenarioSpec]:
    """Cartesian product of sensitivity knobs as a flat spec list.

    The contention / crash-consistency axes (``read_share``,
    ``conflict_rate``, ``consistency_schedule`` -- see
    docs/contention.md) and the directory-coupling axis
    (``directory_load`` -- the two-level queueing recurrence, see
    docs/simulator.md) default to a single ``None`` value, so every
    pre-existing grid is unchanged cell-for-cell."""
    return [ScenarioSpec(w, c, seed=s, n_replicas=nr, link_bw_gbps=bw,
                         n_cns=ncn, sb_size=sb, coalescing=co,
                         read_share=rs, conflict_rate=cr,
                         consistency_schedule=cs, directory_load=dl)
            for w, c, s, nr, bw, ncn, sb, co, rs, cr, cs, dl
            in itertools.product(
                workloads, configs, seeds, n_replicas, link_bw_gbps,
                n_cns, sb_sizes, coalescing, read_share, conflict_rate,
                consistency_schedule, directory_load)]


def fig10_grid(seeds: Sequence[int] = (0,)) -> List[ScenarioSpec]:
    """All workloads x all five configurations."""
    return sweep_grid(seeds=seeds)


def fig16_grid(bandwidths: Sequence[float] = (160.0, 80.0, 40.0, 20.0),
               workloads: Sequence[str] = ("ycsb", "canneal",
                                           "streamcluster")) -> List[ScenarioSpec]:
    """Link-bandwidth sensitivity (WB vs proactive)."""
    return sweep_grid(workloads=workloads, configs=("wb", "proactive"),
                      link_bw_gbps=bandwidths)


def fig17_grid(replicas: Sequence[int] = (1, 2, 3, 4),
               workloads: Sequence[str] = tuple(WORKLOADS)) -> List[ScenarioSpec]:
    """Replication-factor sensitivity under proactive."""
    return sweep_grid(workloads=workloads, configs=("proactive",),
                      n_replicas=replicas)


def fig18_grid(cn_counts: Sequence[int] = (4, 8, 16),
               workloads: Sequence[str] = ("barnes", "ycsb",
                                           "bodytrack")) -> List[ScenarioSpec]:
    """CN-count weak scaling (WB vs proactive)."""
    return sweep_grid(workloads=workloads, configs=("wb", "proactive"),
                      n_cns=cn_counts)


def mega_grid(seeds: Sequence[int] = (0, 1, 2),
              replicas: Sequence[int] = (1, 2, 3, 4),
              bandwidths: Sequence[float] = (160.0, 80.0, 40.0, 20.0),
              cn_counts: Sequence[int] = (16, 8, 4),
              sb_sizes: Sequence[int] = (72, 48)) -> List[ScenarioSpec]:
    """The full cross-product sensitivity space of Figs. 10/16-18 as one
    grid: (workload x config x seed x N_r x bw x CN x SB). At the
    defaults this is 12 960 cells -- the mega-grid scale the streaming
    engine tier exists for (``fig10/megagrid/*`` bench rows run it)."""
    return sweep_grid(seeds=seeds, n_replicas=replicas,
                      link_bw_gbps=bandwidths, n_cns=cn_counts,
                      sb_sizes=sb_sizes)


def chaos_grid(workloads: Sequence[str] = ("ycsb", "barnes",
                                           "streamcluster"),
               configs: Sequence[str] = ("wb", "proactive"),
               replicas: Sequence[Optional[int]] = (None, 2, 3),
               bandwidths: Sequence[Optional[float]] = (None, 40.0),
               ) -> List[ScenarioSpec]:
    """The fault-injection differential grid (tests/test_chaos.py,
    benchmarks/bench_chaos.py): a small multi-signature sweep -- several
    workloads x configs x sensitivity values so a mid-grid shard loss
    lands between tiles of DIFFERENT compiled signatures -- sized so the
    fault-free oracle plus one run per injected fault stays cheap. The
    grid itself is plain scenarios; the faults come from the JAX
    package's ``chaos.inject`` around the run."""
    return sweep_grid(workloads=workloads, configs=configs,
                      n_replicas=replicas, link_bw_gbps=bandwidths)


def contention_grid(workloads: Sequence[str] = ("ycsb", "canneal",
                                                "streamcluster"),
                    configs: Sequence[str] = ("wb", "proactive"),
                    conflict_rates: Sequence[Optional[float]] =
                    (None, 0.2, 0.5),
                    read_shares: Sequence[Optional[float]] = (None, 0.6),
                    schedules: Sequence[Optional[str]] =
                    (None, "epoch", "eager")) -> List[ScenarioSpec]:
    """Figure-sized contention sweep (the Fig. 17-style sensitivity
    grid for the new axes): contended proactive cells against the
    unchanged WB baseline, with ``None`` axis values mixing legacy
    (axes-off) cells into the same grid for normalization."""
    return sweep_grid(workloads=workloads, configs=configs,
                      conflict_rate=conflict_rates, read_share=read_shares,
                      consistency_schedule=schedules)


def contention_mega_grid(workloads: Sequence[str] = tuple(WORKLOADS),
                         configs: Sequence[str] = ("wb", "proactive"),
                         seeds: Sequence[int] = (0, 1),
                         replicas: Sequence[Optional[int]] = (1, 3),
                         cn_counts: Sequence[Optional[int]] = (16, 8),
                         conflict_rates: Sequence[Optional[float]] =
                         (0.0, 0.2, 0.5),
                         read_shares: Sequence[Optional[float]] =
                         (0.0, 0.6),
                         schedules: Sequence[Optional[str]] =
                         ("lazy", "epoch", "eager")) -> List[ScenarioSpec]:
    """The contention cross-product at streaming-tier scale
    (workload x config x seed x N_r x CN x conflict x read-share x
    schedule -- 2 592 cells at the defaults, >= ``STREAM_THRESHOLD`` so
    ``run_sweep`` picks the banked streaming engine). The neutral
    ``(0.0, 0.0, "lazy")`` cells are bit-identical to the uncontended
    semantics and serve as in-grid normalization; the CN axis exercises
    scan-lane dedup (contention keys deliberately exclude ``n_cns``).
    ``fig17/contention/*`` bench rows run it
    (benchmarks/bench_contention.py)."""
    return sweep_grid(workloads=workloads, configs=configs, seeds=seeds,
                      n_replicas=replicas, n_cns=cn_counts,
                      conflict_rate=conflict_rates, read_share=read_shares,
                      consistency_schedule=schedules)


def directory_mega_grid(workloads: Sequence[str] = tuple(WORKLOADS),
                        configs: Sequence[str] = ("baseline", "parallel",
                                                  "proactive"),
                        seeds: Sequence[int] = (0, 1),
                        replicas: Sequence[Optional[int]] = (1, 3),
                        cn_counts: Sequence[Optional[int]] = (16, 8, 4),
                        loads: Sequence[Optional[float]] =
                        (0.0, 0.2, 0.4, 0.7),
                        sb_sizes: Sequence[Optional[int]] = (72, 48)
                        ) -> List[ScenarioSpec]:
    """The directory-coupling cross-product at streaming-tier scale
    (workload x config x seed x N_r x CN x load x SB -- 2 592 cells at
    the defaults, >= ``STREAM_THRESHOLD``; the 4-CN column exercises
    the clamped directory census). ``directory_load=0.0``
    cells are bit-identical to the axis-off semantics and serve as the
    in-grid normalization baseline of the ``fig17/directory/*``
    slowdown rows; ``baseline`` pays the shard's queueing wait serially
    per store while ``proactive``'s decoupled commit largely hides it
    behind the drain chain -- the capacity-vs-resilience contrast the
    bench reports. The SB and CN axes exercise scan-lane dedup on
    coupled cells (cells sharing a resolved
    :class:`~repro_torch.core.directory.DirectoryParams` + max-plus row are
    one lane). ``fig17/directory/*`` bench rows run it
    (benchmarks/bench_directory.py)."""
    return sweep_grid(workloads=workloads, configs=configs, seeds=seeds,
                      n_replicas=replicas, n_cns=cn_counts,
                      sb_sizes=sb_sizes, directory_load=loads)


def run_sweep(specs: Sequence[ScenarioSpec],
              cluster: ClusterConfig = PAPER_CLUSTER,
              n_stores: int = 50_000,
              engine: str = "auto",
              device=None,
              **engine_kw) -> List[SimResult]:
    """Run a sweep grid on the right engine tier, on ``device``.

    The canonical entry point for every grid this module builds:
    delegates to :func:`repro_torch.core.engine.simulate_grid`, which
    picks the one-shot banked batch for ordinary figure grids and the
    streaming tier for mega-grids (>=
    ``repro_torch.core.engine.STREAM_THRESHOLD`` cells); ``engine=``
    forces a tier and ``engine_kw`` passes tile / data-plane knobs
    through. ``device=None`` means CUDA (raises without one). Results
    are in ``specs`` order and ``==`` across tiers.

    Both tiers resolve the grid's columnar
    :class:`~repro_torch.core.simulator.TraceBank` through one
    digest-keyed memo, so sweeping the same grid through several engines
    (or repeatedly) builds and uploads the bank ONCE -- use
    :func:`grid_bank` to pre-build it explicitly.
    """
    from repro_torch.core.engine import simulate_grid
    return simulate_grid(specs, cluster=cluster, n_stores=n_stores,
                         engine=engine, device=device, **engine_kw)


def grid_bank(specs: Sequence[ScenarioSpec],
              cluster: ClusterConfig = PAPER_CLUSTER,
              n_stores: int = 50_000) -> TraceBank:
    """The memoized columnar trace bank of a sweep grid.

    Thin alias of :func:`repro_torch.core.simulator.get_trace_bank` at
    the sweep-builder level: pre-building the bank before a timed sweep
    moves the one-off column materialization out of the measured path,
    and the returned handle is the SAME object every banked engine tier
    will use (``clear_sim_caches`` drops it)."""
    return get_trace_bank(specs, n_stores, cluster)


def grid_delta(base: Sequence[ScenarioSpec],
               **axes) -> List[ScenarioSpec]:
    """The cells of a sweep that are NOT already in ``base``.

    The query->cell translation for the serving daemon's *grid delta*
    requests ("extend my sweep by these axis values"): ``axes`` are
    :func:`sweep_grid` keyword axes describing the requested
    cross-product, and the return value is its cells minus the ones
    ``base`` already contains, in sweep order. Feeding the result to
    :meth:`~repro_torch.core.simulator.TraceBank.extend` appends only
    the genuinely new bank rows (the incremental-diff upload path);
    ``base + grid_delta(base, **axes)`` is the merged grid whose
    from-scratch bank the extended bank stays byte-identical to.
    """
    have = set(base)
    return [s for s in sweep_grid(**axes) if s not in have]
