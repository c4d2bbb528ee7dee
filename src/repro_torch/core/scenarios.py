"""Sweep grids, recovery-time sweeps and fault scenarios of the port.

The JAX package's ``core/scenarios.py``, in three parts:

* **Sweep scenarios** -- grids of
  :class:`~repro_torch.core.simulator.ScenarioSpec` cells over the
  paper's sensitivity space (Figs. 10/16/17/18, the mega-grid, and the
  contention and directory grids), identical cell for cell, and
  :func:`run_sweep`, which runs one on the right engine tier.
* **Recovery-time sweeps** -- the SS VII-E downtime model batched over
  a (workload x failure-time x node-count) grid (:func:`recovery_sweep`)
  and one cell of it (:func:`downtime_query`).
* **Fault scenarios** -- end-to-end resilience runs (Fig. 9): steps
  replicate state through the
  :class:`~repro_torch.core.replication.ReplicationEngine` into the
  replicas' log rings, a :class:`FailureInjector` schedule fails nodes,
  and recovery replay (``recover_node``, Algorithms 1-2) repairs
  directory + memory before the run resumes. :func:`run_fault_scenario`
  returns a checkable :class:`ScenarioOutcome` whose invariants (replay
  idempotence, no directory reference to a failed node, exact shard
  recovery) and SS VII-E downtime estimates match the JAX package's.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.config import ReplicationConfig
from repro_torch.configs.recxl_paper import (
    PAPER_CLUSTER,
    WORKLOADS,
    ClusterConfig,
)
from repro_torch.core.directory import ShardDirectory, ShardState
from repro_torch.core.failures import (FailureDetector, FailureEvent,
                                       FailureInjector)
from repro_torch.core.protocol import MsgType
from repro_torch.core.recovery import (
    DEFAULT_RECOVERY_PARAMS,
    RecoveryEstimate,
    RecoveryResult,
    RecoveryTimeParams,
    estimate_recovery_time,
    recover_node,
    recovery_time_batch,
    reassemble_shard,
    workload_recovery_inputs,
)
from repro_torch.core.replication import ReplicationEngine
from repro_torch.core.simulator import (
    CONFIGS,
    ScenarioSpec,
    SimResult,
    TraceBank,
    get_trace_bank,
)
from repro_torch.distributed.context import P, make_context


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
    through -- ``n_shards`` and ``devices`` (one placement per shard,
    :func:`~repro_torch.distributed.context.cells_devices`) reach the
    streaming tier; below it the one-shot batch runs on one device.
    ``device=None`` means CUDA (raises without one). Results are in
    ``specs`` order and ``==`` across tiers.

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


# ---------------------------------------------------------------------------
# Recovery-time sweeps: downtime over a failure-time x node grid (SS VII-E)
# ---------------------------------------------------------------------------


#: Default failure times as fractions of the Logging-Unit dump interval
#: (just after a dump, mid-interval, just before the next dump).
DEFAULT_FAIL_FRACS = (0.1, 0.5, 0.9)


@dataclasses.dataclass(frozen=True)
class RecoverySweep:
    """Batched downtime estimates over a (workload x failure-time x
    node-count) grid.

    ``total_ns`` and every phase/volume array in ``components`` have
    shape ``(len(workloads), len(fail_times_ms), len(cn_counts))``;
    times are ns, ``replay_bytes`` is bytes (f32 host arrays).
    """
    workloads: Tuple[str, ...]
    fail_times_ms: Tuple[float, ...]
    cn_counts: Tuple[int, ...]
    total_ns: np.ndarray
    components: Dict[str, np.ndarray]

    def total_ms(self, workload: str, fail_time_ms: float,
                 n_cns: int) -> float:
        """Downtime of one grid cell in milliseconds."""
        w = self.workloads.index(workload)
        t = self.fail_times_ms.index(fail_time_ms)
        c = self.cn_counts.index(n_cns)
        return float(self.total_ns[w, t, c]) / 1e6


def recovery_sweep(workloads: Sequence[str] = tuple(WORKLOADS),
                   fail_times_ms: Optional[Sequence[float]] = None,
                   cn_counts: Sequence[int] = (4, 8, 16),
                   link_bw_gbps: Optional[float] = None,
                   cluster: ClusterConfig = PAPER_CLUSTER,
                   params: RecoveryTimeParams = DEFAULT_RECOVERY_PARAMS,
                   read_share: Optional[float] = None,
                   conflict_rate: Optional[float] = None,
                   consistency_schedule: Optional[str] = None,
                   directory_load: Optional[float] = None,
                   device=None) -> RecoverySweep:
    """Sweep the SS VII-E downtime model over a (workload x
    failure-time x node-count) grid in one batched evaluation on
    ``device`` (``None`` means CUDA, and raises without a card).

    ``fail_times_ms`` defaults to :data:`DEFAULT_FAIL_FRACS` fractions
    of the dump interval. ``link_bw_gbps`` (GB/s) defaults to the
    cluster link. The contention axes (all-``None`` = off) scale the
    crash-exposed volumes; ``directory_load`` (``None`` = off) dilates
    the directory-walk phase per CN count.
    """
    from repro_torch.core.contention import resolve_contention
    from repro_torch.core.directory import (directory_service_scale,
                                            resolve_directory_load)

    contention = resolve_contention(read_share, conflict_rate,
                                    consistency_schedule)
    bw = cluster.cxl_link_bw_gbps if link_bw_gbps is None else link_bw_gbps
    if bw <= 0.0:
        raise ValueError(f"link_bw_gbps must be > 0, got {bw}")
    if fail_times_ms is None:
        fail_times_ms = tuple(round(f * cluster.dump_period_ms, 6)
                              for f in DEFAULT_FAIL_FRACS)
    workloads = tuple(workloads)
    fail_times_ms = tuple(fail_times_ms)
    cn_counts = tuple(cn_counts)
    shape = (len(workloads), len(fail_times_ms), len(cn_counts))
    owned = np.empty(shape, np.float64)
    undumped = np.empty(shape, np.float64)
    for iw, wname in enumerate(workloads):
        for it, t_ms in enumerate(fail_times_ms):
            for ic, ncn in enumerate(cn_counts):
                owned[iw, it, ic], undumped[iw, it, ic] = \
                    workload_recovery_inputs(wname, t_ms, cluster=cluster,
                                             n_cns=ncn, params=params,
                                             contention=contention)
    # the raw load is range-checked once up front, before the loop
    resolve_directory_load(directory_load, cluster.n_cns,
                           cluster.n_replicas)
    dir_scale = np.asarray(
        [directory_service_scale(resolve_directory_load(
            directory_load, ncn, cluster.n_replicas))
         for ncn in cn_counts], np.float64)
    out = recovery_time_batch(owned, undumped, np.full(shape, bw),
                              dir_service_scale=dir_scale,
                              cluster=cluster, params=params, device=device)
    comps = {k: v.cpu().numpy() for k, v in out.items()}
    return RecoverySweep(workloads=workloads, fail_times_ms=fail_times_ms,
                         cn_counts=cn_counts, total_ns=comps.pop("total_ns"),
                         components=comps)


def downtime_query(workload: str, fail_time_ms: float,
                   n_cns: Optional[int] = None,
                   n_replicas: Optional[int] = None,
                   link_bw_gbps: Optional[float] = None,
                   cluster: ClusterConfig = PAPER_CLUSTER,
                   params: RecoveryTimeParams = DEFAULT_RECOVERY_PARAMS,
                   read_share: Optional[float] = None,
                   conflict_rate: Optional[float] = None,
                   consistency_schedule: Optional[str] = None,
                   directory_load: Optional[float] = None
                   ) -> RecoveryEstimate:
    """One "what's my downtime if ..." cell of the SS VII-E model,
    closed-form on the host: the single-cell counterpart of
    :func:`recovery_sweep`, with the same contention scaling and
    ``directory_load`` dilation. ``None`` knobs resolve to the
    ``cluster`` defaults."""
    from repro_torch.core.contention import resolve_contention
    from repro_torch.core.directory import (directory_service_scale,
                                            resolve_directory_load)

    contention = resolve_contention(read_share, conflict_rate,
                                    consistency_schedule)
    ncn = cluster.n_cns if n_cns is None else n_cns
    nr = cluster.n_replicas if n_replicas is None else n_replicas
    owned, undumped = workload_recovery_inputs(
        workload, fail_time_ms, cluster=cluster, n_cns=ncn, n_replicas=nr,
        params=params, contention=contention)
    scale = directory_service_scale(
        resolve_directory_load(directory_load, ncn, nr))
    return estimate_recovery_time(owned, undumped, cluster=cluster,
                                  link_bw_gbps=link_bw_gbps, params=params,
                                  dir_service_scale=scale)


# ---------------------------------------------------------------------------
# Fault scenarios: fail node f at step s -> replay -> consistent -> resume
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultScenario:
    """One enumerable end-to-end resilience run.

    The contention axes (``None`` = off) describe the workload regime
    the failed node was running: they scale the crash-exposed volumes
    feeding each event's downtime estimate. ``directory_load`` (``None``
    = off) dilates the directory-walk phase of each estimate."""
    name: str
    events: Tuple[FailureEvent, ...]
    n_nodes: int = 4
    n_steps: int = 6
    variant: str = "proactive"       # baseline | parallel | proactive
    coalescing: bool = False
    n_replicas: int = 2
    n_buckets: int = 2
    log_capacity: int = 3
    read_share: Optional[float] = None
    conflict_rate: Optional[float] = None
    consistency_schedule: Optional[str] = None
    directory_load: Optional[float] = None

    def contention(self):
        """Resolved :class:`~repro_torch.core.contention.ContentionParams`
        (``None`` when every axis is off)."""
        from repro_torch.core.contention import resolve_contention
        return resolve_contention(self.read_share, self.conflict_rate,
                                  self.consistency_schedule)

    def directory(self):
        """Resolved :class:`~repro_torch.core.directory.DirectoryParams`
        (``None`` when the coupling axis is off)."""
        from repro_torch.core.directory import resolve_directory_load
        return resolve_directory_load(self.directory_load, self.n_nodes,
                                      self.n_replicas)

    def validate(self) -> None:
        if self.variant not in ("baseline", "parallel", "proactive"):
            raise ValueError(f"unknown variant {self.variant!r}")
        if self.n_replicas >= self.n_nodes:
            raise ValueError("n_replicas must be < n_nodes")
        for ev in self.events:
            if not 0 <= ev.node < self.n_nodes:
                raise ValueError(f"event node {ev.node} outside mesh")
        self.contention()        # raises on out-of-range contention axes
        self.directory()         # raises on out-of-range directory_load


@dataclasses.dataclass
class RecoveryCheck:
    """Invariants computed for one fail-stop event's recovery replay."""
    node: int
    step: int
    exact: bool                      # recovered shard == live truth
    newest_ts: int                   # newest recovered logical timestamp
    replay_idempotent: bool          # second replay = identical result
    directory_consistent: bool       # no reference to any failed node
    unrecoverable: int
    downtime: Optional[RecoveryEstimate] = None  # SS VII-E estimate (ns)

    @property
    def downtime_ns(self) -> float:
        """Estimated downtime of this event in ns (0.0 if unmodeled)."""
        return self.downtime.total_ns if self.downtime is not None else 0.0


@dataclasses.dataclass
class ScenarioOutcome:
    scenario: FaultScenario
    steps_run: int
    failed_nodes: Tuple[int, ...]
    stragglers: Dict[int, float]
    checks: List[RecoveryCheck]
    directory: ShardDirectory
    resumed: bool                    # live nodes kept stepping to the end

    @property
    def all_invariants_hold(self) -> bool:
        return all(c.exact and c.replay_idempotent and
                   c.directory_consistent and c.unrecoverable == 0
                   for c in self.checks)

    @property
    def total_downtime_ns(self) -> float:
        """Summed downtime estimate over every recovery event (ns)."""
        return sum(c.downtime_ns for c in self.checks)


def estimate_scenario_downtime(engine: ReplicationEngine,
                               result: RecoveryResult,
                               cluster: ClusterConfig = PAPER_CLUSTER,
                               params: RecoveryTimeParams =
                               DEFAULT_RECOVERY_PARAMS,
                               contention=None,
                               directory=None) -> RecoveryEstimate:
    """Downtime estimate for one executed recovery replay, fed by the
    volumes the replay *actually* moved.

    ``owned_lines`` is the owned-entry census from Algorithm 1, with the
    payload ("line") size set to the engine's bucket footprint in bytes;
    the undumped log volume is the number of log versions Algorithm 2
    walked (the FetchLatestVersResp message log records them), also at
    bucket granularity. ``contention`` scales both volumes,
    ``directory`` dilates the directory-walk phase. Times are ns.
    """
    from repro_torch.core.contention import (dirty_line_scale,
                                             undumped_log_scale)
    from repro_torch.core.directory import directory_service_scale

    itemsize = torch.empty((), dtype=engine.log_dtype).element_size()
    bucket_bytes = engine.layout.bucket_len * itemsize
    n_versions = sum(m[1].get("n_versions", 0) for m in result.message_log
                     if m[0] == MsgType.FETCH_LATEST_VERS_RESP)
    p = dataclasses.replace(params, line_bytes=bucket_bytes,
                            log_entry_bytes=float(
                                bucket_bytes + params.header_bytes))
    owned = float(result.stats.owned_entries)
    undumped = n_versions * p.log_entry_bytes
    if contention is not None:
        owned *= dirty_line_scale(contention)
        undumped *= undumped_log_scale(contention)
    return estimate_recovery_time(
        owned_lines=owned, undumped_log_bytes=undumped,
        cluster=cluster, params=p,
        dir_service_scale=directory_service_scale(directory))


def enumerate_fault_scenarios(n_nodes: int = 4, n_steps: int = 6,
                              variants: Sequence[str] = ("baseline",
                                                         "parallel",
                                                         "proactive"),
                              ) -> List[FaultScenario]:
    """The canonical single- and double-failure schedule grid."""
    out: List[FaultScenario] = []
    for v in variants:
        for step in range(1, n_steps - 1):
            for node in range(n_nodes):
                out.append(FaultScenario(
                    name=f"{v}/fail-n{node}@s{step}",
                    events=(FailureEvent(step=step, node=node),),
                    n_nodes=n_nodes, n_steps=n_steps, variant=v))
        out.append(FaultScenario(
            name=f"{v}/double-failure",
            events=(FailureEvent(step=1, node=0),
                    FailureEvent(step=n_steps - 2, node=n_nodes - 1)),
            n_nodes=n_nodes, n_steps=n_steps, variant=v))
    return out


def directory_references(directory: ShardDirectory,
                         failed: Set[int]) -> bool:
    """True iff the directory still references any failed node: as a
    live replica holder anywhere, or as a still-OWNED owner."""
    for (_, _), e in directory.entries.items():
        if any(f in e.replicas for f in failed):
            return True
        if e.owner in failed and e.state == ShardState.OWNED:
            return True
    return False


def _scenario_params(scn: FaultScenario, device: torch.device
                     ) -> Tuple[Dict, Dict]:
    """The scenario's state, bit for bit the JAX package's: ``scale`` is
    built in f32 on the host the way ``jnp.linspace`` builds it
    (``start * (1 - t) + stop * t``, ``t = i / 5``), because
    ``torch.linspace`` differs from it in the last bit of three of the
    six values."""
    rows = 2 * scn.n_nodes
    t = np.arange(5, dtype=np.float32) / np.float32(5)
    scale = np.append(np.float32(0.5) * (np.float32(1) - t)
                      + np.float32(1.5) * t, np.float32(1.5))
    params = {
        "w": torch.arange(rows * 4, dtype=torch.float32,
                          device=device).reshape(rows, 4) * 0.25,
        "scale": torch.from_numpy(scale.astype(np.float32)).to(device),
    }
    specs = {"w": P("data", None), "scale": P(None)}
    return params, specs


def _step_update(x: torch.Tensor) -> torch.Tensor:
    """``x * 1.125 + 0.5`` rounded once, as XLA computes it (it contracts
    the product and the sum into one FMA): the product of an f32 and
    1.125 is exact in f64, so the f64 sum rounded to f32 is the FMA's
    result (for |x| < 2**50, far above the scenario's values)."""
    return (x.double() * 1.125 + 0.5).float()


def _node_truth(engine: ReplicationEngine, params: Dict,
                node: int) -> Dict[str, torch.Tensor]:
    """The failed node's true local shard of the live global state."""
    w = params["w"]
    rows = w.shape[0] // engine.n_nodes
    return {"w": w[rows * node:rows * (node + 1)], "scale": params["scale"]}


def _replay(engine: ReplicationEngine, logs, directory_blob: str,
            scn: FaultScenario, node: int) -> Tuple[RecoveryResult,
                                                    ShardDirectory]:
    d = ShardDirectory.from_json(directory_blob, scn.n_nodes,
                                 engine.layout.n_buckets, scn.n_replicas)
    return recover_node(engine, logs, d, failed_coord=(node,)), d


def _same_shards(a: RecoveryResult, b: RecoveryResult) -> bool:
    return set(a.shards) == set(b.shards) and all(
        a.shards[k].ts == b.shards[k].ts
        and torch.equal(a.shards[k].values, b.shards[k].values)
        for k in a.shards)


def run_fault_scenario(scn: FaultScenario, device=None) -> ScenarioOutcome:
    """Execute one fault scenario end-to-end (Fig. 9 sequence) on
    ``device`` (``None`` means CUDA, and raises without a card).

    Steps replicate state; at each injected fail-stop the detector sets
    the viral bit, recovery replays the surviving Logging-Unit logs, the
    repaired shard is checked against the live truth, and the run
    resumes on the remaining schedule. Every :class:`RecoveryCheck` in
    the outcome carries a SS VII-E downtime estimate
    (:func:`estimate_scenario_downtime`, ns) fed by the volumes that
    replay actually moved. The ``scn.n_nodes`` nodes are the leading
    dimension of the tensors on one device.
    """
    scn.validate()
    ctx = make_context((scn.n_nodes,), ("data",), device=device)
    params, specs = _scenario_params(scn, ctx.device)
    rep = ReplicationConfig(variant=scn.variant, n_replicas=scn.n_replicas,
                            n_buckets=scn.n_buckets,
                            log_capacity=scn.log_capacity,
                            coalescing=scn.coalescing, log_dtype="float32")
    engine = ReplicationEngine(rep, ctx, specs, params)
    logs = engine.init_logs()
    directory = ShardDirectory(scn.n_nodes, engine.layout.n_buckets,
                               scn.n_replicas)
    detector = FailureDetector(scn.n_nodes, lease_s=1e9)
    injector = FailureInjector(scn.events)

    checks: List[RecoveryCheck] = []
    failed: Set[int] = set()
    for t in range(scn.n_steps):
        params = {k: _step_update(x) for k, x in params.items()}
        logs, params = engine.replicate(params, logs, t, params)
        if not failed:
            # failed owners must stay UNOWNED: only record cluster-wide
            # commits while the directory is undamaged
            directory.record_commit(t)
        for ev in injector.poll(t):
            if ev.kind == "straggler":
                detector.mark_straggler(ev.node, ev.delay_s)
                continue
            if ev.node in failed:
                continue
            detector.mark_failed(ev.node)
            failed.add(ev.node)
            # snapshot the pre-repair directory, then replay on the real
            # one and twice more on copies of the snapshot: all three
            # runs must recover identical shards (idempotence)
            blob = directory.to_json()
            res = recover_node(engine, logs, directory,
                               failed_coord=(ev.node,))
            r1, _ = _replay(engine, logs, blob, scn, ev.node)
            r2, _ = _replay(engine, logs, blob, scn, ev.node)
            idem = _same_shards(r1, r2) and _same_shards(r1, res)
            # replaying on the already-repaired directory must be a
            # no-op: every owned entry is UNOWNED, nothing re-fetched
            res_again = recover_node(engine, logs, directory,
                                     failed_coord=(ev.node,))
            idem = idem and not res_again.shards

            exact = res.stats.unrecoverable == 0
            newest = -1
            if exact:
                truth = _node_truth(engine, params, ev.node)
                leaves = reassemble_shard(engine, res)[0]
                got = engine.unflatten(leaves)
                exact = all(
                    torch.allclose(got[k], truth[k], rtol=1e-6, atol=1e-6)
                    for k in truth)
                newest = max(s.ts for s in res.shards.values())
            checks.append(RecoveryCheck(
                node=ev.node, step=t, exact=exact, newest_ts=newest,
                replay_idempotent=idem,
                directory_consistent=not directory_references(
                    directory, failed),
                unrecoverable=res.stats.unrecoverable,
                downtime=estimate_scenario_downtime(
                    engine, res, contention=scn.contention(),
                    directory=scn.directory())))

    return ScenarioOutcome(
        scenario=scn, steps_run=scn.n_steps,
        failed_nodes=tuple(sorted(failed)),
        stragglers=dict(detector.stragglers),
        checks=checks, directory=directory,
        resumed=len(detector.live_nodes) > 0)
