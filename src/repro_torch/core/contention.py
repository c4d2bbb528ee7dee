"""Directory-contention & crash-consistency scenario axes (beyond-paper).

The paper's slowdown model (Figs. 10/16-18) lets every store's coherence
transaction proceed *uncontended*: the RFO wins ownership on the first
try and no other node holds the line. Real shared-memory workloads
stress the same directory/fabric that ReCXL's replication messages
ride: "Enabling Efficient Transaction Processing on CXL-Based Memory
Sharing" (arXiv:2502.11046) shows directory conflict rates dominate
OLTP-style behaviour, and "CXL Shared Memory Programming"
(arXiv:2405.19626) shows the read/write interleaving -- what a crash
can expose -- changes recovery-relevant state. This module makes both
first-class, batched scenario axes on top of the existing engines:

* ``conflict_rate`` -- fraction of remote stores that hit a *directory
  conflict* (another writer raced them to the line). Conflicts cluster
  in hot-spot episodes, modeled exactly like PR 1's trace synthesis: a
  two-state Markov chain over stores materialized as alternating
  geometric run lengths (:func:`conflict_draws` -- no per-store Python
  loops). A conflicted store retries its ownership acquisition; the
  retry count is geometric (each attempt re-races the conflictors), and
  every failed attempt costs a directory round trip.

* ``read_share`` -- how read-heavy the interleaved access mix is.
  Reads create Shared copies at peer CNs, so a store to a read-shared
  line must invalidate the sharers before it owns the line: per
  contended store, a sharer census is drawn from the cluster peer pool
  and each sharer adds a serialized invalidation leg at the directory.

* ``consistency_schedule`` -- where the software places persist
  ordering points (the crash-consistency discipline of 2405.19626):
  ``"lazy"`` (no ordering -- the paper's implicit schedule; maximal
  crash exposure), ``"epoch"`` (a persist barrier every
  :data:`EPOCH_LEN` stores), ``"eager"`` (every store is an ordering
  point). Barriers stall the commit pipeline for the durable-media
  persist latency, and -- the flip side -- shrink the dirty state a
  crash can expose (:func:`dirty_line_scale` /
  :func:`undumped_log_scale` feed the SS VII-E recovery-time model).

The delays are **collapsed into the existing per-store cost arrays**
(:func:`contention_arrays` returns per-store ``(delay_ns, flush_ns)``
rows; ``simulator._make_cell_arrays`` adds ``delay`` to the exposed
coherence latency and ``flush`` to the REPL-ack / drain-service terms),
so the max-plus recurrence ``c_i = max(r_i + w_i, c_{i-1} + v_i)`` is
extended without touching a single scan kernel: a contended store's
ready time absorbs the conflict backoff through ``w_i``, persist
barriers ride ``v_i``, and the banked data plane / scan-lane dedup /
streaming mega-grid engine work unchanged (the contention parameters
become a new component of the bank's max-plus row key -- see
``simulator._plane_keys``). WB/WT commit locally without a directory
transaction on the modeled path, so their constant bank rows stay
constant and contention-axis slowdowns normalize against an unchanged
WB baseline.

Semantics contract: with every axis ``None`` the subsystem is inert --
bit-identical outputs AND unchanged bank dedup keys (no row churn on
legacy grids). With axes *set to their neutral values* (``0.0``,
``0.0``, ``"lazy"``) the delays are exactly zero, so outputs equal the
uncontended ones bit-for-bit while the dedup key (and therefore the
bank row) differs -- the natural in-grid normalization cell.

:func:`serial_oracle` is the differential-testing reference for the new
semantics: a pure-Python per-store loop (numpy f32 scalar arithmetic --
IEEE add/max are exactly defined, so Python and XLA produce identical
bits) applying the *pre-collapse* commit rules of ``simulator
._timeline``. ``tests/test_contention.py`` pins oracle == serial jax ==
blocked == banked == streaming with ``==``, the same discipline as
``simulate()``.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.configs.recxl_paper import ClusterConfig, PAPER_CLUSTER
from repro_torch.core.hostcache import BoundedCache

#: Recognised crash-consistency schedules, weakest ordering first.
CONSISTENCY_SCHEDULES = ("lazy", "epoch", "eager")

#: Stores between persist barriers under the ``"epoch"`` schedule.
EPOCH_LEN = 64

#: Mean directory hot-spot episode length, in stores (conflicts cluster:
#: a contended line stays contended for a burst of accesses).
CONFLICT_RUN_LEN = 8.0

#: DEFAULT peer pool that can hold a Shared copy of a line (the paper's
#: 16-CN cluster minus the writer). This is only the *fallback* for a
#: bare :class:`ContentionParams`: the simulator's ``_resolve_coupling``
#: replaces it with the **directory-derived** census
#: (``directory.sharer_pool(n_cns, n_replicas)`` -- the union of the
#: real ``ShardDirectory`` replica peers, never more than ``n_cns - 1``)
#: whenever ``read_share > 0``, and canonicalizes it to 0 when
#: ``read_share == 0`` (the binomial census is identically zero then, so
#: the CN weak-scaling axis keeps sharing bank rows and scan lanes).
#: The old behavior -- Binomial(15, read_share) even on a 4-CN cluster
#: -- overcounted invalidations on small clusters.
SHARER_POOL = 15

#: RNG salt decorrelating conflict draws from the trace synthesis rng
#: (both are seeded from the spec's ``seed``).
_RNG_SALT = 0x5EEDC0F1


@dataclasses.dataclass(frozen=True)
class ContentionParams:
    """Resolved contention axes of one scenario cell.

    ``read_share`` in [0, 1): fraction of the remote mix that is reads
    (drives the sharer census a store must invalidate);
    ``conflict_rate`` in [0, 1): fraction of stores hitting a directory
    conflict; ``schedule`` one of :data:`CONSISTENCY_SCHEDULES`;
    ``sharer_pool`` the peer census the invalidation binomial draws
    from (the simulator canonicalizes it via ``_resolve_coupling``:
    directory-derived when ``read_share > 0``, 0 otherwise).
    Hashable -- used verbatim as the contention component of the bank's
    max-plus row dedup key."""
    read_share: float = 0.0
    conflict_rate: float = 0.0
    schedule: str = "lazy"
    sharer_pool: int = SHARER_POOL


def resolve_contention(read_share: Optional[float],
                       conflict_rate: Optional[float],
                       consistency_schedule: Optional[str]
                       ) -> Optional[ContentionParams]:
    """Resolve the three ``ScenarioSpec`` axes into one params value.

    Returns ``None`` iff all three are ``None`` (contention modeling
    off -- the legacy semantics, with unchanged dedup keys). If ANY
    axis is set, the others default to their neutral values (0.0 /
    ``"lazy"``). Raises ``ValueError`` on out-of-range axes."""
    if read_share is None and conflict_rate is None \
            and consistency_schedule is None:
        return None
    rs = 0.0 if read_share is None else float(read_share)
    cr = 0.0 if conflict_rate is None else float(conflict_rate)
    sched = "lazy" if consistency_schedule is None else consistency_schedule
    if not 0.0 <= rs < 1.0:
        raise ValueError(f"read_share must be in [0, 1), got {rs}")
    if not 0.0 <= cr < 1.0:
        raise ValueError(f"conflict_rate must be in [0, 1), got {cr}")
    if sched not in CONSISTENCY_SCHEDULES:
        raise ValueError(f"unknown consistency_schedule {sched!r} "
                         f"(know {CONSISTENCY_SCHEDULES})")
    return ContentionParams(read_share=rs, conflict_rate=cr, schedule=sched)


# ---------------------------------------------------------------------------
# Sharer / conflict synthesis (vectorized, memoized)
# ---------------------------------------------------------------------------

#: Raw conflict/sharer draws, keyed ``(n_stores, seed, conflict_rate,
#: read_share, pool)`` -- ~8 bytes x n_stores per entry (two int32
#: census columns). The draws do NOT depend on congestion / cluster constants
#: (those scale the delays deterministically afterwards), so one entry
#: serves every N_r/bw knob of a sweep. ``clear_sim_caches`` drops both
#: caches via :func:`clear_contention_caches`.
_DRAW_CACHE = BoundedCache(maxsize=256)
#: Finished per-store ``(delay, flush)`` rows, keyed by the full
#: contention row key -- the contention counterpart of ``_WV_ROW_CACHE``.
_DELAY_CACHE = BoundedCache(maxsize=512)


def clear_contention_caches() -> None:
    """Drop the conflict-draw and delay-row memos (called by
    ``repro.core.simulator.clear_sim_caches``)."""
    _DRAW_CACHE.clear()
    _DELAY_CACHE.clear()


def contention_cache_sizes() -> Tuple[int, int]:
    """(draw entries, delay entries) currently memoized -- test hook."""
    return len(_DRAW_CACHE), len(_DELAY_CACHE)


def _make_conflict_draws(n_stores: int, seed: int, conflict_rate: float,
                         read_share: float,
                         pool: int = SHARER_POOL) -> Dict[str, np.ndarray]:
    """Draw the per-store conflict structure for one trace.

    Same run-length technique as ``simulator.synthesize_trace``:
    conflict episodes are a two-state chain over stores with stationary
    hot fraction ``conflict_rate`` and mean hot run
    :data:`CONFLICT_RUN_LEN`, materialized as alternating geometric run
    lengths + ``np.repeat``. Per store:

    * ``retries`` (i32) -- extra ownership attempts of a conflicted
      store: attempts are geometric (each re-races the conflictors with
      win probability ``1 - conflict_rate``), zero outside episodes;
    * ``sharers`` (i32) -- Shared copies to invalidate before owning
      the line: a Binomial(``pool``, read_share) census -- ``pool`` is
      the resolved sharer pool (directory-derived under
      ``_resolve_coupling``, :data:`SHARER_POOL` for a bare params) --
      zero outside episodes (an uncontended line was prefetched
      exclusive long before the SB head -- Fig. 7).
    """
    rng = np.random.default_rng([_RNG_SALT, seed])
    m = max(n_stores, 1)
    frac = float(np.clip(conflict_rate, 0.0, 0.98))
    if frac <= 0.0:
        hot = np.zeros(m, bool)
    else:
        p_leave_hot = 1.0 / CONFLICT_RUN_LEN
        cold_len = CONFLICT_RUN_LEN * (1.0 - frac) / max(frac, 1e-3)
        p_leave_cold = min(1.0 / max(cold_len, 1.0), 1.0)
        state0 = bool(rng.random() < frac)
        run_hot = rng.geometric(p_leave_hot, m)
        run_cold = rng.geometric(p_leave_cold, m)
        runs = np.empty(2 * m, dtype=np.int64)
        states = np.empty(2 * m, dtype=bool)
        first, second = (run_hot, run_cold) if state0 else (run_cold, run_hot)
        runs[0::2], runs[1::2] = first, second
        states[0::2], states[1::2] = state0, not state0
        k = int(np.searchsorted(np.cumsum(runs), m)) + 1
        hot = np.repeat(states[:k], runs[:k])[:m]

    retries = rng.geometric(max(1.0 - frac, 0.02), m) - 1
    retries = np.where(hot, retries, 0).astype(np.int32)
    sharers = rng.binomial(max(int(pool), 0),
                           np.clip(read_share, 0.0, 1.0), m)
    sharers = np.where(hot, sharers, 0).astype(np.int32)
    return {"retries": retries[:n_stores], "sharers": sharers[:n_stores]}


def conflict_draws(n_stores: int, seed: int, conflict_rate: float,
                   read_share: float,
                   pool: int = SHARER_POOL) -> Dict[str, np.ndarray]:
    """Memoized :func:`_make_conflict_draws` (read-only arrays)."""
    key = (n_stores, seed, conflict_rate, read_share, pool)
    return _DRAW_CACHE.get_or_put(
        key, lambda: _make_conflict_draws(*key))


def schedule_flush_ns(schedule: str, n_stores: int,
                      cluster: ClusterConfig) -> np.ndarray:
    """Per-store persist-barrier stall of a consistency schedule (f32 ns).

    ``"lazy"`` is all zeros (no ordering points); ``"eager"`` persists
    every store to the durable MN tier before the next may commit;
    ``"epoch"`` pays the same persist once per :data:`EPOCH_LEN` stores
    (at the epoch's last store). The stall rides the ``v`` side of the
    max-plus recurrence (REPL-ack / drain service), so barriers
    serialize the commit pipeline exactly as a persist fence would.
    """
    if schedule == "lazy":
        return np.zeros(n_stores, np.float32)
    t_flush = cluster.pmem_lat_ns
    if schedule == "eager":
        return np.full(n_stores, t_flush, np.float32)
    if schedule == "epoch":
        idx = np.arange(n_stores, dtype=np.int64)
        return np.where(idx % EPOCH_LEN == EPOCH_LEN - 1,
                        t_flush, 0.0).astype(np.float32)
    raise ValueError(f"unknown consistency_schedule {schedule!r}")


def _make_contention_arrays(params: ContentionParams, n_stores: int,
                            seed: int, cluster: ClusterConfig,
                            congestion: float
                            ) -> Tuple[np.ndarray, np.ndarray]:
    d = conflict_draws(n_stores, seed, params.conflict_rate,
                       params.read_share, params.sharer_pool)
    # one failed ownership attempt = a directory round trip + the
    # directory's DRAM state access; sharer invalidations serialize at
    # the home directory port (half an RTT each: INV out, ACK back,
    # overlapped across the return legs). Both scale with the same
    # link-congestion factor the base coherence latencies use.
    t_retry = cluster.cxl_rtt_ns + cluster.dram_lat_ns
    t_inval = 0.5 * cluster.cxl_rtt_ns
    delay = (d["retries"] * t_retry + d["sharers"] * t_inval) * congestion
    flush = schedule_flush_ns(params.schedule, n_stores, cluster)
    return delay.astype(np.float32), flush


def contention_arrays(params: ContentionParams, n_stores: int, seed: int,
                      cluster: ClusterConfig, congestion: float
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-store contention rows for one cell: ``(delay_ns, flush_ns)``,
    each ``(n_stores,)`` f32.

    ``delay`` (conflict retry backoff + sharer invalidations) is added
    to the exposed coherence latency -- the store's *ready* time
    absorbs it through the ``w`` side of the max-plus recurrence;
    ``flush`` (persist barriers of the consistency schedule) is added
    to the REPL-ack and drain-service terms -- the ``v`` side. With
    neutral params both rows are exactly zero, so ``x + row == x``
    bit-for-bit and the contended semantics degrade to the paper's.
    Memoized on the full row key (rows recur across every cell sharing
    the reduced derivation knobs)."""
    key = (params, n_stores, seed, cluster, congestion)
    return _DELAY_CACHE.get_or_put(
        key, lambda: _make_contention_arrays(params, n_stores, seed,
                                             cluster, congestion))


# ---------------------------------------------------------------------------
# Crash-exposure coupling into the SS VII-E recovery-time model
# ---------------------------------------------------------------------------

#: Dirty-state scale of each schedule: eager persists promptly (small
#: owned/dirty census at the crash point), epoch bounds it to one
#: epoch, lazy leaves the paper's full exposure.
_DIRTY_SCHED_SCALE = {"eager": 0.6, "epoch": 0.85, "lazy": 1.0}
#: Undumped-log scale: ordering points force the Logging Unit to flush
#: its pending entries at each barrier, so less log awaits replay.
_LOG_SCHED_SCALE = {"eager": 0.25, "epoch": 0.6, "lazy": 1.0}


def dirty_line_scale(params: ContentionParams) -> float:
    """Scale on the failed node's owned/dirty-line census.

    Conflicted ownership ping-pongs lines through the Owned state
    faster than they are written back (more dirty lines per node);
    read-heavy mixes keep more lines in Shared -- clean -- state;
    persist barriers shrink the window. Monotone increasing in
    ``conflict_rate``, decreasing in ``read_share`` and in schedule
    strictness; 1.0 at the neutral params."""
    return ((1.0 + 1.5 * params.conflict_rate)
            * (1.0 - 0.5 * params.read_share)
            * _DIRTY_SCHED_SCALE[params.schedule])


def undumped_log_scale(params: ContentionParams) -> float:
    """Scale on the undumped Logging-Unit volume at the failure point.

    Aborted-then-retried replication attempts of conflicted stores
    leave superseded entries the replay must still walk past; ordering
    points dump pending log early. 1.0 at the neutral params."""
    return (1.0 + 0.5 * params.conflict_rate) \
        * _LOG_SCHED_SCALE[params.schedule]


# ---------------------------------------------------------------------------
# Serial Python oracle for the contended semantics
# ---------------------------------------------------------------------------

def serial_oracle(spec, n_stores: int = 50_000,
                  cluster: ClusterConfig = PAPER_CLUSTER):
    """Differential-testing reference for the contended commit rules.

    A pure-Python per-store loop over the same prepared cell arrays the
    engines consume, applying the PRE-collapse commit rules of
    ``simulator._timeline`` (e.g. proactive
    ``c = max(max(r + t_repl, r + coh), c_prev + svc)``) in numpy f32
    scalar arithmetic -- IEEE add/max are exactly defined, so the loop
    and XLA produce identical bits. It therefore independently
    validates BOTH the contended cost derivation and the max-plus
    collapse the batched/banked engines rely on; every ``SimResult``
    field must match every engine tier ``==``
    (tests/test_contention.py). Returns a ``SimResult`` with
    ``meta={"engine": "contention-oracle"}``.
    """
    from repro_torch.core import simulator as S   # deferred: no import cycle

    spec.validate(cluster)
    trace = S._trace_cached(spec.workload, n_stores, spec.seed, cluster)
    cell = S._prepare_cell(spec, trace, n_stores, cluster)
    costs = S._commit_cost_ns(spec.config, cluster)
    f32 = np.float32
    t_l1, t_wt = f32(costs["t_l1"]), f32(costs["t_wt"])
    a = np.asarray(cell.arrivals, np.float32)
    co = np.asarray(cell.coalesce, bool)
    coh = np.asarray(cell.exposed, np.float32)
    tr = np.asarray(cell.t_repl_i, np.float32)
    sv = np.asarray(cell.svc_i, np.float32)
    cfg = spec.config

    ring = collections.deque([f32(0.0)] * cell.sb_size)
    last = f32(0.0)
    at_head = sb_full = 0
    for i in range(n_stores):
        a_i = a[i]
        oldest = ring[0]
        r = np.maximum(a_i, oldest)
        if oldest > a_i:
            sb_full += 1
        if cfg == "wb":
            c = np.maximum(r, last) + t_l1
        elif cfg == "wt":
            c = np.maximum(r, last) + t_wt
        elif cfg == "baseline":
            extra = t_l1 if co[i] else coh[i] + tr[i]
            c = np.maximum(r, last) + extra
        elif cfg == "parallel":
            extra = t_l1 if co[i] else np.maximum(coh[i], tr[i])
            c = np.maximum(r, last) + extra
        elif cfg == "proactive":
            if co[i]:
                c = np.maximum(r, last) + t_l1
            else:
                c = np.maximum(np.maximum(r + tr[i], r + coh[i]),
                               last + sv[i])
                if r >= last:
                    at_head += 1
        else:
            raise ValueError(cfg)
        ring.popleft()
        ring.append(c)
        last = c
    return S._finish_result(cell, last, at_head, sb_full,
                            meta={"engine": "contention-oracle"})
