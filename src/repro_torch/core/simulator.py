"""Trace-driven ReCXL protocol simulator (paper SS VI-VII), PyTorch port.

The paper evaluates ReCXL with SST + Pin traces of PARSEC / SPLASH-2 /
YCSB on a 16-CN / 16-MN cluster (Table II). This module reproduces that
evaluation with a store-timeline simulator: per application class, a
synthetic remote-store trace (arrival times, coalescability) is pushed
through a store-buffer model that implements the exact commit rules of
the five configurations (Fig. 6):

* WB            c_i = max(r_i, c_{i-1}) + t_l1
* WT            c_i = max(r_i, c_{i-1}) + t_rtt + t_pmem     (TSO serial)
* baseline      c_i = max(r_i, c_{i-1}) + t_coh_exposed + t_repl
* parallel      c_i = max(r_i, c_{i-1}) + max(t_coh_exposed, t_repl)
* proactive     c_i = max(c_{i-1} + t_drain, ack_i, coh_i)
                with ack_i = r_i + t_repl issued at *retire* time

where r_i (retire into SB) stalls when the SB is full:
r_i = max(a_i, c_{i-SB}).

Everything up to the scan runs on the host in numpy, exactly as in the
JAX package: trace synthesis, the per-cell cost derivation (with the
contention and directory axes folded in), and the max-plus collapse of
all five rules into one recurrence ``c_i = max(r_i + w_i, c_{i-1} +
v_i)`` over deduplicated :class:`TraceBank` rows. Keeping that arithmetic
in numpy f32/f64 keeps every input bit-identical to the JAX package's.

The device half has the JAX package's four engines:

* the **serial oracle** (:func:`simulate`, :func:`simulate_spec`): one
  cell, its rule applied as written -- before the collapse -- by the
  hand-written store-timeline kernel
  (:func:`repro_torch.kernels.store_timeline.store_timeline`);
* the **per-step engine** (``simulate_batch(chunk_size=0)``): the
  stacked time-major cells of a grid through the same kernel in its
  per-lane mode, every lane with its own rule and SB depth;
* the **stacked blocked plane** (``simulate_batch(data_plane=
  "stacked")``): the same stacked cells collapsed on the device
  (:func:`_blocked_precompute`, plain torch) and scanned by the
  bank-scan kernel as a cell-major bank, one launch per SB depth;
* the **banked blocked plane** (the default): the bank's four columns
  placed on a torch device once, each scan lane carrying two ``int32``
  row indices, gathered and scanned by
  :func:`repro_torch.kernels.bank_scan.bank_scan`.

Each kernel is the hand-written CUDA kernel for a CUDA tensor and its
plain torch loop for a CPU tensor. All use IEEE add and max only, so
every ``SimResult`` field is ``==`` to the JAX package's, across engines
and planes.

Entry points take ``device=None``, which means CUDA; without a CUDA
device they raise (``device="cpu"`` runs the plain versions).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.recxl_paper import (
    ClusterConfig,
    PAPER_CLUSTER,
    WORKLOADS,
    WorkloadProfile,
)
from repro_torch.core.contention import (
    ContentionParams,
    clear_contention_caches,
    contention_arrays,
    resolve_contention,
)
from repro_torch.core.directory import (
    DirectoryParams,
    resolve_directory_load,
    sharer_pool,
)
from repro_torch.core.hostcache import BoundedCache
from repro_torch.core import telemetry as _tm
from repro_torch.device import resolve_device
from repro_torch.kernels.bank_scan import bank_scan
from repro_torch.kernels.store_timeline import (store_timeline,
                                                store_timeline_batch)


CONFIGS = ("wb", "wt", "baseline", "parallel", "proactive")
_CONFIG_IDX = {c: i for i, c in enumerate(CONFIGS)}
_REPLICATING = ("baseline", "parallel", "proactive")


@dataclasses.dataclass(frozen=True)
class SimResult:
    """Per-cell simulation outputs (one store-buffer timeline).

    Field units: ``exec_time_ns`` ns (commit time of the last store,
    work-scaled for CN-count sweeps); ``max_log_bytes`` bytes (per CN
    per dump period, Fig. 13); ``*_bw_gbps`` GB/s cluster-wide (Fig.
    14); ``repl_at_head_frac`` / ``sb_full_frac`` are fractions of
    ``n_stores`` in [0, 1].
    """
    workload: str
    config: str
    exec_time_ns: float              # ns
    n_stores: int
    n_repl_msgs: int                 # REPL messages after coalescing
    repl_at_head_frac: float         # Fig. 11: REPLs issued at SB head
    max_log_bytes: float             # Fig. 13: bytes/CN/dump period
    cxl_mem_bw_gbps: float           # Fig. 14: memory traffic (GB/s)
    log_dump_bw_gbps: float          # Fig. 14: log dump traffic (GB/s)
    sb_full_frac: float              # stores that stalled on a full SB
    #: Engine metadata (not part of the simulated physics): which engine
    #: produced the cell, the blocked-scan ``chunk`` actually used (the
    #: auto heuristic's pick when ``chunk_size=None``), tile/shard info
    #: from the streaming tier. Excluded from equality comparisons.
    meta: Optional[Dict[str, object]] = dataclasses.field(
        default=None, compare=False)


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One cell of an evaluation grid (Figs. 10-18 sensitivity space).

    ``None`` knobs resolve to the ClusterConfig defaults at simulation
    time, so a spec is portable across cluster configs. Knob units:
    ``n_replicas`` peer replicas (Fig. 17), ``link_bw_gbps`` CXL link
    bandwidth in GB/s (Fig. 16), ``n_cns`` compute nodes (Fig. 18),
    ``sb_size`` store-buffer entries, ``coalescing`` enables same-line
    SB coalescing (Fig. 12).

    Contention / crash-consistency axes (``repro_torch.core.contention``;
    docs/contention.md): ``read_share`` fraction of the remote mix that
    is reads (sharer census, [0, 1)), ``conflict_rate`` fraction of
    stores hitting a directory conflict ([0, 1)),
    ``consistency_schedule`` persist-ordering discipline (``"lazy"`` /
    ``"epoch"`` / ``"eager"``). All three default to ``None`` --
    contention modeling off, outputs and bank dedup keys unchanged; if
    any is set, the others resolve to their neutral values.

    ``directory_load`` ([0, 1) or ``None``) is the queueing-coupled
    directory axis (``repro_torch.core.directory``): the offered utilization
    each sharer contributes to the cell's shared ``ShardDirectory``
    shard, folded into the max-plus ``w`` side per directory epoch by
    the level-2 recurrence. ``None`` = coupling off (bit-identical
    outputs and keys); ``0.0`` = the in-grid normalization cell (zero
    delays, own bank row).
    """
    workload: str
    config: str
    seed: int = 0
    n_replicas: Optional[int] = None
    link_bw_gbps: Optional[float] = None
    n_cns: Optional[int] = None
    sb_size: Optional[int] = None
    coalescing: bool = True
    read_share: Optional[float] = None
    conflict_rate: Optional[float] = None
    consistency_schedule: Optional[str] = None
    directory_load: Optional[float] = None

    def contention(self) -> Optional[ContentionParams]:
        """The cell's resolved contention params (``None`` = axes off;
        raises ``ValueError`` on out-of-range axes)."""
        return resolve_contention(self.read_share, self.conflict_rate,
                                  self.consistency_schedule)

    def validate(self, cluster: ClusterConfig) -> None:
        if self.config not in CONFIGS:
            raise ValueError(f"unknown config {self.config!r}")
        if self.workload not in WORKLOADS:
            raise ValueError(f"unknown workload {self.workload!r}")
        sb = self.sb_size if self.sb_size is not None else cluster.store_buffer
        if sb < 1:
            raise ValueError(f"sb_size must be >= 1, got {sb}")
        nr = self.n_replicas if self.n_replicas is not None else cluster.n_replicas
        if nr < 1:
            raise ValueError(f"n_replicas must be >= 1, got {nr}")
        ncn = self.n_cns if self.n_cns is not None else cluster.n_cns
        if ncn < 1:
            raise ValueError(f"n_cns must be >= 1, got {ncn}")
        bw = self.link_bw_gbps if self.link_bw_gbps is not None \
            else cluster.cxl_link_bw_gbps
        if bw <= 0.0:
            raise ValueError(f"link_bw_gbps must be > 0, got {bw}")
        self.contention()        # raises on out-of-range contention axes
        resolve_directory_load(self.directory_load, ncn, nr)


# ---------------------------------------------------------------------------
# Trace synthesis (fully vectorized -- no per-store Python loops)
# ---------------------------------------------------------------------------

def synthesize_trace(wl: WorkloadProfile, n_stores: int, seed: int,
                     cluster: ClusterConfig) -> Dict[str, np.ndarray]:
    """Synthesize one deterministic remote-store trace.

    Returns per-store arrays, each of shape ``(n_stores,)``:

    * ``gaps``        -- inter-arrival gap to the previous store (ns, f32)
    * ``arrivals``    -- absolute arrival time ``cumsum(gaps)`` (ns, f32;
      a single host-side ``np.cumsum`` shared by the serial oracle and
      every engine tier, so all consume bit-identical inputs)
    * ``coalesce``    -- store coalesces with the previous SB entry (bool)
    * ``in_burst``    -- store is inside a flush burst (bool)
    * ``burst_pos``   -- index distance into the current burst (f32)
    * ``exposed_coh`` -- coherence latency still exposed at the SB head
      after the exclusive prefetch (ns, f32)

    Arrivals follow a two-state Markov burst process: inside a store
    burst (flush phases of the SPMD apps) gaps are ~1 cycle and runs are
    ``burst_len`` stores long on average; between bursts, exponential
    compute gaps keep the trace-wide mean store rate at the profile's
    value. Burst runs longer than the SB depth are what separate
    ReCXL-proactive from ReCXL-parallel (Fig. 8): only there does commit
    latency back-pressure the core.

    The chain is materialized by its run-length representation: burst /
    calm run lengths are geometric (exactly the two-state chain's
    sojourn distribution), drawn for the whole trace at once and
    expanded with ``np.repeat`` -- there is no per-store Python loop, so
    a batch of traces costs a handful of array ops per cell.
    """
    rng = np.random.default_rng(seed)
    ipc = 2.0
    ns_per_instr = 1.0 / (ipc * cluster.cpu_freq_ghz)
    instr_per_store = 1000.0 / wl.remote_store_rate
    mean_gap = instr_per_store * ns_per_instr

    # two-state Markov chain over stores, as alternating geometric runs
    burst_len = max(wl.burst_len, 1.0)
    p_leave_burst = 1.0 / burst_len
    frac = np.clip(wl.burstiness, 0.0, 0.98)     # fraction of stores in bursts
    calm_len = burst_len * (1.0 - frac) / max(frac, 1e-3)
    p_leave_calm = min(1.0 / max(calm_len, 1.0), 1.0)
    state0 = bool(rng.random() < frac)
    # each run is >= 1 store, so n_stores runs of each state always cover
    # the trace; trim to the first run crossing n_stores before expanding.
    m = max(n_stores, 1)
    run_burst = rng.geometric(p_leave_burst, m)
    run_calm = rng.geometric(p_leave_calm, m)
    runs = np.empty(2 * m, dtype=np.int64)
    states = np.empty(2 * m, dtype=bool)
    first, second = (run_burst, run_calm) if state0 else (run_calm, run_burst)
    runs[0::2], runs[1::2] = first, second
    states[0::2], states[1::2] = state0, not state0
    k = int(np.searchsorted(np.cumsum(runs), n_stores)) + 1
    in_burst = np.repeat(states[:k], runs[:k])[:n_stores]

    burst_gap = cluster.cycle_ns
    n_burst = int(in_burst.sum())
    n_calm = n_stores - n_burst
    calm_gap = ((mean_gap * n_stores - burst_gap * n_burst)
                / max(n_calm, 1))
    calm_gap = max(calm_gap, burst_gap)
    gaps = np.where(in_burst, burst_gap,
                    rng.exponential(calm_gap, n_stores))

    # position within the current burst (Logging-Unit backlog ramps with
    # it): index distance to the latest calm store at or before i.
    idx = np.arange(n_stores, dtype=np.int64)
    last_calm = np.maximum.accumulate(np.where(~in_burst, idx, -1))
    pos = np.where(in_burst, idx - last_calm, 0).astype(np.float32)

    coalesce = rng.random(n_stores) < wl.coalesce_rate

    # Exposed coherence at the SB head: the exclusive prefetch is issued
    # at address resolution, so by SB-head time the RFO has almost always
    # completed (the paper's explanation for parallel ~= baseline). A
    # small tail of stores (conflicted / Shared-elsewhere lines) exposes
    # part of the round trip.
    base_rtt = cluster.cxl_rtt_ns + cluster.dram_lat_ns
    tail = rng.random(n_stores) < 0.12
    exposed = np.where(tail, rng.exponential(0.15 * base_rtt, n_stores), 0.0)

    gaps32 = gaps.astype(np.float32)
    return {"gaps": gaps32,
            "arrivals": np.cumsum(gaps32, dtype=np.float32),
            "coalesce": coalesce,
            "in_burst": in_burst,
            "burst_pos": pos,
            "exposed_coh": exposed.astype(np.float32)}


@functools.lru_cache(maxsize=64)
def _trace_cached(workload: str, n_stores: int, seed: int,
                  cluster: ClusterConfig) -> Dict[str, np.ndarray]:
    """Memoized :func:`synthesize_trace` (traces are deterministic in
    the key, and sweeps re-scan the same trace for many cells and many
    calls). Callers must treat the arrays as read-only."""
    return synthesize_trace(WORKLOADS[workload], n_stores, seed, cluster)


# ---------------------------------------------------------------------------
# Host-side memoization (bounded, hash-keyed, centrally clearable)
# ---------------------------------------------------------------------------

#: The shared cache primitive (repro_torch.core.hostcache -- contention.py
#: uses the same class for its memos without an import cycle).
_BoundedCache = BoundedCache


#: Reduced-key per-store array derivations (see :func:`_cell_arrays`).
_CELL_ARRAY_CACHE = _BoundedCache(maxsize=512)
#: Stacked batch inputs on a device (see :func:`_batch_inputs`): each
#: entry pins full per-cell array copies, so the bound is small.
_BATCH_INPUT_CACHE = _BoundedCache(maxsize=4)
#: Precollapsed max-plus rows (see :func:`_wv_row`): one ``(w, v,
#: pr_nc)`` triple per unique row key, ~9 bytes x n_stores each.
_WV_ROW_CACHE = _BoundedCache(maxsize=1024)
#: Whole-grid columnar banks (see :func:`get_trace_bank`). One mega-grid
#: bank is a few hundred MB of host columns plus its device placements,
#: so at most two stay alive.
_BANK_CACHE = _BoundedCache(maxsize=2)
#: Banked per-batch index vectors + prepared cells (entries are tiny).
_BANKED_INPUT_CACHE = _BoundedCache(maxsize=8)

_CACHE_CLEARERS: List[Callable[[], None]] = []


def register_cache_clearer(fn: Callable[[], None]) -> Callable[[], None]:
    """Register a cache-dropping callback with :func:`clear_sim_caches`
    (the streaming engine registers its compiled-tile cache here, so one
    call resets every layer without import cycles)."""
    _CACHE_CLEARERS.append(fn)
    return fn


def clear_sim_caches() -> None:
    """Drop every host-side simulator memo: synthesized traces, reduced-
    key cell arrays, stacked batch inputs, max-plus rows, banks with
    their device placements, banked batch inputs, and any registered
    engine caches (the
    streaming engine's tile programs). Benchmarks call this
    between engines so no engine's timing rides on caches another
    engine warmed; long-lived processes can call it to release pinned
    memory after a mega-grid sweep."""
    _trace_cached.cache_clear()
    _CELL_ARRAY_CACHE.clear()
    _BATCH_INPUT_CACHE.clear()
    _WV_ROW_CACHE.clear()
    _BANK_CACHE.clear()       # drops host columns AND device placements
    _BANKED_INPUT_CACHE.clear()
    clear_contention_caches()   # conflict draws + delay rows
    for fn in list(_CACHE_CLEARERS):
        fn()


# ---------------------------------------------------------------------------
# Per-cell cost derivation (shared by the serial and batched paths)
# ---------------------------------------------------------------------------

def _commit_cost_ns(config: str, cluster: ClusterConfig) -> Dict[str, float]:
    rtt = cluster.cxl_rtt_ns
    return {
        "t_l1": cluster.cycle_ns * 2.0,
        "t_wt": rtt + cluster.pmem_lat_ns,
        # REPL->ACK round trip to peer CNs + SRAM log write at the replica.
        # N_r REPLs go out in parallel; ack time = slowest ~ one RTT + log.
        "t_repl": rtt + cluster.sram_log_lat_ns,
        # VAL is one-way, off the commit path
        "t_drain": cluster.cycle_ns,
    }


@dataclasses.dataclass
class _CellInputs:
    """Everything the timeline and result assembly need for one cell."""
    spec: ScenarioSpec
    n_stores: int
    sb_size: int
    config_idx: int
    work_scale: float
    # per-store timeline inputs, each (n_stores,)
    arrivals: np.ndarray
    coalesce: np.ndarray
    exposed: np.ndarray
    t_repl_i: np.ndarray
    svc_i: np.ndarray
    # derived bandwidth / log metrics (timeline-independent)
    n_repl_msgs: int
    max_log_bytes: float
    cxl_mem_bw_gbps: float
    log_dump_bw_gbps: float
    # background utilization of this cell's shared directory shard
    # (DirectoryParams.rho_bg; 0.0 with the directory axis off) --
    # surfaced as the paper-facing queue-occupancy telemetry counter
    dir_occupancy: float = 0.0


@dataclasses.dataclass(frozen=True)
class _CellArrays:
    """Heavy per-store derivations shared across grid cells (read-only)."""
    coalesce: np.ndarray             # (n_stores,) bool
    exposed: np.ndarray              # (n_stores,) f32 ns
    t_repl_i: np.ndarray             # (n_stores,) f32 ns
    svc_i: np.ndarray                # (n_stores,) f32 ns
    n_coalesced: int
    store_rate_per_core: float       # stores/s/core
    mem_demand: float                # GB/s per CN


def _directory_delay_row(arrivals: np.ndarray, tx_mask: np.ndarray,
                         dirp: DirectoryParams, cluster: ClusterConfig,
                         congestion: float) -> np.ndarray:
    """Level-2 recurrence: per-store directory-queue delay (f32 ns).

    Stores are grouped into ``dirp.epoch``-long directory epochs on the
    arrival clock. Per epoch ``e`` the shared shard sees

    * ``own_e``  -- this cell's offered service: its directory
      transactions (the non-coalesced stores) times the directory's
      DRAM state-access service time, spread over the node's
      ``dirp.buckets`` shards (each shard serves 1/buckets of the
      node's lines);
    * ``bg_e``   -- the sharer pool's background utilization
      ``rho_bg * span_e``;

    and carries the Lindley backlog ``q_e = max(q_{e-1} + own_e + bg_e
    - span_e, 0)`` -- the service-rate recurrence the per-store
    max-plus recurrence nests inside. Every directory-transacting
    store of epoch ``e`` then waits the backlog carried INTO the epoch
    plus the M/D/1 in-epoch queueing wait ``rho * s / (2 (1 - rho))``,
    scaled by the cell's link-congestion factor like every other
    latency. Host numpy (f64 recurrence, f32 result): the delays are
    folded into the ``w`` side before the collapse, so no scan kernel
    changes. Exactly all-zero when ``rho_bg == 0`` (the load-0
    normalization cell); monotone in ``rho_bg``.
    """
    n = int(arrivals.shape[0])
    if dirp.rho_bg <= 0.0 or n == 0:
        return np.zeros(n, np.float32)
    e_len = int(dirp.epoch)
    a = np.asarray(arrivals, np.float64)
    starts = a[::e_len]
    ends = np.concatenate([starts[1:], a[-1:] + cluster.cycle_ns])
    span = np.maximum(ends - starts, cluster.cycle_ns)
    tx = np.add.reduceat(np.asarray(tx_mask, np.float64),
                         np.arange(0, n, e_len))
    s_dir = float(cluster.dram_lat_ns)
    own = tx * s_dir / dirp.buckets
    bg = float(dirp.rho_bg) * span
    x = own + bg - span
    cs = np.cumsum(x)
    backlog = cs - np.minimum(np.minimum.accumulate(cs), 0.0)
    b_prev = np.concatenate([[0.0], backlog[:-1]])
    rho = np.minimum((own + bg) / span, 0.95)
    wq = rho * s_dir / (2.0 * (1.0 - rho))
    d_e = (b_prev + wq) * congestion
    delay = np.repeat(d_e, e_len)[:n]
    return np.where(tx_mask, delay, 0.0).astype(np.float32)


def _make_cell_arrays(workload: str, n_stores: int, seed: int,
                      cluster: ClusterConfig, nr: int, bw: float,
                      replicating: bool, coalesce_on: bool,
                      contention: Optional[ContentionParams] = None,
                      directory: Optional[DirectoryParams] = None
                      ) -> _CellArrays:
    wl = WORKLOADS[workload]
    trace = _trace_cached(workload, n_stores, seed, cluster)
    costs = _commit_cost_ns("proactive", cluster)   # config-independent

    # --- replication fan-out cost scaling -------------------------------
    # N_r REPLs leave in parallel but share the CN's CXL port: serialization
    # grows mildly with N_r; congestion scales latencies when offered load
    # nears the link bandwidth (Fig. 16/17 behaviour).
    repl_bytes = 8 + 64  # header + payload (coalesced line worst case)
    mean_gap = float(np.mean(trace["gaps"]))
    store_rate_per_core = 1e9 / max(mean_gap, 1e-3)          # stores/s/core
    cores = cluster.cores_per_cn
    repl_demand = store_rate_per_core * cores * nr * repl_bytes / 1e9  # GB/s
    mem_bytes = 64 + 16
    read_rate = (wl.remote_read_rate / wl.remote_store_rate) * store_rate_per_core
    mem_demand = (store_rate_per_core + read_rate) * cores * mem_bytes / 1e9
    total_demand = mem_demand + (repl_demand if replicating else 0.0)
    congestion = max(1.0, total_demand / bw)
    port_serial = 1.0 + 0.08 * (nr - 1)

    coalesce = trace["coalesce"] if coalesce_on else \
        np.zeros_like(trace["coalesce"])
    exposed = trace["exposed_coh"] * congestion

    # Per-store REPL latency: inflated inside cluster-wide bursts (the
    # SPMD apps' flush phases align across CNs, so every Logging Unit is
    # absorbing its peers' REPL streams at once). The ACK backlog ramps
    # with position in the burst, capped when the SRAM Log Buffer
    # backpressures into DRAM-speed handling; the *sustained* drain floor
    # is the DRAM-log write path (~2 DRAM accesses per entry), which is
    # what bounds ReCXL-proactive during long flushes.
    svc_entry_ns = 2.0 * (1e3 / cluster.logging_unit_freq_mhz)  # SRAM path
    # saturated drain: log-entry write + log-metadata RMW at DRAM speed
    dram_svc_ns = 4.0 * cluster.dram_lat_ns
    qslope = (svc_entry_ns * cores * nr * (1.0 - wl.coalesce_rate)
              - cluster.cycle_ns)
    qcap = 195.0                 # SRAM buffer backpressure bound (ns)
    queue_i = np.minimum(trace["burst_pos"] * max(qslope, 0.0), qcap) \
        * trace["in_burst"] * congestion
    t_repl_base = costs["t_repl"] * congestion * port_serial
    t_repl_i = t_repl_base + queue_i
    # commit-drain service floor inside bursts (proactive path)
    svc_floor = dram_svc_ns * (1.0 - wl.coalesce_rate) * congestion \
        * (1.0 + 0.1 * (nr - cluster.n_replicas))
    svc_i = np.where(trace["in_burst"], svc_floor,
                     costs["t_drain"]).astype(np.float32)

    if contention is not None:
        # conflict backoff + sharer invalidations delay the coherence
        # transaction (the store's ready time absorbs them through the
        # exposed latency -> the w side of the max-plus recurrence);
        # persist barriers ride the REPL-ack and drain-service terms
        # (the v side). Neutral params yield all-zero rows, so x + 0.0
        # keeps every output bit-identical to the uncontended cell.
        delay, flush = contention_arrays(contention, n_stores, seed,
                                         cluster, congestion)
        exposed = exposed + delay
        t_repl_i = t_repl_i + flush
        svc_i = (svc_i + flush).astype(np.float32)

    if directory is not None:
        # the level-2 (per-epoch service-rate) recurrence: the shared
        # directory shard's queueing delay rides the w side exactly
        # like the contention backoff -- zero rows at load 0, so the
        # normalization cell stays bit-identical to the axis-off cell.
        dir_delay = _directory_delay_row(
            np.asarray(trace["arrivals"], np.float32),
            ~np.asarray(coalesce, bool), directory, cluster, congestion)
        exposed = exposed + dir_delay

    return _CellArrays(
        coalesce=np.asarray(coalesce, bool),
        exposed=np.asarray(exposed, np.float32),
        t_repl_i=np.asarray(t_repl_i, np.float32),
        svc_i=svc_i,
        n_coalesced=int(coalesce.sum()),
        store_rate_per_core=store_rate_per_core,
        mem_demand=mem_demand,
    )


def _cell_arrays(workload: str, n_stores: int, seed: int,
                 cluster: ClusterConfig, nr: int, bw: float,
                 replicating: bool, coalesce_on: bool,
                 contention: Optional[ContentionParams] = None,
                 directory: Optional[DirectoryParams] = None
                 ) -> _CellArrays:
    """Memoized :func:`_make_cell_arrays` on the *reduced* key.

    The per-store arrays depend on the spec only through ``(workload,
    seed, n_replicas, link_bw, replicating-config?, coalescing
    effective?, contention, directory)`` -- NOT on ``config`` itself
    (beyond the replicating / wt-coalescing classes), ``sb_size`` or
    ``n_cns`` (the directory coupling sees the CN count only through
    the already-resolved :class:`DirectoryParams`). On a mega-grid
    whose axes include config/SB/CN sweeps, one derivation therefore
    serves many cells; the bound (:data:`_CELL_ARRAY_CACHE`) keeps
    pinned host memory at ~16 bytes x n_stores per entry."""
    key = (workload, n_stores, seed, cluster, nr, bw, replicating,
           coalesce_on, contention, directory)
    return _CELL_ARRAY_CACHE.get_or_put(
        key, lambda: _make_cell_arrays(*key))


def _resolve_coupling(spec: ScenarioSpec, cluster: ClusterConfig
                      ) -> Tuple[Optional[ContentionParams],
                                 Optional[DirectoryParams]]:
    """Resolve one cell's shared-resource coupling, canonically.

    The SINGLE resolution point for both the per-store data
    (:func:`_prepare_cell`) and the dedup keys (:func:`_plane_keys`),
    so the two cannot drift. Returns ``(contention, directory)``:

    * WB/WT commit locally without a directory transaction, so both
      components are ``None`` (their constant bank rows survive any
      coupling axis);
    * active contention gets the **directory-derived** sharer census:
      ``sharer_pool(n_cns, n_replicas)`` when ``read_share > 0`` (the
      small-cluster overcount bugfix -- never more than ``n_cns - 1``
      peers), canonical 0 when ``read_share == 0`` (the census is
      identically zero either way, so the CN weak-scaling axis keeps
      sharing lanes);
    * ``directory_load`` resolves through
      :func:`~repro_torch.core.directory.resolve_directory_load`.
    """
    if spec.config not in _REPLICATING:
        return None, None
    nr = cluster.n_replicas if spec.n_replicas is None else spec.n_replicas
    ncn = cluster.n_cns if spec.n_cns is None else spec.n_cns
    con = spec.contention()
    if con is not None:
        pool = sharer_pool(ncn, nr) if con.read_share > 0.0 else 0
        if pool != con.sharer_pool:
            con = dataclasses.replace(con, sharer_pool=pool)
    dirp = resolve_directory_load(spec.directory_load, ncn, nr)
    return con, dirp


# ---------------------------------------------------------------------------
# Columnar trace bank (deduplicated data plane)
# ---------------------------------------------------------------------------

def _plane_keys(spec: ScenarioSpec, cluster: ClusterConfig
                ) -> Tuple[tuple, tuple]:
    """The two dedup keys of one cell's per-store inputs.

    ``trace_key`` selects the arrivals column (identical across every
    cell that scans the same trace); ``wv_key`` selects the
    precollapsed max-plus ``(w, v, pr_nc)`` column. WB/WT rows are
    constants (``t_l1`` / ``t_wt`` everywhere -- they commit locally
    without a directory transaction, so contention never touches them),
    so their key is just the rule name; the replicating rules depend on
    the reduced derivation knobs but NOT on ``sb_size`` / ``n_cns`` --
    the same reduction :func:`_cell_arrays` exploits, now visible to
    the device data plane. Active coupling axes append their resolved
    params (via :func:`_resolve_coupling`) in fixed order --
    :class:`ContentionParams` first, then
    :class:`~repro_torch.core.directory.DirectoryParams` -- so coupled cells
    sharing a (shard, epoch-profile) still dedup to one row / lane;
    all-``None`` axes append NOTHING, so legacy grids keep
    byte-identical keys (and therefore identical bank rows -- no dedup
    churn)."""
    trace_key = (spec.workload, spec.seed)
    if spec.config in ("wb", "wt"):
        return trace_key, (spec.config,)
    nr = cluster.n_replicas if spec.n_replicas is None else spec.n_replicas
    bw = cluster.cxl_link_bw_gbps if spec.link_bw_gbps is None \
        else spec.link_bw_gbps
    wv_key = (spec.config, spec.workload, spec.seed, nr, bw,
              spec.coalescing)
    con, dirp = _resolve_coupling(spec, cluster)
    if con is not None:
        wv_key = wv_key + (con,)
    if dirp is not None:
        wv_key = wv_key + (dirp,)
    return trace_key, wv_key


def sub_bank_rows(rows: int, n_shards: int) -> int:
    """Local (per-shard) row count of a ``rows``-row wv plane
    partitioned round-robin over ``n_shards`` sub-banks: global row
    ``r`` is owned by shard ``r % n_shards`` at local row
    ``r // n_shards``, so the widest shard holds ``ceil(rows /
    n_shards)`` rows (floored at 1 so an empty or tiny plane still
    yields a valid gather target at local row 0). The ownership rule is
    a pure function of the global row index, so the append-only
    :meth:`TraceBank.extend` contract carries over: appending global
    rows only ever APPENDS to each shard's local sub-bank, never
    reshuffles it."""
    return max(1, -(-rows // n_shards))


def _make_wv_row(wv_key: tuple, n_stores: int, cluster: ClusterConfig
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One precollapsed max-plus column: the JAX package's
    ``_blocked_precompute`` on the host, for a single unique row.

    f32 add / maximum / select are exactly-defined IEEE ops, so this
    numpy collapse gives the bits the per-cell rules would -- once per
    unique row instead of once per cell. Returns ``(w, v, pr_nc)``, each ``(n_stores,)`` (f32, f32,
    bool)."""
    costs = _commit_cost_ns("proactive", cluster)
    t_l1 = np.float32(costs["t_l1"])
    t_wt = np.float32(costs["t_wt"])
    config = wv_key[0]
    if config in ("wb", "wt"):
        w = np.full(n_stores, t_l1 if config == "wb" else t_wt, np.float32)
        return w, w, np.zeros(n_stores, bool)
    _, workload, seed, nr, bw, coalescing = wv_key[:6]
    # trailing coupling components are typed, not positional: a key may
    # carry contention, directory params, both (contention first), or
    # neither -- see _plane_keys
    con = dirp = None
    for extra in wv_key[6:]:
        if isinstance(extra, ContentionParams):
            con = extra
        elif isinstance(extra, DirectoryParams):
            dirp = extra
    arr = _cell_arrays(workload, n_stores, seed, cluster, nr, bw, True,
                       coalescing, contention=con, directory=dirp)
    if config == "baseline":
        w = np.where(arr.coalesce, t_l1, arr.exposed + arr.t_repl_i)
        return w, w, np.zeros(n_stores, bool)
    if config == "parallel":
        w = np.where(arr.coalesce, t_l1,
                     np.maximum(arr.exposed, arr.t_repl_i))
        return w, w, np.zeros(n_stores, bool)
    if config == "proactive":
        pr_nc = ~arr.coalesce
        w = np.where(pr_nc, np.maximum(arr.t_repl_i, arr.exposed), t_l1)
        v = np.where(pr_nc, arr.svc_i, t_l1)
        return w, v, pr_nc
    raise ValueError(config)


def _wv_row(wv_key: tuple, n_stores: int, cluster: ClusterConfig):
    """Memoized :func:`_make_wv_row` (rows recur across banks and across
    engines sweeping the same grid)."""
    return _WV_ROW_CACHE.get_or_put(
        (wv_key, n_stores, cluster),
        lambda: _make_wv_row(wv_key, n_stores, cluster))


def _place(host: tuple, device: torch.device) -> tuple:
    """Host numpy columns as torch tensors on ``device`` (a CPU
    placement shares the host memory; a CUDA one is one copy each)."""
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                 for x in host)


def _place_own(host: tuple, device: torch.device) -> tuple:
    """Host numpy arrays as tensors on ``device`` that own their memory,
    even on the CPU: placements of one layout never alias each other or
    the host columns, so losing (freeing, poisoning) one placement
    touches nothing else."""
    return tuple(torch.from_numpy(np.ascontiguousarray(x))
                 .to(device, copy=True) for x in host)


def placement_key(device) -> object:
    """Memo-key component of a placement: one device (or a one-entry
    sequence) keys as its name, several placements as the tuple of
    theirs -- so the layouts of one bank over one card and over several
    placements (even repeated ones) never collide."""
    if isinstance(device, (tuple, list)):
        if len(device) == 1:
            return str(device[0])
        return tuple(str(d) for d in device)
    return str(device)


def columns_key(device) -> tuple:
    """Placement-memo key of a bank's plain columns on ``device`` (one
    device, or a tuple of placements)."""
    return ("columns", placement_key(device))


def sub_key(n_shards: int, k_replicas: int, device) -> tuple:
    """Placement-memo key of a bank's sub-bank stacks on ``device`` (one
    device, or a tuple of placements)."""
    return ("sub", n_shards, k_replicas, placement_key(device))


def fill_sub_shard(out: np.ndarray, col: np.ndarray, shard: int,
                   n_shards: int, k_replicas: int, cap: int,
                   primary: Optional[np.ndarray] = None) -> np.ndarray:
    """Write shard ``shard``'s local axis of the sub-bank layout into
    ``out`` (``(k_replicas * cap, ...)``, zeroed): block ``j`` (local
    rows ``[j * cap, (j + 1) * cap)``) holds the rows of ``col`` owned
    by shard ``(shard - j) % n_shards``, i.e. ``col[(shard - j) %
    n_shards::n_shards]``, from its start. ``primary`` replaces block
    0's rows (the same rows, e.g. read back from a surviving replica and
    digest-verified). Returns ``out``. The layout is the JAX package's
    ``TraceBank.sub_bank_host`` (``src/repro/core/simulator.py:915``)."""
    for j in range(k_replicas):
        rows = primary if j == 0 and primary is not None \
            else col[(shard - j) % n_shards::n_shards]
        out[j * cap:j * cap + rows.shape[0]] = rows
    return out


@dataclasses.dataclass
class TraceBank:
    """Columnar, deduplicated per-store inputs for one grid.

    Rows are **store-contiguous** (``(rows, n_stores)``, C-contiguous):
    each scan lane walks one arrivals row and one max-plus row in store
    order. ``arrivals[trace_row[k]]`` is the arrivals row
    of trace key ``k``; ``w / v / pr_nc[wv_row[k]]`` the precollapsed
    max-plus row of row key ``k``. Host rows are built once per grid
    (memoized by :func:`get_trace_bank`) and placed on device at most
    once per placement key (:meth:`device_args`);
    :func:`clear_sim_caches` drops both.

    Banks are **append-only**: :meth:`extend` adds the rows of new
    specs in first-seen order -- exactly the order a from-scratch build
    of the merged grid would assign -- so an extended bank is
    byte-identical to :func:`get_trace_bank` of the concatenated spec
    list (tests/test_trace_bank.py pins this), existing row indices
    stay valid forever, and :meth:`device_args` uploads only the
    **diff** (the appended rows) for placements that already hold the
    old rows: the marginal H2D cost of a novel query is its new rows,
    not the bank."""
    n_stores: int
    cluster: ClusterConfig
    arrivals: np.ndarray             # (T, n_stores) f32 ns
    w: np.ndarray                    # (P, n_stores) f32 ns
    v: np.ndarray                    # (P, n_stores) f32 ns
    pr_nc: np.ndarray                # (P, n_stores) bool
    trace_row: Dict[tuple, int]
    wv_row: Dict[tuple, int]
    _device: Dict[object, tuple] = dataclasses.field(
        default_factory=dict, repr=False)
    # Logging-Unit journal: un-acknowledged extend() diffs (None = off;
    # see enable_journal / ack_journal / replay_journal below)
    _journal: Optional[List[Dict[str, np.ndarray]]] = dataclasses.field(
        default=None, repr=False)

    @property
    def trace_rows(self) -> int:
        return self.arrivals.shape[0]

    @property
    def wv_rows(self) -> int:
        return self.w.shape[0]

    @property
    def n_rows(self) -> int:
        return self.trace_rows + self.wv_rows

    @property
    def nbytes(self) -> int:
        """Host bytes of all four columns (= H2D bytes of one upload)."""
        return (self.arrivals.nbytes + self.w.nbytes + self.v.nbytes
                + self.pr_nc.nbytes)

    def rows_for(self, spec: ScenarioSpec) -> Tuple[int, int]:
        """(trace_row, wv_row) indices of one cell of the build grid."""
        tk, wk = _plane_keys(spec, self.cluster)
        return self.trace_row[tk], self.wv_row[wk]

    @classmethod
    def from_host_arrays(cls, arrivals: np.ndarray, w: np.ndarray,
                         v: np.ndarray, pr_nc: np.ndarray,
                         trace_row: Dict[tuple, int], wv_row: Dict[tuple, int],
                         n_stores: int,
                         cluster: ClusterConfig = PAPER_CLUSTER
                         ) -> "TraceBank":
        """A bank over given host columns, e.g. the JAX package's bank,
        so that both packages scan the very same rows.

        Columns are copied into C-contiguous arrays of the bank's dtypes
        (f32 / f32 / f32 / bool); the row maps are copied as given.
        Raises ``ValueError`` when the shapes do not form a bank of
        ``n_stores`` stores with one row per map entry."""
        a = np.array(arrivals, np.float32, order="C")
        cols = [np.array(x, dt, order="C")
                for x, dt in ((w, np.float32), (v, np.float32),
                              (pr_nc, bool))]
        if a.ndim != 2 or a.shape != (len(trace_row), n_stores):
            raise ValueError(f"arrivals must be ({len(trace_row)}, "
                             f"{n_stores}), got {a.shape}")
        for name, c in zip(("w", "v", "pr_nc"), cols):
            if c.shape != (len(wv_row), n_stores):
                raise ValueError(f"{name} must be ({len(wv_row)}, "
                                 f"{n_stores}), got {c.shape}")
        return cls(n_stores=n_stores, cluster=cluster, arrivals=a,
                   w=cols[0], v=cols[1], pr_nc=cols[2],
                   trace_row=dict(trace_row), wv_row=dict(wv_row))

    def device_args(self, device=None,
                    on_upload: Optional[Callable[[int], None]] = None
                    ) -> Tuple[int, tuple]:
        """``(arrivals, w, v, pr_nc)`` as torch tensors on ``device``.

        ``device=None`` means CUDA and raises without a CUDA device.
        Placements are memoized per device (key :func:`columns_key`), so
        a grid swept by several engines uploads once. Returns
        ``(bytes_uploaded_now, tensors)`` -- ``bytes_uploaded_now`` is 0
        on a placement-cache hit, which is what the engines'
        ``h2d_bytes`` accounting reports. ``on_upload(nbytes)`` is
        called just before any bytes cross host->device (the engines'
        chaos injection point).

        After :meth:`extend` grew the bank, a resident placement is
        refreshed **incrementally**: only the appended row slices cross
        host->device and are concatenated onto the resident tensors
        device-side, so ``bytes_uploaded_now`` is the diff's bytes, not
        the bank's."""
        dev_key = resolve_device(device)
        mkey = columns_key(dev_key)
        dev = self._device.get(mkey)
        if dev is not None:
            t_res, p_res = int(dev[0].shape[0]), int(dev[1].shape[0])
            if t_res == self.trace_rows and p_res == self.wv_rows:
                return 0, dev
            # diff upload: ship only the rows appended since placement
            host = (self.arrivals[t_res:], self.w[p_res:],
                    self.v[p_res:], self.pr_nc[p_res:])
            if on_upload is not None:
                on_upload(sum(int(x.nbytes) for x in host))
            dev = tuple(torch.cat([d, f], dim=0)
                        for d, f in zip(dev, _place(host, dev_key)))
            self._device[mkey] = dev
            return sum(int(x.nbytes) for x in host), dev
        host = (self.arrivals, self.w, self.v, self.pr_nc)
        if on_upload is not None:
            on_upload(self.nbytes)
        dev = _place(host, dev_key)
        self._device[mkey] = dev
        return self.nbytes, dev

    def sub_bank_host(self, n_shards: int, k_replicas: int = 1) -> tuple:
        """Host arrays of the per-shard sub-bank layout: ``(arrivals,
        w_sub, v_sub, pr_nc_sub)`` with the three max-plus planes
        stacked ``(n_shards, k_replicas * local_rows, n_stores)`` --
        shard ``s``'s PRIMARY sub-bank (local rows ``[0, local)``) is
        rows ``s::n_shards`` of the global plane, zero-padded to the
        widest shard's :func:`sub_bank_rows` count.  Arrivals stay the
        global 2-D plane (one copy, gathered by every shard's lanes).

        ``k_replicas > 1`` appends the paper's **Replica set** along
        the local-row axis: replica block ``j`` (local rows ``[j *
        local, (j + 1) * local)``) of shard ``s`` holds the rows owned
        by shard ``(s - j) % n_shards`` -- so global row ``r`` is
        resident on shards ``r % n`` (primary) and ``(r % n + 1) % n``
        (first replica), and losing ONE shard never loses a row
        (``repro_torch.core.chaos.replica_rebuild`` reads the
        survivor's block back).  Gathers always target the primary
        block, so the scan arithmetic -- and at ``k_replicas=1`` the
        bytes -- are unchanged; the replica blocks cost
        ``(k - 1)/n_shards`` extra resident bytes per max-plus plane."""
        if not 1 <= k_replicas <= n_shards:
            raise ValueError(f"k_replicas must be in [1, {n_shards}], "
                             f"got {k_replicas}")
        p_loc = sub_bank_rows(self.wv_rows, n_shards)

        def sub(col: np.ndarray) -> np.ndarray:
            out = np.zeros((n_shards, k_replicas * p_loc) + col.shape[1:],
                           col.dtype)
            for s in range(n_shards):
                fill_sub_shard(out[s], col, s, n_shards, k_replicas, p_loc)
            return out

        return self.arrivals, sub(self.w), sub(self.v), sub(self.pr_nc)

    def sub_device_args(self, n_shards: int, device=None,
                        k_replicas: int = 1,
                        on_upload: Optional[Callable[[int], None]] = None
                        ) -> Tuple[int, tuple]:
        """The :meth:`sub_bank_host` layout as torch tensors on
        ``device`` (``None`` means CUDA): the ``(n_shards, k_replicas *
        local_rows, n_stores)`` stacks of the logical shards lie
        contiguous on the one device. Memoized per :func:`sub_key`
        ``("sub", n_shards, k_replicas, device)``, so resilient and plain
        placements of one bank coexist. Returns ``(bytes_uploaded_now,
        tensors)``; ``on_upload(nbytes)`` is called just before a fresh
        placement. Growth re-places the whole sub-bank (no diff path: the
        streaming engine never extends a bank mid-run, and the serving
        daemon keeps its own capacity-padded tensors)."""
        dev_key = resolve_device(device)
        mkey = sub_key(n_shards, k_replicas, dev_key)
        entry = self._device.get(mkey)
        rows_now = (self.trace_rows, self.wv_rows)
        if entry is not None:
            rows_placed, dev = entry
            if rows_placed == rows_now:
                return 0, dev
        host = self.sub_bank_host(n_shards, k_replicas)
        nbytes = sum(int(x.nbytes) for x in host)
        if on_upload is not None:
            on_upload(nbytes)
        dev = _place(host, dev_key)
        self._device[mkey] = (rows_now, dev)
        return nbytes, dev

    def drop_placement(self, key: object) -> None:
        """Forget one memoized device placement (:func:`columns_key` /
        :func:`sub_key`): after a shard loss the stale tensors must not
        be served from the memo -- the next ``device_args`` /
        ``sub_device_args`` call re-places from the host truth."""
        self._device.pop(key, None)

    def placed_columns(self, devices: Sequence[torch.device],
                       on_upload: Optional[Callable[[int], None]] = None
                       ) -> Tuple[int, int, tuple]:
        """The plain columns on every placement of ``devices``: the
        ``replicated`` partition, ONE copy per placement. Returns
        ``(h2d_bytes, fabric_bytes, parts)``, ``parts`` holding one
        ``(arrivals, w, v, pr_nc)`` tuple per placement.

        One placement is :meth:`device_args` (its memo and diff path).
        Over several, the host columns cross to ``devices[0]`` once (the
        ``h2d_bytes``) and the other placements copy them device to
        device (the ``fabric_bytes``), as the JAX package stages its
        replicated bank (``src/repro/core/engine.py:608-633``); every
        copy owns its memory. Memoized per :func:`columns_key` of the
        placement tuple; a bank grown since the placement is placed
        again whole. ``on_upload(nbytes)`` runs just before any host
        bytes cross."""
        if len(devices) == 1:
            nbytes, dev = self.device_args(devices[0], on_upload)
            return nbytes, 0, (dev,)
        mkey = columns_key(devices)
        rows_now = (self.trace_rows, self.wv_rows)
        entry = self._device.get(mkey)
        if entry is not None and entry[0] == rows_now \
                and all(p is not None for p in entry[1]):
            return 0, 0, entry[1]
        host = (self.arrivals, self.w, self.v, self.pr_nc)
        if on_upload is not None:
            on_upload(self.nbytes)
        first = _place_own(host, devices[0])
        parts = (first,) + tuple(tuple(t.to(d, copy=True) for t in first)
                                 for d in devices[1:])
        self._device[mkey] = (rows_now, parts)
        return self.nbytes, self.nbytes * (len(devices) - 1), parts

    def placed_sub(self, n_shards: int, devices: Sequence[torch.device],
                   k_replicas: int = 1,
                   on_upload: Optional[Callable[[int], None]] = None
                   ) -> Tuple[int, int, tuple]:
        """The :meth:`sub_bank_host` layout over placements: returns
        ``(h2d_bytes, fabric_bytes, parts)``, ``parts`` holding one
        ``(arrivals, w, v, pr_nc)`` tuple per placement.

        One placement is :meth:`sub_device_args` (the ``(n_shards, k *
        local_rows, n_stores)`` stacks contiguous on it). Over
        ``n_shards`` placements, placement ``s`` holds shard ``s``'s own
        ``(1, k * local_rows, n_stores)`` slice of each stack, which
        crosses from the host to it alone (so ``h2d_bytes`` stays at
        bank scale), and a copy of the arrivals: they cross to
        ``devices[0]`` once and are copied device to device to the rest
        (``fabric_bytes``), as in the JAX package's ``_place_sub_bank``
        (``src/repro/core/engine.py:636-672``). Every placement owns its
        memory. Memoized per :func:`sub_key` of the placement tuple; a
        placement freed by :meth:`free_placement` or a grown bank places
        the layout again."""
        if len(devices) == 1:
            nbytes, dev = self.sub_device_args(n_shards, devices[0],
                                               k_replicas, on_upload)
            return nbytes, 0, (dev,)
        if len(devices) != n_shards:
            raise ValueError(f"{len(devices)} placements for {n_shards} "
                             f"shards")
        mkey = sub_key(n_shards, k_replicas, devices)
        rows_now = (self.trace_rows, self.wv_rows)
        entry = self._device.get(mkey)
        if entry is not None and entry[0] == rows_now \
                and all(p is not None for p in entry[1]):
            return 0, 0, entry[1]
        host = self.sub_bank_host(n_shards, k_replicas)
        nbytes = sum(int(x.nbytes) for x in host)
        if on_upload is not None:
            on_upload(nbytes)
        a0 = _place_own(host[:1], devices[0])[0]
        parts = tuple(
            (a0 if s == 0 else a0.to(d, copy=True),)
            + _place_own(tuple(x[s:s + 1] for x in host[1:]), d)
            for s, d in enumerate(devices))
        self._device[mkey] = (rows_now, parts)
        return nbytes, int(host[0].nbytes) * (n_shards - 1), parts

    def free_placement(self, key: object, index: int) -> None:
        """Forget placement ``index`` of the memoized layout ``key`` (a
        lost card's memory is gone): the memo no longer holds its
        tensors, and the layout is whole again only after
        :meth:`respare_sub` or a fresh :meth:`placed_sub`."""
        entry = self._device.get(key)
        if entry is not None:
            rows, parts = entry
            self._device[key] = (rows, parts[:index] + (None,)
                                 + parts[index + 1:])

    def respare_sub(self, n_shards: int, devices: Sequence[torch.device],
                    k_replicas: int, shard: int,
                    primary: Optional[Dict[str, np.ndarray]] = None,
                    on_upload: Optional[Callable[[int], None]] = None
                    ) -> Tuple[int, int, tuple]:
        """Spare replacement of one placement of the :meth:`placed_sub`
        layout over ``n_shards`` placements: shard ``shard``'s stacks
        are built again on ``devices[shard]`` -- block 0 from
        ``primary`` (its own rows, ``{"w", "v", "pr_nc"}``, e.g. read back
        from a surviving replica block and digest-verified; ``None``
        takes the host columns), the replica blocks from the host columns
        -- and its arrivals are copied device to device from shard
        ``(shard + 1) % n_shards``'s placement. The other placements are
        not touched (the JAX package places the whole bank again,
        ``src/repro/core/engine.py:1153-1156``). Returns ``(h2d_bytes,
        fabric_bytes, parts)``."""
        mkey = sub_key(n_shards, k_replicas, devices)
        rows, parts = self._device[mkey]
        p_loc = sub_bank_rows(self.wv_rows, n_shards)
        stacks = tuple(
            fill_sub_shard(np.zeros((k_replicas * p_loc,) + col.shape[1:],
                                    col.dtype),
                           col, shard, n_shards, k_replicas, p_loc,
                           None if primary is None else primary[name])[None]
            for name, col in (("w", self.w), ("v", self.v),
                              ("pr_nc", self.pr_nc)))
        nbytes = sum(int(x.nbytes) for x in stacks)
        if on_upload is not None:
            on_upload(nbytes)
        src = parts[(shard + 1) % n_shards][0]
        spare = (src.to(devices[shard], copy=True),) \
            + _place_own(stacks, devices[shard])
        parts = parts[:shard] + (spare,) + parts[shard + 1:]
        self._device[mkey] = (rows, parts)
        return nbytes, src.numel() * src.element_size(), parts

    # -- Logging-Unit journal (resilience) --------------------------------

    @property
    def journal_enabled(self) -> bool:
        return self._journal is not None

    @property
    def journal_entries(self) -> int:
        """Un-acknowledged ``extend()`` diffs currently retained."""
        return len(self._journal) if self._journal is not None else 0

    def enable_journal(self) -> None:
        """Start journaling ``extend()`` diffs (the paper's Logging
        Unit, host-side): every append records a COPY of its new rows,
        retained until :meth:`ack_journal` confirms the device dump.
        Idempotent; off by default (the copies cost memory), enabled by
        the serving daemon when chaos/recovery is requested."""
        if self._journal is None:
            self._journal = []

    def ack_journal(self) -> None:
        """Acknowledge the device dump: every journaled diff is now
        resident device-side, so the retained copies are dropped (the
        host columns remain the durable truth)."""
        if self._journal is not None:
            self._journal.clear()

    def replay_journal(self) -> Dict[str, np.ndarray]:
        """Concatenate the un-acknowledged diffs in append order --
        what a recovering node would replay on top of the last
        acknowledged dump.  ``chaos.journal_rebuild`` digest-checks
        this against the bank's tail rows before using it."""
        if self._journal is None:
            raise RuntimeError("journal not enabled")
        empty = {"arrivals": np.zeros((0,), np.float32),
                 "w": np.zeros((0,), np.float32),
                 "v": np.zeros((0,), np.float32),
                 "pr_nc": np.zeros((0,), bool)}
        if not self._journal:
            return empty
        return {name: (np.concatenate([e[name] for e in self._journal
                                       if e[name].shape[0]], axis=0)
                       if any(e[name].shape[0] for e in self._journal)
                       else empty[name])
                for name in ("arrivals", "w", "v", "pr_nc")}

    def extend(self, specs: Sequence[ScenarioSpec]) -> Tuple[int, int]:
        """Append the rows of ``specs`` not yet in the bank, in place.

        New ``(trace, wv)`` keys get rows in **first-seen order over
        ``specs``** -- the same order :func:`_make_trace_bank` assigns
        when building the merged grid from scratch, so after
        ``bank.extend(delta)`` the bank's columns and row maps are
        byte-identical to ``get_trace_bank(base + delta)``
        (tests/test_trace_bank.py pins ``==`` on the bytes). Existing
        rows and indices are never reordered, so handles, cached index
        vectors and resident device placements of the old grid all stay
        valid; stale placements are refreshed by the next
        :meth:`device_args` call via a diff upload of just these rows.

        Returns ``(new_trace_rows, new_wv_rows)`` -- ``(0, 0)`` when
        every spec's rows were already present. Not thread-safe on its
        own; the serving daemon serializes extends under its lock.

        With the Logging-Unit journal enabled (:meth:`enable_journal`),
        every append additionally retains a COPY of its new rows until
        :meth:`ack_journal` confirms the device dump -- the host-side
        replay source :func:`repro_torch.core.chaos.journal_rebuild`
        recovers a lost shard from."""
        t0, p0 = self.trace_rows, self.wv_rows
        new_trace: List[tuple] = []
        new_wv: List[tuple] = []
        for s in specs:
            tk, wk = _plane_keys(s, self.cluster)
            if tk not in self.trace_row:
                self.trace_row[tk] = len(self.trace_row)
                new_trace.append(tk)
            if wk not in self.wv_row:
                self.wv_row[wk] = len(self.wv_row)
                new_wv.append(wk)
        if new_trace:
            rows = [_trace_cached(w, self.n_stores, seed, self.cluster)
                    ["arrivals"] for (w, seed) in new_trace]
            self.arrivals = np.concatenate(
                [self.arrivals, np.stack(rows, axis=0)], axis=0)
        if new_wv:
            cols = [_wv_row(k, self.n_stores, self.cluster) for k in new_wv]
            self.w = np.concatenate(
                [self.w, np.stack([c[0] for c in cols], axis=0)], axis=0)
            self.v = np.concatenate(
                [self.v, np.stack([c[1] for c in cols], axis=0)], axis=0)
            self.pr_nc = np.concatenate(
                [self.pr_nc, np.stack([c[2] for c in cols], axis=0)], axis=0)
        if self._journal is not None and (new_trace or new_wv):
            self._journal.append({
                "arrivals": self.arrivals[t0:].copy(),
                "w": self.w[p0:].copy(),
                "v": self.v[p0:].copy(),
                "pr_nc": self.pr_nc[p0:].copy()})
        return len(new_trace), len(new_wv)


def bank_row_maps(specs: Sequence[ScenarioSpec],
                  cluster: ClusterConfig = PAPER_CLUSTER
                  ) -> Tuple[Dict[tuple, int], Dict[tuple, int]]:
    """The (trace, wv) row maps of a grid WITHOUT materializing columns
    -- one cheap dict pass over the specs. The streaming engine uses
    this to know the bank's shape (and so its tile signatures) before
    the heavy row materialization starts, so compile warming overlaps
    the bank build."""
    trace_row: Dict[tuple, int] = {}
    wv_row: Dict[tuple, int] = {}
    for s in specs:
        tk, wk = _plane_keys(s, cluster)
        trace_row.setdefault(tk, len(trace_row))
        wv_row.setdefault(wk, len(wv_row))
    return trace_row, wv_row


def _make_trace_bank(specs: Tuple[ScenarioSpec, ...], n_stores: int,
                     cluster: ClusterConfig) -> TraceBank:
    trace_row, wv_row = bank_row_maps(specs, cluster)
    a_rows = [_trace_cached(w, n_stores, seed, cluster)["arrivals"]
              for (w, seed) in trace_row]
    wv_rows = [_wv_row(k, n_stores, cluster) for k in wv_row]
    return TraceBank(
        n_stores=n_stores, cluster=cluster,
        arrivals=np.stack(a_rows, axis=0),
        w=np.stack([c[0] for c in wv_rows], axis=0),
        v=np.stack([c[1] for c in wv_rows], axis=0),
        pr_nc=np.stack([c[2] for c in wv_rows], axis=0),
        trace_row=trace_row, wv_row=wv_row)


def get_trace_bank(specs: Sequence[ScenarioSpec], n_stores: int,
                   cluster: ClusterConfig = PAPER_CLUSTER) -> TraceBank:
    """Build (or fetch) the memoized columnar bank of a grid.

    Digest-keyed like :func:`_banked_inputs`, so ``simulate_batch`` and
    the streaming engine running the same grid share ONE bank handle
    (and therefore one device upload per placement) across engine
    switches. :func:`clear_sim_caches` drops it."""
    key = ("bank",) + _specs_key(tuple(specs), n_stores, cluster)
    return _BANK_CACHE.get_or_put(
        key, lambda: _make_trace_bank(tuple(specs), n_stores, cluster))


def _prepare_cell(spec: ScenarioSpec, trace: Dict[str, np.ndarray],
                  n_stores: int, cluster: ClusterConfig) -> _CellInputs:
    """Resolve a ScenarioSpec against a synthesized trace into the exact
    per-store arrays the timeline consumes. Pure host-side numpy; used
    verbatim by ``simulate``, ``simulate_batch`` and the streaming
    engine (which validate the specs up front) so the paths cannot
    drift. The heavy array work lives in :func:`_cell_arrays` and is
    shared across every cell with the same reduced key."""
    config = spec.config
    nr = cluster.n_replicas if spec.n_replicas is None else spec.n_replicas
    bw = cluster.cxl_link_bw_gbps if spec.link_bw_gbps is None else spec.link_bw_gbps
    ncn = cluster.n_cns if spec.n_cns is None else spec.n_cns
    sb = cluster.store_buffer if spec.sb_size is None else spec.sb_size
    replicating = config in _REPLICATING

    # contention and directory coupling only touch the directory/
    # replication transactions of the replicating configs (WB/WT commit
    # locally on the modeled path), keeping the WB normalization
    # baseline -- and the constant WB/WT bank rows -- unchanged;
    # _resolve_coupling is shared with _plane_keys so the per-store
    # data and the dedup keys cannot drift.
    con, dirp = _resolve_coupling(spec, cluster)
    arr = _cell_arrays(spec.workload, n_stores, spec.seed, cluster, nr, bw,
                       replicating, spec.coalescing and config != "wt",
                       contention=con, directory=dirp)

    # --- scaling with CN count: fewer CNs -> each runs more of the fixed
    # total work (weak scaling of the cluster as in Fig. 18).
    work_scale = cluster.n_cns / ncn

    n_repl = int(n_stores - arr.n_coalesced) if replicating else 0

    # --- log sizing (Fig. 13): entries accumulated per dump period ------
    entry_bytes = 12                       # Fig. 5: ~97 bits
    stores_per_s = arr.store_rate_per_core * cluster.cores_per_cn * nr
    log_bytes = stores_per_s * (cluster.dump_period_ms * 1e-3) * entry_bytes
    dump_bw = (log_bytes / cluster.gzip_factor) / (cluster.dump_period_ms * 1e-3) / 1e9

    return _CellInputs(
        spec=spec, n_stores=n_stores, sb_size=sb,
        config_idx=_CONFIG_IDX[config], work_scale=work_scale,
        arrivals=trace["arrivals"],
        coalesce=arr.coalesce,
        exposed=arr.exposed,
        t_repl_i=arr.t_repl_i,
        svc_i=arr.svc_i,
        n_repl_msgs=n_repl,
        max_log_bytes=log_bytes,
        cxl_mem_bw_gbps=arr.mem_demand * ncn,
        log_dump_bw_gbps=(dump_bw * ncn if replicating else 0.0),
        dir_occupancy=float(dirp.rho_bg) if dirp is not None else 0.0,
    )


def _finish_result(cell: _CellInputs, exec_ns: float, at_head: int,
                   sb_full: int,
                   meta: Optional[Dict[str, object]] = None) -> SimResult:
    n = cell.n_stores
    rec = _tm.active()
    if rec is not None:
        # paper-facing simulated protocol counters: every tier funnels
        # its cells through this epilogue, so a traced run reports the
        # same per-cell quantities the paper's figures plot (SS VII/
        # VIII), regardless of which engine produced the timeline.
        # Units: messages / bytes per dump period / GB/s / utilization.
        # ev=False: aggregate-only -- at mega-grid scale this path runs
        # tens of thousands of times per traced run, and per-cell ring
        # events would both wrap the tape and dominate the recorder's
        # overhead budget (the <= 1.05 bench pin).
        rec.count("proto/cells", 1, ev=False)
        rec.count("proto/repl_msgs", cell.n_repl_msgs, ev=False)
        rec.count("proto/log_unit_bytes", cell.max_log_bytes, ev=False)
        rec.observe("proto/dump_bw_gbps", cell.log_dump_bw_gbps, ev=False)
        rec.observe("proto/cxl_mem_bw_gbps", cell.cxl_mem_bw_gbps,
                    ev=False)
        rec.observe("proto/dir_queue_occupancy", cell.dir_occupancy,
                    ev=False)
    return SimResult(
        workload=cell.spec.workload,
        config=cell.spec.config,
        exec_time_ns=float(exec_ns) * cell.work_scale,
        n_stores=n,
        n_repl_msgs=cell.n_repl_msgs,
        repl_at_head_frac=float(at_head) / max(n, 1),
        max_log_bytes=cell.max_log_bytes,
        cxl_mem_bw_gbps=cell.cxl_mem_bw_gbps,
        log_dump_bw_gbps=cell.log_dump_bw_gbps,
        sb_full_frac=float(sb_full) / max(n, 1),
        meta=meta,
    )


#: The narrow-batch block length of :func:`auto_chunk`.
DEFAULT_CHUNK_SIZE = 128


# ---------------------------------------------------------------------------
# Store-buffer timeline -- banked blocked scan on the device
# ---------------------------------------------------------------------------

def _timeline_banked(a_bank: torch.Tensor, w_bank: torch.Tensor,
                     v_bank: torch.Tensor, p_bank: torch.Tensor,
                     trace_idx: np.ndarray, wv_idx: np.ndarray,
                     sb_size: np.ndarray, chunk: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Banked timeline: gather + scan of every lane, on the bank's device.

    ``*_bank`` are the store-contiguous :class:`TraceBank` columns on one
    torch device; ``trace_idx`` / ``wv_idx`` / ``sb_size`` are per-lane
    host ``int32`` vectors. The kernel's ring depth is uniform per
    launch, so lanes are grouped by SB depth and each group is one
    :func:`bank_scan` launch. Lanes are independent timelines, so the
    grouping and the scatter back are bit-identical to the JAX package's
    mixed-SB gather path. Every group is launched before the first is
    drained. ``chunk`` is passed through, clamped to each group's depth;
    it changes no result. Returns host ``(exec_time_ns f32, at_head i32,
    sb_full i32)`` per lane.
    """
    dev = a_bank.device
    launched = []
    for sb in dict.fromkeys(sb_size.tolist()):
        lanes = np.flatnonzero(sb_size == sb)
        tr = torch.from_numpy(trace_idx[lanes]).to(dev)
        wv = torch.from_numpy(wv_idx[lanes]).to(dev)
        launched.append((lanes, bank_scan(a_bank, w_bank, v_bank, p_bank,
                                          tr, wv, chunk=min(chunk, sb),
                                          sb=sb)))
    exec_ns = np.empty(len(trace_idx), np.float32)
    at_head = np.empty(len(trace_idx), np.int32)
    sb_full = np.empty(len(trace_idx), np.int32)
    for lanes, (c, ah, sf) in launched:
        exec_ns[lanes] = c.cpu().numpy()
        at_head[lanes] = ah.cpu().numpy()
        sb_full[lanes] = sf.cpu().numpy()
    return exec_ns, at_head, sb_full


def _blocked_precompute(coalesce: torch.Tensor, exposed: torch.Tensor,
                        t_repl_i: torch.Tensor, svc_i: torch.Tensor,
                        config_idx: torch.Tensor, t_l1: float, t_wt: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Collapse all five commit rules into one max-plus recurrence, on
    the stacked cells' device: the JAX package's ``_blocked_precompute``
    over **cell-major** ``(B, n_stores)`` inputs (``config_idx`` ``(B,)``).

    Every rule is exactly (bit-for-bit) ``c_i = max(r_i + w_i, c_{i-1} +
    v_i)``, because IEEE addition is monotone: WB / WT / baseline /
    parallel / coalesced-proactive take ``w_i = v_i = extra_i``,
    non-coalesced proactive ``w_i = max(t_repl_i, exposed_i)``,
    ``v_i = svc_i``. Returns cell-major ``(w f32, v f32, pr_nc bool)``
    (``pr_nc`` = proactive and not coalesced, the Fig. 11 candidates) --
    the rows of a bank :func:`bank_scan` takes. ``t_l1`` / ``t_wt`` are
    rounded to f32 first, as the JAX package's traced scalars are."""
    dev = exposed.device
    t_l1 = torch.tensor(np.float32(t_l1), device=dev)
    t_wt = torch.tensor(np.float32(t_wt), device=dev)
    cfg = config_idx[:, None]
    is_wt = cfg == _CONFIG_IDX["wt"]
    is_bl = cfg == _CONFIG_IDX["baseline"]
    is_pl = cfg == _CONFIG_IDX["parallel"]
    is_pr = cfg == _CONFIG_IDX["proactive"]

    ex_bl = torch.where(coalesce, t_l1, exposed + t_repl_i)
    ex_pl = torch.where(coalesce, t_l1, torch.maximum(exposed, t_repl_i))
    # wb and coalesced-proactive both add t_l1
    ex_other = torch.where(is_wt, t_wt, t_l1)
    extra = torch.where(is_bl, ex_bl, torch.where(is_pl, ex_pl, ex_other))
    pr_nc = is_pr & ~coalesce
    w = torch.where(pr_nc, torch.maximum(t_repl_i, exposed), extra)
    v = torch.where(pr_nc, svc_i, extra)
    return w.contiguous(), v.contiguous(), pr_nc.contiguous()


def _timeline_stacked(arrivals: torch.Tensor, coalesce: torch.Tensor,
                      exposed: torch.Tensor, t_repl_i: torch.Tensor,
                      svc_i: torch.Tensor, config_idx: torch.Tensor,
                      sb_size: np.ndarray, chunk: int, t_l1: float,
                      t_wt: float
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stacked blocked timeline: collapse the cell-major ``(B, n_stores)``
    cells on their device, then scan them as a bank whose row ``b`` is
    lane ``b`` (``trace_idx = wv_idx = arange(B)``), one launch per SB
    depth (:func:`_timeline_banked`). The banked plane scans the same
    collapsed rows with the same kernel, so the planes are ``==`` -- as
    in the JAX package, where both go through one ``_scan_wv``. Returns
    host ``(exec_time_ns f32, at_head i32, sb_full i32)`` per lane."""
    w, v, pr_nc = _blocked_precompute(coalesce, exposed, t_repl_i, svc_i,
                                      config_idx, t_l1, t_wt)
    lanes = np.arange(arrivals.shape[0], dtype=np.int32)
    return _timeline_banked(arrivals, w, v, pr_nc, lanes, lanes, sb_size,
                            chunk)


def _to_device(cell: _CellInputs, dev: torch.device) -> tuple:
    """A cell's five per-store arrays as tensors on ``dev``, in the dtypes
    :func:`_prepare_cell` gives them (f32 and bool)."""
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                 for x in (cell.arrivals, cell.coalesce, cell.exposed,
                           cell.t_repl_i, cell.svc_i))


# ---------------------------------------------------------------------------
# Public entries
# ---------------------------------------------------------------------------

def simulate(workload: str, config: str,
             cluster: ClusterConfig = PAPER_CLUSTER,
             n_stores: int = 50_000, seed: int = 0,
             n_replicas: Optional[int] = None,
             link_bw_gbps: Optional[float] = None,
             n_cns: Optional[int] = None,
             sb_size: Optional[int] = None,
             coalescing: bool = True,
             read_share: Optional[float] = None,
             conflict_rate: Optional[float] = None,
             consistency_schedule: Optional[str] = None,
             directory_load: Optional[float] = None,
             device=None) -> SimResult:
    """Simulate one (workload, config) pair on one compute node, on
    ``device`` (``None`` means CUDA; raises without one).

    All sensitivity knobs of Figs. 16-18 are exposed as overrides
    (``n_replicas`` replica count, ``link_bw_gbps`` CXL link bandwidth in
    GB/s, ``n_cns`` compute-node count, ``sb_size`` store-buffer
    entries), as are the contention axes (``read_share`` /
    ``conflict_rate`` / ``consistency_schedule``) and the directory axis
    (``directory_load``). This is the serial oracle the batched engines
    are held against: the cell's rule is applied as written, store by
    store, before the max-plus collapse, by one launch of the
    store-timeline kernel (its plain version on the CPU). Returns a
    :class:`SimResult` (times in ns, log sizes in bytes, bandwidths in
    GB/s), ``==`` to the JAX package's ``simulate`` on every field but
    ``meta``.
    """
    dev = resolve_device(device)
    spec = ScenarioSpec(workload, config, seed=seed, n_replicas=n_replicas,
                        link_bw_gbps=link_bw_gbps, n_cns=n_cns,
                        sb_size=sb_size, coalescing=coalescing,
                        read_share=read_share, conflict_rate=conflict_rate,
                        consistency_schedule=consistency_schedule,
                        directory_load=directory_load)
    spec.validate(cluster)
    trace = _trace_cached(workload, n_stores, seed, cluster)
    cell = _prepare_cell(spec, trace, n_stores, cluster)
    costs = _commit_cost_ns(config, cluster)
    exec_ns, at_head, sb_full = store_timeline(
        *_to_device(cell, dev), config=config, sb=cell.sb_size,
        t_l1=costs["t_l1"], t_wt=costs["t_wt"])
    return _finish_result(cell, exec_ns.item(), int(at_head), int(sb_full),
                          meta={"engine": "serial",
                                "data_plane": "stacked",
                                "bank_partition": None})


def simulate_spec(spec: ScenarioSpec,
                  cluster: ClusterConfig = PAPER_CLUSTER,
                  n_stores: int = 50_000, device=None) -> SimResult:
    """Run the serial oracle for one :class:`ScenarioSpec` cell on
    ``device`` (``None`` means CUDA).

    The single place that maps EVERY spec knob -- including the
    contention axes -- onto :func:`simulate`'s keyword surface, so
    differential callers (the engine's ``serial`` tier, oracle checks)
    cannot silently drop a new axis."""
    return simulate(spec.workload, spec.config, cluster=cluster,
                    n_stores=n_stores, seed=spec.seed,
                    n_replicas=spec.n_replicas,
                    link_bw_gbps=spec.link_bw_gbps, n_cns=spec.n_cns,
                    sb_size=spec.sb_size, coalescing=spec.coalescing,
                    read_share=spec.read_share,
                    conflict_rate=spec.conflict_rate,
                    consistency_schedule=spec.consistency_schedule,
                    directory_load=spec.directory_load, device=device)


def _pad_len(n: int, mult: int = 8) -> int:
    return max(((n + mult - 1) // mult) * mult, mult)


def _stack_cells(cells: List[_CellInputs]):
    """Stack prepared cells into time-major batch arrays (host numpy).

    The batch is padded to the next multiple of 8 cells by repeating
    cell 0, and SB rings to the widest cell (multiple of 8). Per-store
    arrays are stacked time-major ``(n_stores, B)``, the layout in which
    the per-step kernel's lanes read neighbouring words. The streaming
    engine does NOT use this: its tiles stack cell-major
    (``engine._stack_tile``).

    Returns ``(args, sb_max, sb_min, sb_uniform)`` where ``args`` is
    the 7-tuple the batched timelines consume.
    """
    n_pad = _pad_len(len(cells))
    padded = cells + [cells[0]] * (n_pad - len(cells))
    sb_max = _pad_len(max(c.sb_size for c in padded))
    args = (
        np.stack([c.arrivals for c in padded], axis=1),
        np.stack([c.coalesce for c in padded], axis=1),
        np.stack([c.exposed for c in padded], axis=1),
        np.stack([c.t_repl_i for c in padded], axis=1),
        np.stack([c.svc_i for c in padded], axis=1),
        np.asarray([c.config_idx for c in padded], np.int32),
        np.asarray([c.sb_size for c in padded], np.int32),
    )
    sb_min = min(c.sb_size for c in padded)
    sb_uniform = sb_min if sb_min == max(c.sb_size for c in padded) else None
    return args, sb_max, sb_min, sb_uniform


def _make_batch_inputs(specs: Tuple[ScenarioSpec, ...], n_stores: int,
                       cluster: ClusterConfig, device: torch.device):
    cells = [_prepare_cell(s, _trace_cached(s.workload, n_stores, s.seed,
                                            cluster), n_stores, cluster)
             for s in specs]
    np_args, sb_max, sb_min, sb_uniform = _stack_cells(cells)
    args = tuple(torch.from_numpy(a).to(device) for a in np_args)
    return cells, args, np_args[6], sb_max, sb_min, sb_uniform


def _batch_inputs(specs: Tuple[ScenarioSpec, ...], n_stores: int,
                  cluster: ClusterConfig, device: torch.device):
    """Memoized stacked prep for one batch on ``device``: every cell
    prepared and the padded time-major arrays placed there. Returns
    ``(cells, device args, host sb_size, sb_max, sb_min, sb_uniform)``.

    The memo is digest-keyed (:func:`_specs_key`, plus the device) and
    size-bounded (:data:`_BATCH_INPUT_CACHE`), as in the JAX package;
    :func:`clear_sim_caches` drops it."""
    key = _specs_key(specs, n_stores, cluster) + (str(device),)
    return _BATCH_INPUT_CACHE.get_or_put(
        key, lambda: _make_batch_inputs(specs, n_stores, cluster, device))


_batch_inputs.cache_clear = _BATCH_INPUT_CACHE.clear   # lru_cache-compat


def _specs_key(specs: Sequence[ScenarioSpec], n_stores: int,
               cluster: ClusterConfig) -> Tuple[int, int, str]:
    """Constant-size digest key for a (specs, n_stores, cluster) batch."""
    h = hashlib.blake2b(digest_size=16)
    h.update(repr((n_stores, cluster)).encode())
    for s in specs:
        h.update(repr(s).encode())
    return (len(specs), n_stores, h.hexdigest())


def _make_banked_inputs(specs: Tuple[ScenarioSpec, ...], n_stores: int,
                        cluster: ClusterConfig):
    # the bank handle is deliberately NOT part of the returned (cached)
    # tuple: row indices are deterministic (first-seen order over the
    # same specs), so callers re-resolve the bank through
    # get_trace_bank and _BANK_CACHE's small bound stays the ONLY thing
    # keeping multi-hundred-MB banks alive
    bank = get_trace_bank(specs, n_stores, cluster)
    cells = [_prepare_cell(s, _trace_cached(s.workload, n_stores, s.seed,
                                            cluster), n_stores, cluster)
             for s in specs]
    # scan-lane dedup (same reduction as the streaming engine's): a
    # timeline consumes only (arrivals row, max-plus row, SB depth), so
    # cells sharing that triple are ONE lane -- gathered and scanned
    # once, with the lane outputs scattered back to member cells by
    # ``cell_lane``. The one-shot tier no longer gathers (and pads) the
    # full (n_stores, B) batch on device when the grid repeats lanes
    # (e.g. the whole CN axis of a sweep): device gather width, scan
    # width and the shipped index bytes all shrink to unique lanes.
    lane_of: Dict[tuple, int] = {}
    lane_rows: List[Tuple[int, int]] = []
    lane_sb: List[int] = []
    cell_lane: List[int] = []
    for c in cells:
        tr, wv = bank.rows_for(c.spec)
        key = (c.sb_size, tr, wv)
        j = lane_of.setdefault(key, len(lane_rows))
        if j == len(lane_rows):
            lane_rows.append((tr, wv))
            lane_sb.append(c.sb_size)
        cell_lane.append(j)
    n_lanes = len(lane_rows)
    pad = _pad_len(n_lanes) - n_lanes
    trace_idx = np.asarray([r[0] for r in lane_rows]
                           + [lane_rows[0][0]] * pad, np.int32)
    wv_idx = np.asarray([r[1] for r in lane_rows]
                        + [lane_rows[0][1]] * pad, np.int32)
    sb_list = lane_sb + [lane_sb[0]] * pad
    sb_arr = np.asarray(sb_list, np.int32)
    sb_max = _pad_len(max(sb_list))
    sb_min = min(sb_list)
    sb_uniform = sb_min if sb_min == max(sb_list) else None
    return (cells, np.asarray(cell_lane, np.int64), n_lanes, trace_idx,
            wv_idx, sb_arr, sb_max, sb_min, sb_uniform)


def _banked_inputs(specs: Tuple[ScenarioSpec, ...], n_stores: int,
                   cluster: ClusterConfig):
    """Memoized banked host prep for one batch: the padded ``int32``
    lane-index vectors, the cell->lane scatter map, plus prepared cells
    (entries are a few KB, and hold NO reference to the bank itself)."""
    key = _specs_key(specs, n_stores, cluster)
    return _BANKED_INPUT_CACHE.get_or_put(
        key, lambda: _make_banked_inputs(specs, n_stores, cluster))


#: Cap for the auto-chunk heuristic on *wide* batches.
AUTO_CHUNK_CAP = 48

#: Batch width (padded cell count) at which the auto heuristic switches
#: from the deep narrow-batch chunk to the capped wide-batch chunk.
AUTO_CHUNK_WIDE_CELLS = 256


def auto_chunk(n_stores: int, sb_min: int,
               n_cells: Optional[int] = None) -> int:
    """Blocked-scan chunk heuristic (used when ``chunk_size=None``).

    The JAX package's pick, kept so that ``SimResult.meta['chunk']`` and
    the tile signatures match it; the scan kernel walks stores one at a
    time and no result depends on the chunk. A block may never exceed
    the narrowest SB in the batch; **narrow** batches (``n_cells`` <
    :data:`AUTO_CHUNK_WIDE_CELLS`) take ``min(sb, n_stores,
    DEFAULT_CHUNK_SIZE)``, **wide** ones (or ``n_cells=None``) the
    largest exact divisor of ``n_stores`` up to :data:`AUTO_CHUNK_CAP`.
    """
    hi = min(sb_min, n_stores)
    if n_cells is not None and n_cells < AUTO_CHUNK_WIDE_CELLS:
        return max(1, min(hi, DEFAULT_CHUNK_SIZE))
    cap = min(hi, AUTO_CHUNK_CAP)
    for c in range(cap, 15, -1):         # largest exact divisor, if any
        if n_stores % c == 0:
            return c
    return max(1, cap)


def simulate_batch(specs: Sequence[ScenarioSpec],
                   cluster: ClusterConfig = PAPER_CLUSTER,
                   n_stores: int = 50_000,
                   chunk_size: Optional[int] = None,
                   data_plane: Optional[str] = None,
                   device=None) -> List[SimResult]:
    """Simulate a whole scenario grid in one batched scan on ``device``
    (``None`` means CUDA; raises without one).

    Results come back in ``specs`` order (one :class:`SimResult` per
    spec; times in ns, log sizes in bytes, bandwidths in GB/s). Unique
    ``(workload, seed)`` traces are synthesized once and shared across
    every cell that scans them.

    ``chunk_size`` selects the engine: ``None`` (default) runs the
    blocked scan and records the :func:`auto_chunk` pick in
    ``meta["chunk"]``; an explicit ``>= 1`` value is clamped to
    ``n_stores`` and the narrowest SB (the chunk changes no result);
    ``0`` runs the per-step engine, the store-timeline kernel over the
    stacked cells with every rule applied before the collapse.
    ``data_plane`` selects how the blocked scan's inputs reach the
    device: ``"bank"`` (default) places the grid's deduplicated
    :class:`TraceBank` and scans only unique **lanes** -- cells sharing
    ``(SB, trace row, max-plus row)`` have bit-identical timelines, so
    their outputs are scattered from one lane (``meta["scan_lanes"]``);
    ``"stacked"`` ships one full array copy per cell (padded to a
    multiple of 8 cells by repeating cell 0), collapses them on the
    device and scans them with the same kernel -- the only plane of the
    per-step engine. ``meta`` reports the engine, chunk and plane that
    ran, and ``h2d_bytes``, the plane's cold host-to-device bytes. Every
    field but ``meta`` is ``==`` to the JAX package's ``simulate_batch``
    on the same specs, whatever the engine and plane.
    """
    dev = resolve_device(device)
    if not specs:
        return []
    if chunk_size is not None and chunk_size < 0:
        raise ValueError(f"chunk_size must be >= 0, got {chunk_size}")
    if data_plane not in (None, "bank", "stacked"):
        raise ValueError(f"unknown data_plane {data_plane!r}")
    if data_plane == "bank" and chunk_size is not None and chunk_size == 0:
        raise ValueError("the per-step engine has no banked plane")
    for s in specs:
        s.validate(cluster)

    costs = _commit_cost_ns("proactive", cluster)   # t_l1/t_wt are shared
    cell_lane = None
    if chunk_size is None or chunk_size:
        plane = data_plane or "bank"
        if plane == "bank":
            (cells, cell_lane, n_lanes, trace_idx, wv_idx, sb_arr, _sb_max,
             sb_min, _sb_uniform) = _banked_inputs(tuple(specs), n_stores,
                                                   cluster)
            bank = get_trace_bank(specs, n_stores, cluster)
            idx_bytes = trace_idx.nbytes + wv_idx.nbytes + sb_arr.nbytes
            batch_width = len(trace_idx)        # padded unique lanes
        else:
            cells, args, sb_host, _sb_max, sb_min, _sb_uniform = \
                _batch_inputs(tuple(specs), n_stores, cluster, dev)
            batch_width = _pad_len(len(specs))
        # a block may not reach past the carried history: the SB depth
        # bounds the lookback (c_{i-sb}), so clamp to the narrowest cell
        chunk = auto_chunk(n_stores, sb_min, batch_width) \
            if chunk_size is None else min(chunk_size, n_stores, sb_min)
        meta = {"engine": "blocked", "chunk": chunk,
                "auto_chunk": chunk_size is None, "data_plane": plane,
                "bank_partition": None}   # one device: nothing to shard
        if plane == "bank":
            meta["bank_rows"] = bank.n_rows
            meta["scan_lanes"] = n_lanes
            meta["h2d_bytes"] = bank.nbytes + idx_bytes
            _, bank_dev = bank.device_args(device=dev)
            exec_ns, at_head, sb_full = _timeline_banked(
                *bank_dev, trace_idx, wv_idx, sb_arr, chunk)
        else:
            meta["h2d_bytes"] = _stacked_bytes(args)
            # the scan reads cell-major rows: one device transpose each
            exec_ns, at_head, sb_full = _timeline_stacked(
                *(x.T.contiguous() for x in args[:5]), args[5], sb_host,
                chunk, costs["t_l1"], costs["t_wt"])
    else:
        cells, args, _sb_host, sb_max, _sb_min, _sb_uniform = \
            _batch_inputs(tuple(specs), n_stores, cluster, dev)
        meta = {"engine": "perstep", "chunk": 0, "auto_chunk": False,
                "data_plane": "stacked", "bank_partition": None,
                "h2d_bytes": _stacked_bytes(args)}
        exec_ns, at_head, sb_full = (x.cpu().numpy() for x in
                                     store_timeline_batch(
                                         *args, sb_max=sb_max,
                                         t_l1=costs["t_l1"],
                                         t_wt=costs["t_wt"]))
    if cell_lane is not None:
        # scatter each deduplicated lane's outputs to its member cells
        exec_ns = exec_ns[cell_lane]
        at_head = at_head[cell_lane]
        sb_full = sb_full[cell_lane]

    # fresh meta per result: SimResult is frozen but a shared dict would
    # alias annotations across the whole batch
    return [_finish_result(c, exec_ns[i], int(at_head[i]), int(sb_full[i]),
                           meta=dict(meta))
            for i, c in enumerate(cells)]


def _stacked_bytes(args: Sequence[torch.Tensor]) -> int:
    """Bytes of the stacked plane's arrays (what crossed host->device)."""
    return sum(t.numel() * t.element_size() for t in args)


def slowdowns_from_results(results: Sequence[SimResult],
                           baseline: str = "wb"
                           ) -> Dict[str, Dict[str, float]]:
    """Group batched SimResults into a per-workload slowdown table
    normalized to ``baseline`` (one ``baseline`` cell per workload must
    be present; cells are keyed by (workload, config), so pass results
    from a grid that does not repeat a cell with different knobs)."""
    times: Dict[str, Dict[str, float]] = {}
    for r in results:
        times.setdefault(r.workload, {})[r.config] = r.exec_time_ns
    out: Dict[str, Dict[str, float]] = {}
    for w, row in times.items():
        if baseline not in row:
            raise ValueError(f"no {baseline!r} cell for workload {w!r}")
        out[w] = {c: t / row[baseline] for c, t in row.items()}
    return out


def slowdown_table(configs: Tuple[str, ...] = CONFIGS,
                   workloads: Optional[Tuple[str, ...]] = None,
                   n_stores: int = 50_000, batched: bool = True,
                   cluster: ClusterConfig = PAPER_CLUSTER,
                   device=None, **kw) -> Dict[str, Dict[str, float]]:
    """Fig. 2 / Fig. 10: per-workload slowdowns normalized to WB, on
    ``device`` (``None`` means CUDA).

    ``batched=True`` (default) runs the whole grid as ONE
    :func:`simulate_batch` call; ``batched=False`` keeps the serial
    per-cell oracle loop (:func:`simulate`) for differential testing.
    ``kw`` takes any ScenarioSpec knob (seed, n_replicas, link_bw_gbps,
    n_cns, sb_size, coalescing).
    """
    workloads = workloads or tuple(WORKLOADS)
    cfgs = tuple(dict.fromkeys(("wb",) + tuple(configs)))
    if batched:
        specs = [ScenarioSpec(w, c, **kw) for w in workloads for c in cfgs]
        results = simulate_batch(specs, cluster=cluster, n_stores=n_stores,
                                 device=device)
        table = slowdowns_from_results(results)
        return {w: {c: table[w][c] for c in configs} for w in workloads}
    out: Dict[str, Dict[str, float]] = {}
    for w in workloads:
        base = simulate(w, "wb", cluster=cluster, n_stores=n_stores,
                        device=device, **kw).exec_time_ns
        out[w] = {}
        for c in configs:
            t = simulate(w, c, cluster=cluster, n_stores=n_stores,
                         device=device, **kw).exec_time_ns
            out[w][c] = t / base
    return out


def geomean_slowdowns(table: Dict[str, Dict[str, float]]) -> Dict[str, float]:
    """Per-config geometric mean over the workloads of a slowdown table
    (the paper's headline aggregation; dimensionless ratios)."""
    out: Dict[str, float] = {}
    for c in next(iter(table.values())):
        vals = [table[w][c] for w in table]
        out[c] = float(np.exp(np.mean(np.log(vals))))
    return out
