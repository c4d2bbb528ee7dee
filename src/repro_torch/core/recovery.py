"""ReCXL recovery (paper SS V.B-D, Algorithms 1-2, Table I) and the
SS VII-E downtime model, on torch tensors.

Software-driven, coordinated by a Configuration Manager on a live node.
Correctness over speed, exactly as the paper prescribes ("recovery speed
is not the main concern").

Sequence (mirrors Fig. 9):

1. ``Interrupt`` -> all live nodes pause, complete outstanding work,
   ``InterruptResp``.
2. ``InitRecov`` -> directory repair (Algorithm 1): drop the failed node
   from every replica set; for every shard the failed node *owned*,
   ``FetchLatestVers`` asks the replica Logging Units for their newest
   validated version (Algorithm 2 walks each log newest-to-earliest);
   the newest version across replicas -- or, failing that, the MN-tier
   dump -- is applied to memory and the entry marked UNOWNED.
3. ``RecovEnd`` -> resume (see :mod:`repro_torch.distributed.elastic`).

The JAX package copies the whole log ring to the host before it walks
it. At the paper's width that ring is 19.2 GB, so the port copies only
``ts`` and ``valid`` (a few KB) to the host, ranks the versions there by
the same rule, and reads only the winning ``values`` slices, which stay
on the ring's device. Results are the same, ``n_versions`` in the
message log included.

Across ranks (a rank-aware engine, :mod:`repro_torch.core.replication`)
each rank walks Algorithm 2 over the replica nodes it holds, the small
``(n_versions, ts, slot)`` table is summed over ranks
(:func:`repro_torch.distributed.collectives.gather_rows`), so every rank
-- the recovering one included -- picks the same latest valid version a
bucket, and the rank holding it broadcasts its values. Every rank
returns the same :class:`RecoveryResult`, ``==`` the one-card one.

Across ranks that split ``model`` each rank walks its own ``model``
position of its replica nodes: an entry's validity is ANDed over the
``model`` group (a version counts only when every position validated
it, as the one-card walk requires of every ``model`` coordinate), the
timestamp is the last position's, and the rows are summed over the
FSDP group. Each position's row of the winning version is broadcast
within its own FSDP group, so a rank's :class:`RecoveredShard` holds
its position's row (``model_pos``); the stats and message log are every
rank's, and the positions' rows, in order, are the one-card values.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.recxl_paper import (PAPER_CLUSTER, WORKLOADS,
                                             ClusterConfig)
from repro_torch.core.contention import (
    ContentionParams,
    dirty_line_scale,
    undumped_log_scale,
)
from repro_torch.core.directory import ShardDirectory, ShardState
from repro_torch.core.protocol import (
    FetchLatestVers,
    MsgType,
    RecoveryStats,
)
from repro_torch.core.replication import ReplicationEngine
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives


@dataclasses.dataclass
class RecoveredShard:
    """One recovered (node, bucket) shard, per model-axis coordinate:
    every one, or, across ranks that split ``model``, the rank's
    position ``model_pos`` alone."""
    bucket: int
    ts: int
    source: str                       # "replica:<rank>" | "mn_dump"
    values: torch.Tensor              # (n_model, bucket_len), ring's device
    model_pos: Optional[int] = None   # the one row's position, if split


@dataclasses.dataclass
class RecoveryResult:
    failed: Tuple[int, ...]           # (pod?, data) coordinates
    shards: Dict[int, RecoveredShard] # bucket -> shard
    stats: RecoveryStats
    message_log: List[Tuple[MsgType, Any]]


def host_index(logs: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The ring's ``ts`` and ``valid`` on the host: what Algorithm 2
    walks. ``values`` stay on the device."""
    return {k: logs[k].cpu().numpy() for k in ("ts", "valid")}


# ---------------------------------------------------------------------------
# Algorithm 2: replica log traversal
# ---------------------------------------------------------------------------

def algorithm2_versions(engine: ReplicationEngine,
                        host: Dict[str, np.ndarray],
                        replica_coord: Tuple[int, ...], rank: int,
                        bucket: int) -> List[Tuple[int, int]]:
    """All logged versions of (failed-owner, bucket) held by the Logging
    Unit at ``replica_coord``, as ``(ts, slot)`` sorted latest-to-earliest
    (ties in slot order, as the JAX package's stable sort leaves them).

    ``host`` is :func:`host_index` of the ring. Only *validated* entries
    count (un-VALed entries were never committed by the source), and an
    entry counts only when every model coordinate validated it; the
    version's values are ``fetch_version(logs, ...)``."""
    axes = engine.mesh_axes
    n_model = engine.local_model_size
    out: List[Tuple[int, int]] = []
    for slot in range(engine.rep.log_capacity):
        ok, ts = True, -1
        for m in range(n_model):
            coord = _lead_index(axes, replica_coord, m)
            if not host["valid"][coord + (rank, slot, bucket)]:
                ok = False
                break
            ts = int(host["ts"][coord + (rank, slot, bucket)])
        if ok and ts >= 0:
            out.append((ts, slot))
    out.sort(key=lambda p: -p[0])
    return out


def fetch_version(engine: ReplicationEngine, logs: Dict[str, torch.Tensor],
                  replica_coord: Tuple[int, ...], rank: int, slot: int,
                  bucket: int) -> torch.Tensor:
    """One logged version's values, ``(n_model, bucket_len)`` (the rank's
    one position where the ranks split ``model``), read from the ring on
    its device."""
    return torch.stack([
        logs["values"][_lead_index(engine.mesh_axes, replica_coord, m)
                       + (rank, slot, bucket)]
        for m in range(engine.local_model_size)])


def _lead_index(axes: Sequence[str], node_coord: Tuple[int, ...],
                model_idx: int) -> Tuple[int, ...]:
    """Build the leading index tuple (pod?, data, model) for log arrays."""
    out: List[int] = []
    ni = 0
    for ax in axes:
        if ax == "model":
            out.append(model_idx)
        else:
            out.append(node_coord[ni])
            ni += 1
    return tuple(out)


def _walk_replicas(engine: ReplicationEngine, logs: Dict[str, torch.Tensor],
                   queries: Sequence[Tuple[int, int, int, Tuple[int, ...]]]
                   ) -> np.ndarray:
    """Algorithm 2 for each ``(bucket, rank, ring node, coordinate)``
    query: ``(n_versions, ts, slot)`` of the latest valid version, rows
    of an int64 table. Across ranks each rank walks the nodes it holds
    and the table is summed over ranks (the JAX recovery walks its host
    copy of the global ring, ``src/repro/core/recovery.py:133``)."""
    host = host_index(logs)
    rows = np.zeros((len(queries), 3), np.int64)   # 0 rows: never asked
    if engine.ctx.split_model:
        found = _split_versions(engine, host, [
            (engine.local_coord(coord), r, bucket)
            for bucket, r, _, coord in queries])
        for i, versions in enumerate(found):
            if versions:
                rows[i] = (len(versions),) + versions[0]
        return collectives.gather_rows(rows, engine.ctx)
    for i, (bucket, r, _, coord) in enumerate(queries):
        local = engine.local_coord(coord)
        if local is None:
            continue
        versions = algorithm2_versions(engine, host, local, r, bucket)
        if versions:
            rows[i] = (len(versions),) + versions[0]
    return collectives.gather_rows(rows, engine.ctx)


def _split_versions(engine: ReplicationEngine, host: Dict[str, np.ndarray],
                    items: Sequence[Tuple[Optional[Tuple[int, ...]], int,
                                          int]]
                    ) -> List[List[Tuple[int, int]]]:
    """:func:`algorithm2_versions` across ranks that split ``model``, for
    each ``(local coordinate or None, replica rank, bucket)``: a slot
    counts when it is valid at every ``model`` position, with the last
    position's timestamp. This rank's position's bits are summed over the
    ``model`` group (one ``all_reduce``; the ranks of a block hold the
    same nodes, so an item is held at every position or at none)."""
    ctx = engine.ctx
    cap = engine.rep.log_capacity
    table = np.zeros((len(items), cap, 2), np.int64)
    last = ctx.model_rank == ctx.model_size - 1
    for i, (local, r, bucket) in enumerate(items):
        if local is None:
            continue
        idx = _lead_index(engine.mesh_axes, local, 0) + (r, slice(None),
                                                           bucket)
        table[i, :, 0] = host["valid"][idx]
        if last:
            table[i, :, 1] = host["ts"][idx]
    table = collectives.model_rows(table, ctx)
    out = []
    for valid, ts in zip(table[..., 0] == ctx.model_size, table[..., 1]):
        versions = [(int(ts[s]), s) for s in range(cap)
                    if valid[s] and ts[s] >= 0]
        versions.sort(key=lambda p: -p[0])
        out.append(versions)
    return out


def _fetch(engine: ReplicationEngine, logs: Dict[str, torch.Tensor],
           coord: Tuple[int, ...], rank: int, slot: int,
           bucket: int) -> torch.Tensor:
    """:func:`fetch_version` of the node at ``coord``, read on the rank
    that holds it (at this rank's ``model`` position where the ranks
    split the axis) and broadcast to every rank (of that position)."""
    local = engine.local_coord(coord)
    vals = (None if local is None else
            fetch_version(engine, logs, local, rank, slot, bucket))
    return collectives.share(
        vals, engine.owner_rank(coord),
        (engine.local_model_size, engine.layout.bucket_len),
        logs["values"].dtype, engine.ctx)


def _position(engine: ReplicationEngine) -> Optional[int]:
    """The ``model`` position of a rank's recovered rows (``None``: it
    holds every position)."""
    return engine.ctx.model_rank if engine.ctx.split_model else None


# ---------------------------------------------------------------------------
# Algorithm 1: directory + memory repair
# ---------------------------------------------------------------------------

def recover_node(engine: ReplicationEngine,
                 logs: Dict[str, torch.Tensor],
                 directory: ShardDirectory,
                 failed_coord: Tuple[int, ...],
                 mn_dump: Optional[Dict[int, Tuple[int, Any]]] = None,
                 ) -> RecoveryResult:
    """Run Algorithms 1-2 for one failed node.

    ``failed_coord``: (data,) or (pod, data) coordinate of the failed
    node. ``mn_dump``: bucket -> (step, values) from the MN tier (the
    dumped-log fallback). Returns the recovered shard contents, on the
    ring's device; the caller applies them to a rebuilt state
    (:mod:`repro_torch.distributed.elastic`).

    The directory, the replica targets and ``stats.failed_node`` count
    ring indices (``engine.ring_index``), and each target's logs are
    read at its own coordinate (``engine.node_coord``). On the
    cross-pod ring the JAX package takes the data coordinate as the
    ring index and raises ``IndexError`` (ROADMAP C5); without that ring
    the two agree. Across ranks (the JAX package's ``recover_node``,
    ``src/repro/core/recovery.py:119``) every rank runs it on its own
    logs and returns the same result; across ranks that split ``model``
    the same stats and message log, and its position's rows.
    """
    msg_log: List[Tuple[MsgType, Any]] = []
    failed = engine.ring_index(failed_coord)
    pod = failed_coord[0] if len(failed_coord) > 1 else 0
    n_nodes = engine.n_nodes

    # -- Algorithm 1, part 1: clear the failed node as a "sharer"
    # (drop it from every replica set in the directory).
    cleared = directory.remove_failed_replica(failed)

    # -- Algorithm 1, part 2: for every shard the failed node owned,
    # fetch the latest logged version from its replicas. The engine's
    # offsets say which replica rank r maps to which replica node; the
    # failed node is never asked (SS V.A).
    owned = directory.owned_by(failed)
    queries = [[(bucket, r, (failed + off) % n_nodes,
                 engine.node_coord((failed + off) % n_nodes, pod))
                for r, off in enumerate(engine._offsets(bucket))
                if (failed + off) % n_nodes != failed
                and (failed + off) % n_nodes in directory.replicas_of(
                    node, bucket)]
               for (node, bucket) in owned]
    found = iter(_walk_replicas(engine, logs,
                                [x for qs in queries for x in qs]))
    msg_log.append((MsgType.INIT_RECOV, {"failed": failed_coord}))

    shards: Dict[int, RecoveredShard] = {}
    n_from_replicas = n_from_dump = n_unrec = 0
    for (node, bucket), qs in zip(owned, queries):
        reps = directory.replicas_of(node, bucket)
        fetch = FetchLatestVers(addrs=(bucket,))
        msg_log.append((MsgType.FETCH_LATEST_VERS,
                        {"to": reps, "msg": fetch}))
        candidates: List[Tuple[int, Tuple[Tuple[int, ...], int, int], str]] = []
        for (_, r, t, t_coord), row in zip(qs, found):
            n_versions, ts, slot = (int(x) for x in row)
            msg_log.append((MsgType.FETCH_LATEST_VERS_RESP,
                            {"from": t, "n_versions": n_versions}))
            if n_versions:
                candidates.append((ts, (t_coord, r, slot),
                                   f"replica:{r}@node{t}"))
        if candidates:
            # paper: replicas normally agree; on mid-replication failure
            # the latest across any replica wins.
            candidates.sort(key=lambda c: -c[0])
            ts, (t_coord, r, slot), src = candidates[0]
            vals = _fetch(engine, logs, t_coord, r, slot, bucket)
            shards[bucket] = RecoveredShard(bucket, ts, src, vals,
                                            _position(engine))
            n_from_replicas += 1
        elif mn_dump is not None and bucket in mn_dump:
            step, vals = mn_dump[bucket]
            shards[bucket] = RecoveredShard(bucket, step, "mn_dump",
                                            torch.as_tensor(vals))
            n_from_dump += 1
        else:
            n_unrec += 1
        directory.entries[(node, bucket)].state = ShardState.UNOWNED

    msg_log.append((MsgType.INIT_RECOV_RESP, {"buckets": len(shards)}))
    msg_log.append((MsgType.RECOV_END, {}))

    stats = RecoveryStats(
        failed_node=failed,
        shared_entries_cleared=cleared,
        owned_entries=len(owned),
        recovered_from_replicas=n_from_replicas,
        recovered_from_mn_dump=n_from_dump,
        unrecoverable=n_unrec,
    )
    return RecoveryResult(failed=failed_coord, shards=shards, stats=stats,
                          message_log=msg_log)


# ---------------------------------------------------------------------------
# Parity (erasure-coded) recovery -- beyond-paper mode
# ---------------------------------------------------------------------------

def _newest_parity(engine: ReplicationEngine, host: Dict[str, np.ndarray],
                   coord: Tuple[int, ...], bucket: int) -> Tuple[int, int]:
    """``(ts, slot)`` of the newest parity version of ``bucket`` valid at
    every model coordinate of the holder at (local) ``coord``; ts -1
    when there is none."""
    best_ts, best_slot = -1, 0
    for slot in range(engine.rep.log_capacity):
        ok, ts = True, -1
        for m in range(engine.local_model_size):
            idx = _lead_index(engine.mesh_axes, coord, m) + (0, slot, bucket)
            if not host["valid"][idx]:
                ok = False
                break
            ts = int(host["ts"][idx])
        if ok and ts > best_ts:
            best_ts, best_slot = ts, slot
    return best_ts, best_slot


def recover_node_parity(engine: ReplicationEngine,
                        logs: Dict[str, torch.Tensor],
                        state: Any, specs: Any,
                        failed_coord: Tuple[int, ...],
                        ) -> RecoveryResult:
    """Erasure-coded recovery: lost = parity - sum(survivors' payloads).

    ``state``: the live global state (survivors still hold their shards),
    laid out by ``specs`` (the engine's). The subtraction runs in f64 on
    the state's device, as the JAX package runs it in f64 on the host.
    Tolerates one failure per parity group (vs. N_r-1 anywhere for copy
    mode) at G x N_r less log memory. Across ranks the holder's rank
    walks its log, and the parity version and each survivor's packed
    state are broadcast from the ranks that hold them, so every rank
    subtracts in the one-card order (the JAX package's
    ``recover_node_parity``, ``src/repro/core/recovery.py:203``). Across
    ranks that split ``model`` (``state`` the rank's ``Shard`` tree) each
    position recovers its own rows, as :func:`recover_node` does.
    """
    if engine.rep.mode != "parity":
        raise ValueError("recover_node_parity needs a parity-mode engine")
    del specs                         # the engine holds the same specs
    G = engine.rep.parity_group
    failed = engine.ring_index(failed_coord)
    pod = failed_coord[0] if len(failed_coord) > 1 else 0
    group = failed // G
    members = [engine.node_coord(m, pod)
               for m in range(group * G, (group + 1) * G) if m != failed]
    nb = engine.layout.n_buckets
    holders = [engine.node_coord(engine.parity_holder(group, b), pod)
               for b in range(nb)]
    # the newest valid parity version of each bucket, walked by the
    # holder's rank (Algorithm 2 over one log)
    host = host_index(logs)
    rows = np.full((nb, 2), 0, np.int64)
    locals_ = [engine.local_coord(h) for h in holders]
    if engine.ctx.split_model:
        found = _split_versions(engine, host, [
            (loc, 0, b) for b, loc in enumerate(locals_)])
    for b, local in enumerate(locals_):
        if local is None:
            continue
        if engine.ctx.split_model:
            best = found[b][0] if found[b] else (-1, 0)
        else:
            best = _newest_parity(engine, host, local, b)
        rows[b] = (best[0] + 1, best[1])
    rows = collectives.gather_rows(rows, engine.ctx)
    # each survivor's packed state, (n_model, n_buckets, bucket_len), from
    # the rank that holds it
    payload = engine.payloads(state)          # (*local nodes, nb, bl)
    n_model = engine.local_model_size
    axes = engine.mesh_axes
    survivors = []
    for coord in members:
        local = engine.local_coord(coord)
        block = None if local is None else torch.stack([
            payload[_lead_index(axes, local, m)] for m in range(n_model)])
        survivors.append(collectives.share(
            block, engine.owner_rank(coord),
            (n_model, nb, engine.layout.bucket_len), payload.dtype,
            engine.ctx))

    shards: Dict[int, RecoveredShard] = {}
    msg_log: List[Tuple[MsgType, Any]] = [
        (MsgType.INIT_RECOV, {"failed": failed_coord, "mode": "parity"})]
    n_unrec = 0
    for b, h_coord in enumerate(holders):
        best_ts, best_slot = int(rows[b, 0]) - 1, int(rows[b, 1])
        if best_ts < 0:
            n_unrec += 1
            continue
        # subtract the survivors' contributions
        lost = _fetch(engine, logs, h_coord, 0, best_slot, b).double()
        for block in survivors:
            for m in range(n_model):
                lost[m] -= block[m, b].double()
        holder = engine.parity_holder(group, b)
        shards[b] = RecoveredShard(b, best_ts, f"parity@node{holder}",
                                   lost.float(), _position(engine))
        msg_log.append((MsgType.FETCH_LATEST_VERS_RESP,
                        {"from": holder, "bucket": b, "ts": best_ts}))
    msg_log.append((MsgType.RECOV_END, {}))
    stats = RecoveryStats(
        failed_node=failed, shared_entries_cleared=0,
        owned_entries=nb, recovered_from_replicas=len(shards),
        recovered_from_mn_dump=0, unrecoverable=n_unrec)
    return RecoveryResult(failed=failed_coord, shards=shards, stats=stats,
                          message_log=msg_log)


# ---------------------------------------------------------------------------
# Recovery-time (downtime) model -- paper SS VII-E
# ---------------------------------------------------------------------------
#
# The paper prioritizes correctness over recovery speed, but SS VII-E still
# quantifies the dominant cost: replaying the Logging-Unit logs to rebuild
# directory + memory. Downtime is modeled as the Fig. 9 sequence of
# sequential phases; the replay phase scales with the log volume that had
# not yet been dumped at the failure point (it grows with the position
# inside the dump interval) and the owned-line fetch volume, divided by the
# CXL link bandwidth.


@dataclasses.dataclass(frozen=True)
class RecoveryTimeParams:
    """Cost constants of the downtime model (units in field names).

    ``line_bytes``/``header_bytes`` size one FetchLatestVers payload;
    ``log_entry_bytes`` (Fig. 5: ~97 bits -> 12 B) converts undumped log
    bytes to entries for the Logging-Unit walk; ``scan_cycles_per_entry``
    is the per-entry cost of Algorithm 2's newest-to-earliest traversal
    at the Logging-Unit clock.
    """
    detect_us: float = 50.0          # failure-detection lease timeout
    dir_entry_ns: float = 8.0        # per owned directory entry (Alg. 1)
    line_bytes: int = 64             # recovered payload per owned line
    header_bytes: int = 8            # CXL message header
    log_entry_bytes: float = 12.0    # Fig. 5 log-entry footprint
    scan_cycles_per_entry: float = 2.0


DEFAULT_RECOVERY_PARAMS = RecoveryTimeParams()


@dataclasses.dataclass(frozen=True)
class RecoveryEstimate:
    """Estimated downtime breakdown for one fail-stop event.

    Phase fields are ns and sum (sequentially, as in Fig. 9) to
    ``total_ns``; ``replay_bytes`` is the total log-replay volume
    (undumped log + fetched versions + memory writeback) in bytes.
    """
    detect_ns: float                 # lease expiry until CM reacts
    quiesce_ns: float                # Interrupt -> InterruptResp drain
    directory_ns: float              # Algorithm 1 walk + replica clears
    log_scan_ns: float               # Algorithm 2 Logging-Unit traversal
    fetch_ns: float                  # FetchLatestVers payloads over CXL
    writeback_ns: float              # applying versions to MN memory
    resume_ns: float                 # RecovEnd broadcast
    owned_lines: float               # lines the failed node owned
    undumped_log_bytes: float        # log bytes pending at failure point
    replay_bytes: float              # total replayed volume (bytes)

    @property
    def total_ns(self) -> float:
        return (self.detect_ns + self.quiesce_ns + self.directory_ns +
                self.log_scan_ns + self.fetch_ns + self.writeback_ns +
                self.resume_ns)

    @property
    def total_ms(self) -> float:
        return self.total_ns / 1e6


def estimate_recovery_time(owned_lines: float,
                           undumped_log_bytes: float,
                           cluster: ClusterConfig = PAPER_CLUSTER,
                           link_bw_gbps: Optional[float] = None,
                           params: RecoveryTimeParams =
                           DEFAULT_RECOVERY_PARAMS,
                           dir_service_scale: float = 1.0
                           ) -> RecoveryEstimate:
    """Closed-form downtime estimate for one failed CN (plain Python
    floats, the same arithmetic as the JAX package's).

    ``owned_lines``: cache lines (or shard entries) the failed node
    owned -- each needs a FetchLatestVers + memory writeback.
    ``undumped_log_bytes``: Logging-Unit bytes accumulated since the
    last dump at the failure point (bounded by the dump interval);
    Algorithm 2 walks these to find the newest validated versions.
    ``link_bw_gbps``: CXL link bandwidth in GB/s (1 GB/s == 1 byte/ns,
    so transfer ns == bytes / GB/s); defaults to the cluster's.
    ``dir_service_scale`` (>= 1.0) dilates the directory-walk phase
    when the surviving directory shards serve recovery under background
    load (``directory.directory_service_scale`` -- 1.0 = uncoupled).
    """
    bw = cluster.cxl_link_bw_gbps if link_bw_gbps is None else link_bw_gbps
    if bw <= 0.0:
        raise ValueError(f"link_bw_gbps must be > 0, got {bw}")
    if owned_lines < 0 or undumped_log_bytes < 0:
        raise ValueError("volumes must be >= 0")
    if dir_service_scale < 1.0:
        raise ValueError(
            f"dir_service_scale must be >= 1.0, got {dir_service_scale}")
    fetch_bytes = owned_lines * (params.line_bytes + params.header_bytes)
    wb_bytes = owned_lines * params.line_bytes
    entries = undumped_log_bytes / params.log_entry_bytes
    lu_cycle_ns = 1e3 / cluster.logging_unit_freq_mhz
    return RecoveryEstimate(
        detect_ns=params.detect_us * 1e3,
        quiesce_ns=cluster.cxl_rtt_ns
        + cluster.store_buffer * 2.0 * cluster.cycle_ns,
        directory_ns=owned_lines * params.dir_entry_ns * dir_service_scale,
        log_scan_ns=entries * params.scan_cycles_per_entry * lu_cycle_ns,
        fetch_ns=fetch_bytes / bw,
        writeback_ns=wb_bytes / bw,
        resume_ns=cluster.cxl_rtt_ns,
        owned_lines=owned_lines,
        undumped_log_bytes=undumped_log_bytes,
        replay_bytes=undumped_log_bytes + fetch_bytes + wb_bytes,
    )


def workload_recovery_inputs(workload: str, fail_time_ms: float,
                             cluster: ClusterConfig = PAPER_CLUSTER,
                             n_cns: Optional[int] = None,
                             n_replicas: Optional[int] = None,
                             params: RecoveryTimeParams =
                             DEFAULT_RECOVERY_PARAMS,
                             contention: Optional[ContentionParams] = None
                             ) -> Tuple[float, float]:
    """Derive ``(owned_lines, undumped_log_bytes)`` for a workload at a
    given failure time.

    ``fail_time_ms`` is wall-clock since the last Logging-Unit dump
    epoch; only its position inside the dump interval matters (the dump
    resets the pending log), so the undumped volume is periodic in
    ``cluster.dump_period_ms``. With fewer CNs each node runs more of
    the fixed total work (weak scaling, Fig. 18), so both the owned-line
    census (Fig. 15) and the per-node store rate scale by
    ``cluster.n_cns / n_cns``. Coalesced stores never reach the log.
    ``contention`` scales what a crash can expose
    (``dirty_line_scale`` / ``undumped_log_scale``).
    """
    wl = WORKLOADS[workload]
    ncn = cluster.n_cns if n_cns is None else n_cns
    if ncn < 1:
        raise ValueError(f"n_cns must be >= 1, got {ncn}")
    del n_replicas  # every replica holds a full copy of the node's log
    scale = cluster.n_cns / ncn
    owned = wl.working_lines * scale
    ipc = 2.0
    stores_per_s = (wl.remote_store_rate / 1e3) * ipc \
        * cluster.cpu_freq_ghz * 1e9 * cluster.cores_per_cn * scale
    entries_per_s = stores_per_s * (1.0 - wl.coalesce_rate)
    phase_ms = fail_time_ms % cluster.dump_period_ms
    undumped = entries_per_s * (phase_ms * 1e-3) * params.log_entry_bytes
    if contention is not None:
        owned *= dirty_line_scale(contention)
        undumped *= undumped_log_scale(contention)
    return owned, undumped


def recovery_time_batch(owned_lines, undumped_log_bytes, link_bw_gbps,
                        dir_service_scale=1.0,
                        cluster: ClusterConfig = PAPER_CLUSTER,
                        params: RecoveryTimeParams = DEFAULT_RECOVERY_PARAMS,
                        device=None) -> Dict[str, torch.Tensor]:
    """Vectorized :func:`estimate_recovery_time` over broadcastable
    arrays, on ``device`` (``None`` means CUDA, and raises without a
    card).

    Inputs broadcast together to the grid shape; returns a dict of f32
    tensors of that shape: every phase field of
    :class:`RecoveryEstimate` plus ``total_ns`` and ``replay_bytes``.
    The JAX package computes this in f32 (it runs without x64), and so
    does the port; Python constants are rounded to f32 before they meet
    a tensor, as JAX's weakly typed scalars are.
    """
    dev = resolve_device(device)
    f32 = torch.float32
    owned = torch.as_tensor(np.asarray(owned_lines), device=dev).to(f32)
    undumped = torch.as_tensor(np.asarray(undumped_log_bytes),
                               device=dev).to(f32)
    bw = torch.as_tensor(np.asarray(link_bw_gbps), device=dev).to(f32)
    dscale = torch.as_tensor(np.asarray(dir_service_scale),
                             device=dev).to(f32)
    shape = torch.broadcast_shapes(owned.shape, undumped.shape, bw.shape,
                                   dscale.shape)

    def const(x: float) -> torch.Tensor:
        return torch.tensor(x, dtype=f32, device=dev)

    fetch_bytes = owned * const(params.line_bytes + params.header_bytes)
    wb_bytes = owned * const(params.line_bytes)
    # XLA turns the division by this compile-time constant into a
    # multiply by its f32 reciprocal; the port does the same.
    entries = undumped * const(float(np.float32(1.0)
                                     / np.float32(params.log_entry_bytes)))
    lu_cycle_ns = 1e3 / cluster.logging_unit_freq_mhz
    out = {
        "detect_ns": const(params.detect_us * 1e3).expand(shape),
        "quiesce_ns": const(cluster.cxl_rtt_ns + cluster.store_buffer * 2.0
                            * cluster.cycle_ns).expand(shape),
        "directory_ns": owned * const(params.dir_entry_ns) * dscale,
        "log_scan_ns": entries * const(params.scan_cycles_per_entry)
        * const(lu_cycle_ns),
        "fetch_ns": fetch_bytes / bw,
        "writeback_ns": wb_bytes / bw,
        "resume_ns": const(cluster.cxl_rtt_ns).expand(shape),
        "replay_bytes": undumped + fetch_bytes + wb_bytes,
    }
    out["total_ns"] = (out["detect_ns"] + out["quiesce_ns"]
                       + out["directory_ns"] + out["log_scan_ns"]
                       + out["fetch_ns"] + out["writeback_ns"]
                       + out["resume_ns"])
    return out


# ---------------------------------------------------------------------------
# Reassembling the failed node's state shard
# ---------------------------------------------------------------------------

def reassemble_shard(engine: ReplicationEngine, result: RecoveryResult
                     ) -> List[List[torch.Tensor]]:
    """Stitch recovered buckets back into the per-model-coordinate leaf
    list of the failed node's local state shard.

    Returns a list over model coordinates; each element is the f32 leaf
    list (matching ``engine.layout.local_shapes``), on the device the
    shards are on."""
    nb, bl = engine.layout.n_buckets, engine.layout.bucket_len
    if len(result.shards) != nb:
        missing = sorted(set(range(nb)) - set(result.shards))
        raise ValueError(f"buckets unrecovered: {missing}")
    n_model = result.shards[0].values.shape[0]
    per_model = []
    for m in range(n_model):
        flat = torch.cat([result.shards[b].values[m].float().reshape(-1)
                          for b in range(nb)])
        per_model.append(engine.unpack(flat.reshape(nb, bl)))
    return per_model
