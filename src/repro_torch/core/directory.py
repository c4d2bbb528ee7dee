"""Shard directory -- the framework's analogue of the CXL coherence
directory that recovery repairs (paper SS V.C).

The CXL directory tracks, per cache line, which CNs cache it and who owns
the dirty copy. Our directory tracks, per (node, bucket) state shard:

* ``owner``      -- the data-rank that owns (writes) the shard,
* ``replicas``   -- the N_r ranks whose Logging Units hold its updates,
* ``dump_step``  -- the last step whose version is safe in the MN tier,
* ``commit_step``-- the last step whose replication was validated,
* ``state``      -- OWNED / SHARED / UNOWNED (post-recovery).

It is deliberately a host-side structure (numpy): the paper's directory
lives in MN memory and is repaired by *software* handlers; keeping it off
the device state also means its consistency survives device failures by
construction. Benchmarks read it for the Fig. 15 analogue (owned shards
of a crashed node).

Queueing model (``directory_load`` axis)
----------------------------------------
The bottom of this module is the *capacity* side of the directory: the
simulator's two-level max-plus recurrence (docs/simulator.md) treats
each (node, bucket) shard as an M/D/1-style server shared by every CN
that appears in the shard's replica set. Two resolved quantities feed
it:

* :func:`sharer_pool` -- the **real** sharer census: the union of
  node 0's per-bucket replica peers under :class:`ShardDirectory`,
  clamped to ``n_cns - 1``. This replaces ``contention.SHARER_POOL``'s
  fixed 15-peer binomial when the directory model is active (the
  small-cluster overcount bugfix).
* :class:`DirectoryParams` via :func:`resolve_directory_load` -- the
  frozen per-cell coupling knobs the simulator folds into each epoch's
  ``w`` side and the dedup keys. ``directory_load=None`` keeps the
  axis fully inert (bit-identical legacy outputs AND keys).
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import replica_groups


class ShardState(enum.Enum):
    OWNED = "owned"          # owner holds the newest (dirty) version
    SHARED = "shared"        # replicated, clean vs. MN tier
    UNOWNED = "unowned"      # post-recovery: memory holds newest version


@dataclasses.dataclass
class DirEntry:
    owner: int
    replicas: Tuple[int, ...]
    state: ShardState = ShardState.OWNED
    dump_step: int = -1          # newest version safe in MN tier
    commit_step: int = -1        # newest validated replicated version


class ShardDirectory:
    """Directory over all (node, bucket) shards."""

    def __init__(self, n_nodes: int, n_buckets: int, n_replicas: int):
        self.n_nodes = n_nodes
        self.n_buckets = n_buckets
        self.n_replicas = n_replicas
        self.entries: Dict[Tuple[int, int], DirEntry] = {}
        for node in range(n_nodes):
            for b in range(n_buckets):
                reps = replica_groups.replica_targets(
                    node, b, n_replicas, n_nodes)
                self.entries[(node, b)] = DirEntry(owner=node, replicas=reps)

    # ------------------------------------------------------------------
    def entry(self, node: int, bucket: int) -> DirEntry:
        return self.entries[(node, bucket)]

    def record_commit(self, step: int) -> None:
        for e in self.entries.values():
            e.commit_step = step
            e.state = ShardState.OWNED

    def record_dump(self, step: int) -> None:
        for e in self.entries.values():
            e.dump_step = step

    # ------------------------------------------------------------------
    # Recovery queries (Algorithm 1 inputs)
    # ------------------------------------------------------------------

    def owned_by(self, node: int) -> List[Tuple[int, int]]:
        """Shards whose dirty version lived on ``node``."""
        return [k for k, e in self.entries.items()
                if e.owner == node and e.state == ShardState.OWNED]

    def replicated_on(self, node: int) -> List[Tuple[int, int]]:
        """Shards whose Logging-Unit entries live on ``node``
        (the SHARED analogue: what must be dropped when ``node`` dies)."""
        return [k for k, e in self.entries.items() if node in e.replicas]

    def replicas_of(self, node: int, bucket: int) -> Tuple[int, ...]:
        return self.entries[(node, bucket)].replicas

    # ------------------------------------------------------------------
    # Recovery mutations (Algorithm 1 effects)
    # ------------------------------------------------------------------

    def remove_failed_replica(self, failed: int) -> int:
        """Drop ``failed`` from every replica set (sharer-bit clearing)."""
        n = 0
        for e in self.entries.values():
            if failed in e.replicas:
                e.replicas = tuple(r for r in e.replicas if r != failed)
                n += 1
        return n

    def reassign(self, node: int, bucket: int, new_owner: int,
                 n_nodes: Optional[int] = None) -> None:
        e = self.entries[(node, bucket)]
        e.owner = new_owner
        e.state = ShardState.UNOWNED
        # recompute a full replica set for the new owner
        e.replicas = replica_groups.replica_targets(
            new_owner, bucket, self.n_replicas, n_nodes or self.n_nodes)

    # ------------------------------------------------------------------
    def stats(self, failed: int) -> Dict[str, int]:
        """Fig. 15 analogue: shard-entry census for a crashed node."""
        owned = len(self.owned_by(failed))
        shared = len(self.replicated_on(failed))
        return {"owned": owned, "shared": shared,
                "total": len(self.entries)}

    def to_json(self) -> str:
        return json.dumps({
            f"{k[0]}:{k[1]}": {
                "owner": e.owner, "replicas": list(e.replicas),
                "state": e.state.value, "dump_step": e.dump_step,
                "commit_step": e.commit_step,
            } for k, e in self.entries.items()
        })

    @classmethod
    def from_json(cls, blob: str, n_nodes: int, n_buckets: int,
                  n_replicas: int) -> "ShardDirectory":
        d = cls(n_nodes, n_buckets, n_replicas)
        data = json.loads(blob)
        for key, v in data.items():
            node, b = map(int, key.split(":"))
            e = d.entries[(node, b)]
            e.owner = v["owner"]
            e.replicas = tuple(v["replicas"])
            e.state = ShardState(v["state"])
            e.dump_step = v["dump_step"]
            e.commit_step = v["commit_step"]
        return d


# ---------------------------------------------------------------------------
# Queueing-coupled directory model (the simulator's level-2 recurrence)
# ---------------------------------------------------------------------------

#: Buckets per node in the canonical coupling directory. Matches the
#: recovery benches' shard granularity; a shard therefore serves
#: ``1/DIR_BUCKETS`` of a node's line traffic.
DIR_BUCKETS = 16

#: Stores per directory epoch in the level-2 service-rate recurrence.
#: Coarser than ``contention.EPOCH_LEN`` (64): the directory queue
#: drains on dump-period timescales, not store-buffer timescales.
DIR_EPOCH_LEN = 128


@functools.lru_cache(maxsize=256)
def sharer_pool(n_cns: int, n_replicas: int,
                n_buckets: int = DIR_BUCKETS) -> int:
    """Real sharer census for one CN: the union of node 0's per-bucket
    replica peers under :class:`ShardDirectory`, self excluded.

    This is the directory-derived replacement for the fixed
    ``contention.SHARER_POOL`` binomial pool: by construction it never
    exceeds ``n_cns - 1``, so a 4-CN cluster stops drawing invalidation
    storms from 15 phantom peers. Returns 0 for single-node clusters
    (nobody to invalidate)."""
    if n_cns <= 1:
        return 0
    nr_eff = max(1, min(int(n_replicas), n_cns - 1))
    peers = set()
    for bucket in range(n_buckets):
        peers.update(replica_groups.replica_targets(
            0, bucket, nr_eff, n_cns))
    peers.discard(0)
    return len(peers)


@dataclasses.dataclass(frozen=True)
class DirectoryParams:
    """Resolved directory-coupling knobs for one cell.

    Frozen + hashable: appended verbatim to the simulator's
    ``_plane_keys`` wv key (and hence the bank-row / scan-lane dedup
    keys), so two cells couple through the same (shard, epoch-profile)
    iff their params compare equal. ``rho_bg`` is the *background*
    utilization this cell's shard sees from its sharer pool; the cell's
    own offered work is added per epoch by the level-2 recurrence.
    """

    sharer_pool: int
    rho_bg: float
    epoch: int = DIR_EPOCH_LEN
    buckets: int = DIR_BUCKETS


def resolve_directory_load(load: Optional[float], n_cns: int,
                           n_replicas: int) -> Optional[DirectoryParams]:
    """Resolve the ``directory_load`` axis to frozen params (or None).

    ``None`` means the coupling is OFF: no params, no key component,
    bit-identical legacy behavior. ``load`` is the offered utilization
    in [0, 1) each *sharer* contributes to the shared shard;
    ``rho_bg`` scales it by the real pool over the peer count.
    ``load == 0.0`` canonicalizes to a pool-free zero-load cell so the
    in-grid normalization cell dedups across CN counts (the delays are
    exactly zero either way)."""
    if load is None:
        return None
    load = float(load)
    if not 0.0 <= load < 1.0:
        raise ValueError(
            f"directory_load must be in [0, 1) or None, got {load!r}")
    if load == 0.0:
        return DirectoryParams(sharer_pool=0, rho_bg=0.0)
    pool = sharer_pool(n_cns, n_replicas)
    rho_bg = load * pool / max(n_cns - 1, 1)
    return DirectoryParams(sharer_pool=pool, rho_bg=rho_bg)


def directory_service_scale(dirp: Optional[DirectoryParams]) -> float:
    """Mean service-rate dilation ``1 / (1 - rho)`` of a shard under
    background load (utilization capped below saturation). Scales the
    recovery walk's directory phase; 1.0 when the coupling is off."""
    if dirp is None:
        return 1.0
    rho = min(float(dirp.rho_bg), 0.95)
    return 1.0 / (1.0 - rho)
