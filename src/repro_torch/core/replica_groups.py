"""Hash-based replica group assignment (paper SS III.A).

The paper hashes a cache-line address to pick the N_r replica CNs so all
updates to one address land in the same replica set. Here the replicated
unit is a (node, bucket) state shard; we hash (bucket_id) to a *rotation
schedule* so that:

* every source node has exactly N_r distinct replica targets per bucket,
* every node is a replica for exactly N_r sources per bucket (balanced),
* targets never equal the source,
* the mapping is a pure function of (bucket, N_r, n_nodes) -- recovery can
  recompute it without any metadata.

Targets are expressed as *offsets* so that, inside ``shard_map``, a single
``ppermute`` per (replica_rank, bucket) implements the REPL fan-out.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence, Tuple


def _hash_int(*xs: int) -> int:
    h = hashlib.sha256(",".join(map(str, xs)).encode()).digest()
    return int.from_bytes(h[:8], "little")


def replica_offsets(bucket_id: int, n_replicas: int, n_nodes: int) -> Tuple[int, ...]:
    """Offsets o_1..o_Nr (each in 1..n_nodes-1, distinct): node s replicates
    bucket ``bucket_id`` onto nodes (s + o_r) % n_nodes."""
    if n_replicas >= n_nodes:
        raise ValueError(
            f"n_replicas={n_replicas} must be < n_nodes={n_nodes}")
    # hash-seeded sample of distinct non-zero offsets
    avail = list(range(1, n_nodes))
    out: List[int] = []
    seed = _hash_int(bucket_id, n_replicas, n_nodes)
    for r in range(n_replicas):
        seed = _hash_int(seed, r)
        pick = seed % len(avail)
        out.append(avail.pop(pick))
    return tuple(out)


def replica_targets(node: int, bucket_id: int, n_replicas: int,
                    n_nodes: int) -> Tuple[int, ...]:
    """The N_r nodes that log ``node``'s updates to ``bucket_id``."""
    return tuple((node + o) % n_nodes
                 for o in replica_offsets(bucket_id, n_replicas, n_nodes))


def replica_sources(node: int, bucket_id: int, n_replicas: int,
                    n_nodes: int) -> Tuple[int, ...]:
    """The N_r source nodes whose ``bucket_id`` updates ``node`` logs.

    Inverse of :func:`replica_targets`; with rotation offsets the r-th
    source is (node - o_r) % n_nodes.
    """
    return tuple((node - o) % n_nodes
                 for o in replica_offsets(bucket_id, n_replicas, n_nodes))


def ppermute_pairs(bucket_id: int, replica_rank: int, n_replicas: int,
                   n_nodes: int) -> List[Tuple[int, int]]:
    """(src, dst) pairs for the ``lax.ppermute`` implementing REPL fan-out
    number ``replica_rank`` of ``bucket_id``."""
    off = replica_offsets(bucket_id, n_replicas, n_nodes)[replica_rank]
    return [(s, (s + off) % n_nodes) for s in range(n_nodes)]


def inverse_ppermute_pairs(bucket_id: int, replica_rank: int, n_replicas: int,
                           n_nodes: int) -> List[Tuple[int, int]]:
    """(src, dst) pairs routing logged entries *back* to the shard owner
    (used by jitted recovery)."""
    off = replica_offsets(bucket_id, n_replicas, n_nodes)[replica_rank]
    return [(s, (s - off) % n_nodes) for s in range(n_nodes)]


def line_replicas(line_addr: int, n_replicas: int,
                  n_nodes: int) -> Tuple[int, ...]:
    """Paper-faithful per-cache-line replica selection (used by the
    fine-grained Logging Unit / KV-store path): hash the line address to
    N_r distinct CNs.

    Note the set depends on the *address only* (paper SS III.A): every
    writer of a line uses the same replica group, and the group may
    contain the writer itself -- the system still tolerates N_r - 1
    failures.
    """
    avail = list(range(n_nodes))
    out: List[int] = []
    seed = _hash_int(line_addr, n_replicas, n_nodes)
    for r in range(n_replicas):
        seed = _hash_int(seed, r)
        out.append(avail.pop(seed % len(avail)))
    return tuple(out)
