"""Elastic scaling after a node loss: spare replacement or a degraded mesh.

After recovery (:mod:`repro_torch.core.recovery`), a hot-spare node
takes over the failed node's coordinates and the recovered shard is
written into the state at them; the node axes keep their sizes. On one
card that is tensor surgery on the global state
(:func:`install_recovered_shard`). Without a spare the mesh shrinks
instead (:func:`shrink_data_axis`). The streaming engine's logical
``cells`` shards follow the same two policies
(:func:`cells_spare_replacement`, :func:`cells_degraded_shards`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from repro_torch.core.recovery import RecoveryResult, reassemble_shard
from repro_torch.core.replication import (ReplicationEngine, tree_flatten,
                                          tree_unflatten)
from repro_torch.distributed.context import MeshContext, P


def _block_slices(global_shape: Tuple[int, ...], spec: P,
                  ctx: MeshContext,
                  coords: Dict[str, int]) -> Tuple[slice, ...]:
    """The index slices of the block owned by node coordinates ``coords``
    for a tensor sharded with ``spec`` (only the axes present in coords
    are pinned; others must be fully covered by the slice)."""
    idx: List[slice] = []
    mesh_shape = ctx.shape
    for d, ax in enumerate(tuple(spec) + (None,) * (len(global_shape)
                                                    - len(spec))):
        dim = global_shape[d]
        if ax is None:
            idx.append(slice(None))
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        sizes = [mesh_shape[a] for a in axes]
        n = int(np.prod(sizes))
        block = dim // n
        # linearized coordinate over the sharding axes (major-to-minor)
        lin = 0
        for a, s in zip(axes, sizes):
            lin = lin * s + coords.get(a, 0)
        if all(a in coords for a in axes):
            idx.append(slice(lin * block, (lin + 1) * block))
        else:
            raise ValueError(
                f"spec axis {axes} not fully pinned by coords {coords}")
    return tuple(idx)


def install_recovered_shard(state: Any, specs: Any, engine: ReplicationEngine,
                            result: RecoveryResult,
                            target_coord: Tuple[int, ...]) -> Any:
    """A copy of ``state`` (a tree of tensors laid out by ``specs``) with
    the recovered node shard written at ``target_coord`` (spare
    replacement: target == failed coordinates).

    Exact (bit-identical) when the log dtype matches the state dtype.
    Like the JAX package, it needs dimensions that the node axes divide.
    """
    ctx = engine.ctx
    per_model = reassemble_shard(engine, result)
    n_model = len(per_model)

    flat_state, treedef = tree_flatten(state)
    flat_specs, _ = tree_flatten(specs)
    if len(flat_state) != len(flat_specs):
        raise ValueError(f"{len(flat_specs)} specs for {len(flat_state)} "
                         f"leaves")

    # a "node" is identified by its batch-axes coordinates (pod?, data)
    node_axes = list(ctx.batch_axes)
    new_flat = []
    for li, (leaf, spec) in enumerate(zip(flat_state, flat_specs)):
        out = leaf.clone()
        for m in range(n_model):
            coords = {"model": m} if ctx.model_axis else {}
            for a, c in zip(node_axes, target_coord[-len(node_axes):]):
                coords[a] = c
            sl = _block_slices(tuple(leaf.shape), spec, ctx, coords)
            patch = per_model[m][li].to(device=out.device, dtype=out.dtype)
            out[sl] = patch.reshape(out[sl].shape)
        new_flat.append(out)
    return tree_unflatten(treedef, new_flat)


def shrink_data_axis(mesh_shape: Tuple[int, ...], axes: Tuple[str, ...]
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Degraded-mesh shape after losing one data rank."""
    out = list(mesh_shape)
    di = axes.index("data")
    if out[di] <= 1:
        raise ValueError("cannot shrink a single-rank data axis")
    out[di] -= 1
    return tuple(out), axes


# -- the engine tier's logical ``cells`` shards (core.engine / chaos) -------

def cells_spare_replacement(n_shards: int, lost: int) -> int:
    """Spare-replacement shard count for the streaming engine's
    ``cells`` shards: UNCHANGED -- a spare takes the lost shard's place,
    so every tile program stays valid and recovery costs re-placing the
    rebuilt rows only (``run_grid``'s recovery path; zero new
    programs). Returns the shard count after validating the lost
    index."""
    if not 0 <= lost < n_shards:
        raise ValueError(f"lost shard {lost} not in [0, {n_shards})")
    return n_shards


def cells_degraded_shards(n_shards: int) -> int:
    """Degraded shard count after losing one shard with no spare: one
    fewer -- the caller re-runs on it with ``bank_partition=
    "replicated"`` (per-shard sub-banks would need a reshard; the
    replicated layout needs only its new tile programs) and keeps
    serving."""
    if n_shards <= 1:
        raise ValueError("cannot shrink a single-shard cells mesh")
    return n_shards - 1
