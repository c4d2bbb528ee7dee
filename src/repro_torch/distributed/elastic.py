"""Elastic scaling after a node loss: spare replacement or a degraded mesh.

After recovery (:mod:`repro_torch.core.recovery`), a hot-spare node
takes over the failed node's coordinates and the recovered shard is
written into the state at them; the node axes keep their sizes. On one
card that is tensor surgery on the global state
(:func:`install_recovered_shard`); across ranks that split ``model`` it
is written in place into each rank's ``Shard`` blocks. Without a spare
the mesh shrinks
instead (:func:`shrink_data_axis`). The streaming engine's logical
``cells`` shards follow the same two policies
(:func:`cells_spare_replacement`, :func:`cells_degraded_shards`), on one
device or one placement per shard.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.recovery import RecoveryResult, reassemble_shard
from repro_torch.core.replication import (ReplicationEngine, tree_flatten,
                                          tree_unflatten)
from repro_torch.distributed import sharding
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

    Across ranks the parameters are replicated on every rank and
    ``recover_node`` hands every rank the same ``result`` (each bucket
    broadcast from the rank holding its newest version), so every rank
    runs this on its own copy and the copies stay ``==``: the JAX
    package's ``install_recovered_shard`` writes the global array once
    (``src/repro/distributed/elastic.py:55``).

    Across ranks that split ``model`` (``state`` the rank's tree of
    ``Shard``s and replicated tensors, ``result`` its position's rows)
    the shard is written in place, under ``no_grad``, into the tensors
    the optimizer updates: into each ``Shard.local`` the failed node's
    part at the rank's position, where the rank's node block stores it
    (``sharding.node_part``), and every replicated leaf whole. The
    tensors stay the autograd leaves they were; ``state`` is returned.
    """
    ctx = engine.ctx
    per_model = reassemble_shard(engine, result)
    n_model = len(per_model)
    if ctx.split_model:
        return _install_split(state, engine, per_model, target_coord)

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


def _install_split(state: Any, engine: ReplicationEngine,
                   per_model: List[List[torch.Tensor]],
                   target_coord: Tuple[int, ...]) -> Any:
    """:func:`install_recovered_shard` across ranks that split
    ``model``."""
    ctx = engine.ctx
    if len(per_model) != 1:
        raise ValueError(f"a rank of a split context installs one model "
                         f"position's rows, got {len(per_model)}")
    leaves, _ = tree_flatten(state)
    node = engine.joined_index(target_coord)
    with torch.no_grad():
        for leaf, patch in zip(leaves, per_model[0]):
            if isinstance(leaf, sharding.Shard):
                cut = sharding.node_part(leaf, ctx, node)
                if cut is None:
                    continue
                dst = leaf.local[cut]
            else:
                dst = leaf
            dst.copy_(patch.to(device=dst.device,
                               dtype=dst.dtype).reshape(dst.shape))
    return state


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

def cells_spare_replacement(n_shards: int, lost: int,
                            placements: Sequence = ()
                            ) -> Tuple[int, Tuple]:
    """Spare-replacement layout for the streaming engine's ``cells``
    shards: UNCHANGED -- a spare takes the lost shard's place, so every
    tile program stays valid and recovery costs re-placing the lost
    shard's rows only (``run_grid``'s recovery path; zero new
    programs). Returns ``(n_shards, placements)`` after validating the
    lost index: the count and the placements (one device, or one per
    shard, :func:`~repro_torch.distributed.context.cells_devices`) of
    the new layout, the spare on the lost shard's placement. The JAX
    package's ``cells_spare_replacement``
    (``src/repro/distributed/elastic.py:111``) returns the count."""
    if not 0 <= lost < n_shards:
        raise ValueError(f"lost shard {lost} not in [0, {n_shards})")
    return n_shards, tuple(placements)


def cells_degraded_shards(n_shards: int, placements: Sequence = (),
                          lost: Optional[int] = None) -> Tuple[int, Tuple]:
    """Degraded layout after losing one shard with no spare: one shard
    fewer -- the caller re-runs on it with ``bank_partition=
    "replicated"`` (per-shard sub-banks would need a reshard; the
    replicated layout needs only its new tile programs) and keeps
    serving. Returns ``(n_shards - 1, placements)``: with one placement
    per shard the lost shard's is dropped (the JAX package's
    ``cells_degraded_shards``, ``src/repro/distributed/elastic.py:123``,
    takes the first ``n - 1`` devices; the results are ``==`` either
    way, each lane's arithmetic is its own), and one placement is
    kept."""
    if n_shards <= 1:
        raise ValueError("cannot shrink a single-shard cells mesh")
    placements = tuple(placements)
    if len(placements) == n_shards and n_shards > 1:
        if lost is None or not 0 <= lost < n_shards:
            raise ValueError(f"lost shard {lost} not in [0, {n_shards})")
        placements = placements[:lost] + placements[lost + 1:]
    return n_shards - 1, placements
