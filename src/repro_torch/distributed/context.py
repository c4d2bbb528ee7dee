"""The node-axis context of the port: named axes, their sizes, a device.

The JAX package's ``distributed/context.py`` wraps a device mesh: each
node of the simulated cluster is a device, and the replication engine
runs ``shard_map`` regions over the mesh axes. On one card the port has
no mesh. A :class:`MeshContext` names the node axes and their sizes --
``("data",)`` for a fault scenario's ring of nodes, ``("data",
"model")`` for a data x model grid -- and every per-node tensor carries
those axes as its leading dimensions, in that order, on ``device``.
Partition specs (:class:`P`) name which axes shard which dimension of a
global tensor, as ``jax.sharding.PartitionSpec`` does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.device import resolve_device


class P(tuple):
    """A partition spec: one entry per leading dimension of a global
    tensor -- ``None`` (not sharded), an axis name, or a tuple of axis
    names (sharded over their product, major to minor). Dimensions past
    the spec are not sharded. A tuple subclass, so a tree of specs keeps
    each spec as one leaf."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclass(frozen=True)
class MeshContext:
    axis_names: Tuple[str, ...]      # node axes, major to minor
    axis_sizes: Tuple[int, ...]
    batch_axes: Tuple[str, ...]      # axes that identify a node (pod?, data)
    model_axis: Optional[str]        # tensor-parallel axis within a node
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, like ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def model_size(self) -> int:
        if self.model_axis is None:
            return 1
        return self.shape[self.model_axis]


def make_context(axis_shapes: Sequence[int], axis_names: Sequence[str],
                 device=None) -> MeshContext:
    """The canonical context for node axes ``axis_names`` of sizes
    ``axis_shapes``, on ``device`` (``None`` means CUDA, and raises
    without a card; the CPU tests pass ``device="cpu"``).

    As in the JAX package, ``pod`` and ``data`` identify a node and
    ``model`` is the axis inside one."""
    names = tuple(axis_names)
    sizes = tuple(int(s) for s in axis_shapes)
    if len(names) != len(sizes) or len(set(names)) != len(names):
        raise ValueError(f"axes {names} do not match sizes {sizes}")
    if "data" not in names or any(s < 1 for s in sizes):
        raise ValueError(f"need a 'data' axis and sizes >= 1, got "
                         f"{dict(zip(names, sizes))}")
    batch_axes = tuple(a for a in names if a in ("pod", "data"))
    model_axis = "model" if "model" in names else None
    return MeshContext(axis_names=names, axis_sizes=sizes,
                       batch_axes=batch_axes, model_axis=model_axis,
                       device=resolve_device(device))
