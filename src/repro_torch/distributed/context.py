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

Across processes a context also carries a ``torch.distributed`` process
group (:func:`node_group`): each of its ``world`` ranks holds a block of
whole nodes -- ``nodes_per_rank`` consecutive nodes of the joined
(``pod``, ``data``) axes, numbered pod-major as the replication ring
numbers them, with all of each node's ``model`` positions -- and every
per-node tensor of that rank carries only its own nodes
(``local_sizes``). The JAX package's ``shard_map`` regions map onto the
collectives of :mod:`repro_torch.distributed.collectives`. Without a
group the context holds every node, as on one card.

With ``split_model=True`` the ranks split the ``model`` axis too: a
rank holds a block of whole nodes at ONE ``model`` position, the ranks
numbered model-minor (``rank = block * m + position``). Each rank then
has its ``model`` group (the ``m`` ranks of its node block, which share
its nodes and sum the tensor-parallel partials) and its FSDP group (the
ranks at its ``model`` position, which share the storage-sharded
parameter dimensions), both built once, in the same order on every
rank. That is the serving layout of ``launch/serve.py --mesh``. A
batch the node blocks do not divide is served whole on every rank, and
its KV caches split their sequence over the blocks instead
(``sharding.cache_span``).

The JAX package finds its mesh through a module-level context
(:func:`set_mesh_context` / :func:`get_mesh_context` /
:func:`mesh_context`, ``src/repro/distributed/context.py:44-60``); the
port keeps the same three functions, which the ``Trainer`` and the
serve path set and the models read.

The streaming engine's ``cells`` axis needs no process group: one
process places each shard on a device of its own
(:func:`cells_devices`).
"""

from __future__ import annotations

import contextlib
import datetime
import os
import weakref
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

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
    group: Any = None                # torch.distributed group, or None
    world: int = 1
    rank: int = 0
    local_sizes: Tuple[int, ...] = ()   # this rank's block of each axis
    local_starts: Tuple[int, ...] = ()  # ... and where it starts
    split_model: bool = False        # a rank holds one model position
    model_group: Any = None          # the ranks of this rank's nodes
    fsdp_group: Any = None           # the ranks at its model position
    #: the global rows of the batch being served, set for each call by the
    #: serve fns (``sharding.serving``): whether a rank's rows are a block
    #: of the batch or the whole of it, which its rows alone cannot say
    serve_rows: Optional[int] = None

    def __post_init__(self) -> None:
        if not self.local_sizes:          # no group: every node is local
            object.__setattr__(self, "local_sizes", tuple(self.axis_sizes))
            object.__setattr__(self, "local_starts",
                               (0,) * len(self.axis_sizes))

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, like ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def n_nodes(self) -> int:
        """Nodes of the joined (pod?, data) axes."""
        return int(np.prod([self.shape[a] for a in self.batch_axes]))

    @property
    def n_blocks(self) -> int:
        """Node blocks over the ranks: the world, or with the model axis
        split over ranks the world over the model size."""
        return self.world // self.model_size if self.split_model \
            else self.world

    @property
    def block(self) -> int:
        """This rank's node block."""
        return self.rank // self.model_size if self.split_model \
            else self.rank

    @property
    def model_rank(self) -> int:
        """This rank's ``model`` position when the ranks split the axis,
        else 0 (the rank holds every position)."""
        return self.rank % self.model_size if self.split_model else 0

    @property
    def nodes_per_rank(self) -> int:
        return self.n_nodes // self.n_blocks

    def owner(self, node: int) -> int:
        """The node block (the rank, unless the ranks split ``model``)
        holding joined (pod-major) node index ``node``."""
        return node // self.nodes_per_rank

    def rank_of(self, node: int, model_pos: Optional[int] = None) -> int:
        """The rank holding joined (pod-major) node index ``node`` at
        ``model`` position ``model_pos`` (default: this rank's): its node
        block, or, when the ranks split ``model``, ``block * m +
        model_pos``. The one place that says how ranks are laid out over
        nodes; the REPL / VAL peers, the parity groups, recovery's
        broadcasts and the Configuration Manager's rank read it."""
        block = self.owner(node)
        if not self.split_model:
            return block
        pos = self.model_rank if model_pos is None else model_pos
        return block * self.model_size + pos

    def local_node(self, node: int) -> Optional[int]:
        """``node``'s index among this rank's nodes, or None."""
        i = node - self.block * self.nodes_per_rank
        return i if 0 <= i < self.nodes_per_rank else None

    @property
    def model_size(self) -> int:
        if self.model_axis is None:
            return 1
        return self.shape[self.model_axis]


_CURRENT: Optional[MeshContext] = None


def set_mesh_context(ctx: Optional[MeshContext]) -> None:
    """Make ``ctx`` the context the models read (``None``: no mesh)."""
    global _CURRENT
    _CURRENT = ctx


def get_mesh_context() -> Optional[MeshContext]:
    return _CURRENT


@contextlib.contextmanager
def mesh_context(ctx: Optional[MeshContext]) -> Iterator[
        Optional[MeshContext]]:
    """``ctx`` as the models' context for the length of a ``with``."""
    prev = get_mesh_context()
    set_mesh_context(ctx)
    try:
        yield ctx
    finally:
        set_mesh_context(prev)


def cells_devices(n_shards: int, devices=None,
                  device=None) -> Tuple[torch.device, ...]:
    """The placements of the evaluation's ``cells`` shards, the port's
    counterpart of the JAX package's ``cells_mesh``
    (``src/repro/distributed/context.py:103-116``), in one process.

    ``devices=None`` gives one placement, ``device`` (``None`` means
    CUDA): every logical shard on it, contiguous. ``devices`` holds one
    entry (that one placement) or exactly ``n_shards`` entries, shard
    ``s`` on ``devices[s]``; entries may repeat, which is how one card,
    or the CPU, runs the layout of several. ``device`` is not read when
    ``devices`` is given. Each entry resolves through
    :func:`~repro_torch.device.resolve_device` (``"cuda"`` becomes
    ``cuda:<current>``); a CUDA entry without CUDA raises
    ``RuntimeError``, and a card index past ``torch.cuda.device_count()``,
    a length not in {1, ``n_shards``} or ``n_shards < 1`` raise
    ``ValueError``. Nothing falls back."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if devices is None:
        return (resolve_device(device),)
    if isinstance(devices, (str, torch.device)):
        devices = (devices,)
    devices = tuple(devices)
    if len(devices) not in (1, n_shards):
        raise ValueError(f"devices must hold 1 or n_shards={n_shards} "
                         f"placements, got {len(devices)}")
    out = tuple(resolve_device(d) for d in devices)
    for d in out:
        if d.type == "cuda" and d.index >= torch.cuda.device_count():
            raise ValueError(f"placement {d} asked, but torch sees "
                             f"{torch.cuda.device_count()} CUDA devices")
    return out


def make_context(axis_shapes: Sequence[int], axis_names: Sequence[str],
                 device=None, group=None, split_model: bool = False,
                 timeout_s: Optional[float] = None) -> MeshContext:
    """The canonical context for node axes ``axis_names`` of sizes
    ``axis_shapes``, on ``device`` (``None`` means CUDA, and raises
    without a card; the CPU tests pass ``device="cpu"``).

    As in the JAX package, ``pod`` and ``data`` identify a node and
    ``model`` is the axis inside one. With ``group`` (a process group,
    :func:`node_group`) this rank holds ``n_nodes / world`` consecutive
    nodes: the world must divide the joined (pod, data) axes into
    blocks of whole pods or of equal parts of one pod, the node axes must
    lead, pod first, and a CUDA device needs ``nccl``, the CPU ``gloo``
    -- anything else raises ``ValueError``; nothing falls back. With
    ``split_model`` the ranks split the ``model`` axis as well: the world
    must be ``m`` (the model size) times a number of node blocks that
    divides the joined (pod, data) nodes as above; each rank then holds
    one ``model`` position of its block (``model_group`` /
    ``fsdp_group``, whose collectives time out after ``timeout_s``, or
    torch's default for the backend when it is ``None``). The JAX package's ``make_context``
    (``src/repro/distributed/context.py:119``) takes a mesh whose devices
    the ranks stand for here."""
    names = tuple(axis_names)
    sizes = tuple(int(s) for s in axis_shapes)
    if len(names) != len(sizes) or len(set(names)) != len(names):
        raise ValueError(f"axes {names} do not match sizes {sizes}")
    if "data" not in names or any(s < 1 for s in sizes):
        raise ValueError(f"need a 'data' axis and sizes >= 1, got "
                         f"{dict(zip(names, sizes))}")
    batch_axes = tuple(a for a in names if a in ("pod", "data"))
    model_axis = "model" if "model" in names else None
    if group is None:
        return MeshContext(axis_names=names, axis_sizes=sizes,
                           batch_axes=batch_axes, model_axis=model_axis,
                           device=resolve_device(device))
    backend = dist.get_backend(group)
    kind = torch.device("cuda" if device is None else device).type
    if (kind == "cuda") != (backend == "nccl"):
        raise ValueError(f"a {kind} context cannot run on the {backend!r} "
                         f"backend (CUDA needs 'nccl', the CPU 'gloo')")
    if names[:len(batch_axes)] != batch_axes:
        raise ValueError(f"across ranks the node axes {batch_axes} must "
                         f"lead, pod first; the axes are {names}")
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    shape = dict(zip(names, sizes))
    n_nodes = int(np.prod([shape[a] for a in batch_axes]))
    m = shape.get("model", 1)
    if split_model and (model_axis is None or world % m):
        raise ValueError(f"a world of {world} ranks cannot split the model "
                         f"axis of {dict(zip(names, sizes))}")
    blocks = world // m if split_model else world
    if n_nodes % blocks:
        raise ValueError(f"{blocks} node blocks of a world of {world} ranks "
                         f"do not divide the {n_nodes} nodes of "
                         f"{batch_axes}")
    k, n_data = n_nodes // blocks, shape["data"]
    first = (rank // m if split_model else rank) * k
    if k % n_data == 0:                   # whole pods (or the whole ring)
        block = {"data": (0, n_data)}
        if "pod" in shape:
            block["pod"] = (first // n_data, k // n_data)
    elif n_data % k == 0 and "pod" in shape:   # a part of one pod
        block = {"pod": (first // n_data, 1), "data": (first % n_data, k)}
    elif n_data % k == 0:
        block = {"data": (first, k)}
    else:
        raise ValueError(f"{k} nodes a rank cut the pods of {n_data} "
                         f"nodes unevenly")
    groups: Dict[str, Any] = {}
    if split_model:
        block["model"] = (rank % m, 1)
        groups = dict(zip(("model_group", "fsdp_group"),
                          _split_groups(group, world, m, rank,
                                        timeout_s)))
    return MeshContext(
        axis_names=names, axis_sizes=sizes, batch_axes=batch_axes,
        model_axis=model_axis, device=resolve_device(device), group=group,
        world=world, rank=rank,
        local_sizes=tuple(block[a][1] if a in block else s
                          for a, s in zip(names, sizes)),
        local_starts=tuple(block[a][0] if a in block else 0
                           for a in names),
        split_model=split_model, **groups)


#: group -> {(world, m, timeout_s): every rank's (model groups, FSDP
#: groups)}, made once; a destroyed group's entry goes with it
_SPLIT_GROUPS: "weakref.WeakKeyDictionary[Any, Dict]" = \
    weakref.WeakKeyDictionary()


def _split_groups(group, world: int, m: int, rank: int,
                  timeout_s: Optional[float]) -> Tuple[Any, Any]:
    """This rank's (model group, FSDP group) of a world whose ranks split
    ``model`` (model-minor numbering). Every rank builds every group, in
    the same order, the first time a world is split (``dist.new_group``
    is collective); a group of one rank is ``None``."""
    made = _SPLIT_GROUPS.setdefault(group, {})
    key = (world, m, timeout_s)
    if key not in made:
        glob = [dist.get_global_rank(group, r) for r in range(world)]
        kw = ({} if timeout_s is None
              else {"timeout": datetime.timedelta(seconds=timeout_s)})

        def new(ranks):
            return (dist.new_group([glob[r] for r in ranks], **kw)
                    if len(ranks) > 1 else None)

        models = [new(list(range(b * m, (b + 1) * m)))
                  for b in range(world // m)]
        fsdps = [new(list(range(p, world, m))) for p in range(m)]
        made[key] = (models, fsdps)
    models, fsdps = made[key]
    return models[rank // m], fsdps[rank % m]


def node_group(device=None, init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               timeout_s: float = 600.0):
    """The default process group for a node context, initialized once:
    ``nccl`` for a CUDA device (``None`` means the card), ``gloo`` for
    the CPU. ``init_method`` (e.g. ``file:///tmp/pg``) with
    ``world_size`` and ``rank``, or else the ``torchrun`` environment
    (``env://``: ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``). Raises ``ValueError`` if a group of the other
    backend is already up. It stands for the device set the JAX
    package's ``make_mesh`` lays out (``src/repro/distributed/
    context.py:63``)."""
    dev = torch.device("cuda" if device is None else device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"a {dist.get_backend()!r} group is up; a "
                             f"{dev.type} context needs {backend!r}")
        return dist.group.WORLD
    kw: Dict[str, Any] = {
        "init_method": init_method or "env://",
        "timeout": datetime.timedelta(seconds=timeout_s)}
    if world_size is not None:
        kw["world_size"], kw["rank"] = int(world_size), int(rank)
    if backend == "nccl":
        dev = resolve_device(dev if dev.index is not None else torch.device(
            "cuda", int(os.environ.get("LOCAL_RANK", 0))))
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(backend, **kw)
    if backend == "nccl":
        # one collective brings the communicator up before any send/recv
        dist.all_reduce(torch.zeros(1, device=dev))
    return dist.group.WORLD
