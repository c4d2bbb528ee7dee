"""The ReCXL replication engine, on one card and across ranks.

The JAX package's ``core/replication.py`` maps the paper's write
replication onto a device mesh: each node's per-step state-shard update
is split into ``n_buckets`` coalescing buckets (the SB-entry analogue);
REPL is a ``ppermute`` of each bucket along the ``data`` axis to the N_r
hash-selected replica nodes, which deposit it into their log ring
(allocation == REPL reception); VAL is a second, tiny ``ppermute`` of
the logical timestamp (the step), whose reception sets the entry's
valid bit.

On one card the node axes are the leading dimensions of every per-node
tensor, in the context's axis order (:mod:`repro_torch.distributed.context`),
and the log ring is laid out as the JAX package's ``log_struct`` gives
it: ``values (*nodes, N_r, capacity, n_buckets, bucket_len)``, ``ts`` and
``valid (*nodes, N_r, capacity, n_buckets)``. ``replicate`` runs the
JAX region's collectives (:mod:`repro_torch.distributed.collectives`)
over the nodes taken in joined, pod-major order (``pod * n_data +
data``, as ``ppermute`` over the axis tuple numbers them): a
``ppermute`` with pairs ``(s, (s + off) % n)`` on each ring delivers
node ``d`` the payload of node ``(d - off) % n``, written straight into
the ring slot. With ``cross_pod_replicas`` on a mesh with a ``pod``
axis the ring is ``("pod", "data")`` joined; otherwise each pod has a
ring of its own. :meth:`node_coord` and :meth:`ring_index` map ring
indices to node coordinates and back, for recovery and the trainer.
The VAL carries the same step from every node, so its reception writes
``ts = step`` and ``valid = True`` into the slot.

The three protocol variants (``baseline`` / ``parallel`` /
``proactive``) differ in the JAX package only in their dependency
structure: barriers that tie each REPL to the commit or to the previous
REPL, whose overlap XLA's scheduler realizes. The barriers never change
a value, and eager torch runs in program order, so every variant writes
the same ring here as there. The variants' overlap is a scheduling
property, which this port does not model on the card.

``coalescing=True`` gives all buckets of a replica rank one offset (one
large copy per rank); ``False`` keeps per-bucket hash offsets. The
beyond-paper ``parity`` mode stores one erasure-coded shard per group
of ``parity_group`` nodes outside the group.

Unlike the JAX engine, which returns a new ring each step, the port
writes the ring in place: at the paper's width the ring is 19.2 GB.

**Across ranks.** With a rank-aware context (a ``torch.distributed``
group, :func:`repro_torch.distributed.context.node_group`) each rank
holds a block of whole nodes, and every per-node tensor -- the ring,
the payloads, :meth:`ReplicationEngine.local_blocks` -- covers only
those: ``values (*local nodes, N_r, capacity, n_buckets, bucket_len)``
(the ring is 19.2 GB / world a rank at paper width). The same
collectives then move data between ranks: in each ``ppermute`` the
pairs whose nodes one rank holds are slice copies and the rest one
``batch_isend_irecv``; each replica rank's VAL follows once its REPLs
arrived, and a node's ``ts`` / ``valid`` are written only where a VAL
was received; parity is a grouped ``psum`` and a ``ppermute`` to the
holder. Without a group every pair is local and no ``torch.distributed``
call is made. The three variants still write one ring.

**Across ranks that split ``model``** (``make_context(...,
split_model=True)``) a rank holds one ``model`` position of a block of
nodes, and its parameters are ``sharding.Shard`` blocks. Its ring is the
JAX package's global ring at its block and position, ``values (*local
nodes, 1, N_r, capacity, n_buckets, bucket_len)``; its payload of each
local node is that node's part of each ``Shard.local``
(``sharding.node_part``: the node's storage part of a dimension over
(pod, data), whole along one ``model`` splits) and every replicated
leaf whole -- the block the reference's region gets on that (node,
position) device. REPL, VAL and parity run between the ranks at the
rank's position (the FSDP group, ``MeshContext.rank_of``), as the
reference's region runs its ``data``-axis collectives at each ``model``
coordinate apart.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import ReplicationConfig
from repro_torch.core import replica_groups
from repro_torch.core.directory import ShardDirectory
from repro_torch.distributed import collectives, sharding
from repro_torch.distributed.context import MeshContext, P

LogState = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Trees of tensors (the JAX package's pytrees: dicts in sorted-key order)
# ---------------------------------------------------------------------------

def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """Leaves of ``tree`` in ``jax.tree.flatten`` order (dicts by sorted
    key, lists and tuples in order; a :class:`P` is a leaf) and the
    structure to rebuild it."""
    if isinstance(tree, P):
        return [tree], None
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
        return [x for p in parts for x in p[0]], \
            ("dict", tuple(keys), tuple(p[1] for p in parts),
             tuple(len(p[0]) for p in parts))
    if isinstance(tree, (list, tuple)):
        parts = [tree_flatten(x) for x in tree]
        return [x for p in parts for x in p[0]], \
            (type(tree), None, tuple(p[1] for p in parts),
             tuple(len(p[0]) for p in parts))
    return [tree], None


def tree_unflatten(treedef: Any, leaves: Sequence[Any]) -> Any:
    """Inverse of :func:`tree_flatten`."""
    if treedef is None:
        (leaf,) = leaves
        return leaf
    kind, keys, subs, counts = treedef
    out, pos = [], 0
    for sub, n in zip(subs, counts):
        out.append(tree_unflatten(sub, leaves[pos:pos + n]))
        pos += n
    if kind == "dict":
        return dict(zip(keys, out))
    return kind(out)


class TensorSpec(NamedTuple):
    """Shape and dtype of one log-ring tensor (``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class EngineLayout:
    """Static facts about the replicated payload.

    Leaves are assigned to buckets by greedy size-balanced bin packing;
    each bucket packs a *subset of leaves* (not a slice of the
    concatenated update), as in the JAX package, so the layout -- and
    with it the log ring -- is the same bytes in both packages.
    """
    local_sizes: Tuple[int, ...]        # flattened size of each local leaf
    treedef: Any
    local_shapes: Tuple[Tuple[int, ...], ...]
    bucket_of_leaf: Tuple[int, ...]     # leaf index -> bucket id
    leaves_in_bucket: Tuple[Tuple[int, ...], ...]
    bucket_len: int                     # max padded bucket payload length
    n_buckets: int


class ReplicationEngine:
    """One engine per run; stateless apart from its static layout.

    ``param_specs`` is a tree of :class:`P` matching ``global_params``
    (a tree of tensors, or of anything with a ``.shape``: across ranks
    that split ``model``, the tree of ``Shard``s and replicated tensors,
    whose ``.shape`` is the global one)."""

    def __init__(self, rep: ReplicationConfig, ctx: MeshContext,
                 param_specs: Any, global_params: Any):
        self.rep = rep
        self.ctx = ctx
        self.mesh_axes = ctx.axis_names
        # replication runs along the data axis (one ring per pod) unless
        # cross_pod_replicas joins (pod, data) into one ring
        if rep.cross_pod_replicas and "pod" in self.mesh_axes:
            if self.mesh_axes.index("data") != \
                    self.mesh_axes.index("pod") + 1:
                raise ValueError(
                    f"the cross-pod ring needs 'pod' and 'data' adjacent, "
                    f"pod first; the axes are {self.mesh_axes}")
            self.repl_axes: Tuple[str, ...] = ("pod", "data")
        else:
            self.repl_axes = ("data",)
        self.n_nodes = int(np.prod([ctx.shape[a] for a in self.repl_axes]))
        if rep.is_replicating and rep.n_replicas >= self.n_nodes:
            raise ValueError("n_replicas must be < replication ring size")
        self.param_specs = param_specs
        self._spec_leaves, _ = tree_flatten(param_specs)
        leaves, _ = tree_flatten(global_params)
        self._global_shapes = tuple(tuple(x.shape) for x in leaves)
        self.layout = self._layout(global_params, param_specs)
        self.log_dtype = getattr(torch, rep.log_dtype)
        if rep.is_replicating and \
                ctx.axis_names[:len(ctx.batch_axes)] != ctx.batch_axes:
            raise ValueError(f"the node axes {ctx.batch_axes} must lead, "
                             f"pod first; the axes are {ctx.axis_names}")
        self._group_sum = None
        if rep.is_replicating and rep.mode == "parity":
            self._group_sum = collectives.GroupSum(ctx, [
                [base + n for n in g] for base in self._ring_bases()
                for g in self.parity_groups()])

    # ------------------------------------------------------------------
    @property
    def _lead(self) -> Tuple[int, ...]:
        """The leading node dimensions of this rank's tensors: its block
        of every axis (one ``model`` position where the ranks split
        it)."""
        return self.ctx.local_sizes

    @property
    def local_model_size(self) -> int:
        """The ``model`` coordinates of this rank's tensors: every one,
        or the rank's one where the ranks split the axis."""
        if self.ctx.model_axis is None:
            return 1
        return self.ctx.local_sizes[
            self.ctx.axis_names.index(self.ctx.model_axis)]

    def node_coord(self, ring: int, pod: int = 0) -> Tuple[int, ...]:
        """Ring index -> the node's ``(pod?, data)`` coordinate. Without
        the cross-pod ring each pod has a ring of its own: ``pod`` says
        which."""
        if not 0 <= ring < self.n_nodes:
            raise ValueError(f"ring index {ring} not in [0, {self.n_nodes})")
        if len(self.repl_axes) == 2:
            return divmod(ring, self.ctx.shape["data"])
        return (pod, ring) if "pod" in self.ctx.batch_axes else (ring,)

    def ring_index(self, coord: Sequence[int]) -> int:
        """A node's ``(pod?, data)`` coordinate -> its ring index."""
        coord = tuple(coord)
        if len(coord) != len(self.ctx.batch_axes):
            raise ValueError(f"a node coordinate names "
                             f"{self.ctx.batch_axes}, got {coord}")
        if len(self.repl_axes) == 2:
            return coord[-2] * self.ctx.shape["data"] + coord[-1]
        return coord[-1]

    def _ring_bases(self) -> List[int]:
        """Joined (pod-major) index of each ring's node 0: one ring over
        every node on the joined ring, else one a pod."""
        n_all = self.ctx.n_nodes
        return list(range(0, n_all, self.n_nodes))

    def joined_index(self, coord: Sequence[int]) -> int:
        """A node's ``(pod?, data)`` coordinate -> its joined, pod-major
        index over every node (the rank layout's numbering)."""
        coord = tuple(coord)
        if len(coord) == 2:
            return coord[0] * self.ctx.shape["data"] + coord[1]
        return coord[-1]

    def local_coord(self, coord: Sequence[int]
                    ) -> Optional[Tuple[int, ...]]:
        """A node's coordinate within this rank's block of the node
        axes (indexes the rank's logs and payloads), or None when
        another rank holds the node."""
        if self.ctx.local_node(self.joined_index(coord)) is None:
            return None
        starts = dict(zip(self.mesh_axes, self.ctx.local_starts))
        return tuple(c - starts[a]
                     for a, c in zip(self.ctx.batch_axes, coord))

    def owner_rank(self, coord: Sequence[int],
                   model_pos: Optional[int] = None) -> int:
        """The rank holding the node at ``coord`` (at ``model`` position
        ``model_pos``, by default this rank's, where the ranks split
        the axis)."""
        return self.ctx.rank_of(self.joined_index(coord), model_pos)

    def _layout(self, global_params: Any, specs: Any) -> EngineLayout:
        mesh_shape = self.ctx.shape
        leaves, treedef = tree_flatten(global_params)
        spec_leaves, _ = tree_flatten(specs)
        if len(spec_leaves) != len(leaves):
            raise ValueError(f"{len(spec_leaves)} specs for {len(leaves)} "
                             f"leaves")
        local_shapes: List[Tuple[int, ...]] = []
        for leaf, spec in zip(leaves, spec_leaves):
            shape = list(leaf.shape)
            for d, ax in enumerate(spec):
                if ax is None:
                    continue
                axes = ax if isinstance(ax, tuple) else (ax,)
                div = int(np.prod([mesh_shape[a] for a in axes]))
                if shape[d] % div:
                    # GSPMD pads uneven dims; the engine replicates the
                    # padded block to keep the blocks uniform.
                    shape[d] = shape[d] + (div - shape[d] % div)
                shape[d] //= div
            local_shapes.append(tuple(shape))
        sizes = tuple(int(np.prod(s)) for s in local_shapes)
        nb = min(self.rep.n_buckets, max(len(sizes), 1))
        # greedy size-balanced bin packing, deterministic
        order = sorted(range(len(sizes)), key=lambda i: -sizes[i])
        loads = [0] * nb
        bucket_of = [0] * len(sizes)
        for i in order:
            b = int(np.argmin(loads))
            bucket_of[i] = b
            loads[b] += sizes[i]
        in_bucket = tuple(tuple(i for i in range(len(sizes))
                                if bucket_of[i] == b) for b in range(nb))
        bucket_len = max(max(loads), 1)
        return EngineLayout(local_sizes=sizes, treedef=treedef,
                            local_shapes=tuple(local_shapes),
                            bucket_of_leaf=tuple(bucket_of),
                            leaves_in_bucket=in_bucket,
                            bucket_len=bucket_len, n_buckets=nb)

    # ------------------------------------------------------------------
    # Log state
    # ------------------------------------------------------------------

    @property
    def _nr(self) -> int:
        """Log-ring replica dim: parity mode stores one shard per group."""
        return 1 if self.rep.mode == "parity" else self.rep.n_replicas

    def log_struct(self) -> Dict[str, TensorSpec]:
        """Shapes and dtypes of the log ring."""
        nr, cap = self._nr, self.rep.log_capacity
        nb, bl = self.layout.n_buckets, self.layout.bucket_len
        lead = self._lead
        return {
            "values": TensorSpec(lead + (nr, cap, nb, bl), self.log_dtype),
            "ts": TensorSpec(lead + (nr, cap, nb), torch.int32),
            "valid": TensorSpec(lead + (nr, cap, nb), torch.bool),
        }

    def init_logs(self) -> LogState:
        """An empty ring on the context's device: values 0, ts -1,
        valid False."""
        dev = self.ctx.device
        out = {}
        for k, s in self.log_struct().items():
            fill = -1 if k == "ts" else 0
            out[k] = torch.full(s.shape, fill, dtype=s.dtype, device=dev)
        return out

    def logs_from_host_arrays(self, values: np.ndarray, ts: np.ndarray,
                              valid: np.ndarray) -> LogState:
        """The ring from host arrays -- e.g. the JAX engine's global log
        ring, ``{k: np.asarray(v)}`` -- as the port's tensors on the
        context's device, so both packages recover from the very same
        logs. Raises ``ValueError`` when a shape or dtype does not match
        :meth:`log_struct`."""
        out = {}
        for k, arr in (("values", values), ("ts", ts), ("valid", valid)):
            spec = self.log_struct()[k]
            arr = np.asarray(arr)
            if tuple(arr.shape) != spec.shape:
                raise ValueError(f"{k} must be {spec.shape}, got "
                                 f"{tuple(arr.shape)}")
            if spec.dtype == torch.bfloat16 and arr.dtype.name == "bfloat16":
                t = torch.from_numpy(np.array(arr, order="C").view(
                    np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(arr, order="C"))
                if t.dtype != spec.dtype:
                    raise ValueError(f"{k} must be {spec.dtype}, got "
                                     f"{arr.dtype}")
            out[k] = t.to(self.ctx.device)
        return out

    def params_from_host_arrays(self, tree: Any) -> Any:
        """A tree of host arrays (e.g. the JAX package's global state,
        ``jax.tree.map(np.asarray, params)``) as tensors on the
        context's device, leaf shapes checked against the engine's."""
        leaves, treedef = tree_flatten(tree)
        shapes = tuple(tuple(np.shape(x)) for x in leaves)
        if shapes != self._global_shapes:
            raise ValueError(f"leaf shapes {shapes} are not the engine's "
                             f"{self._global_shapes}")
        return tree_unflatten(treedef, [
            torch.from_numpy(np.array(x, order="C")).to(self.ctx.device)
            for x in leaves])

    # ------------------------------------------------------------------
    # Local blocks and payload packing
    # ------------------------------------------------------------------

    def local_blocks(self, leaf: torch.Tensor, spec: P) -> torch.Tensor:
        """Every node's block of a global leaf: ``(*nodes, *local_shape)``
        (with a rank-aware context, this rank's nodes only).

        Dimension ``d`` sharded over axes ``(a, b)`` is cut into
        ``size(a) x size(b)`` blocks, major to minor, after zero padding
        to a multiple (GSPMD's padding); node axes the spec does not name
        hold the same block (a broadcast view, no copy)."""
        mesh_shape = self.ctx.shape
        spec = tuple(spec) + (None,) * (leaf.dim() - len(spec))
        x = leaf
        split: List[int] = []
        axis_dim: Dict[str, int] = {}
        local_dims: List[int] = []
        for d, ax in enumerate(spec):
            if ax is None:
                local_dims.append(len(split))
                split.append(x.shape[d])
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            div = int(np.prod([mesh_shape[a] for a in axes]))
            if x.shape[d] % div:
                pad = list(x.shape)
                pad[d] = div - x.shape[d] % div
                x = torch.cat([x, x.new_zeros(pad)], dim=d)
            for a in axes:
                axis_dim[a] = len(split)
                split.append(mesh_shape[a])
            local_dims.append(len(split))
            split.append(x.shape[d] // div)
        x = x.reshape(split)
        present = [a for a in self.mesh_axes if a in axis_dim]
        x = x.permute([axis_dim[a] for a in present] + local_dims)
        for i, a in enumerate(self.mesh_axes):
            if a not in axis_dim:
                x = x.unsqueeze(i)
        lead = self.ctx.axis_sizes
        x = x.expand(lead + tuple(x.shape[len(lead):]))
        for d, (start, n) in enumerate(zip(self.ctx.local_starts,
                                           self.ctx.local_sizes)):
            x = x.narrow(d, start, n)     # this rank's nodes (all: a view)
        return x

    def _fill_bucket(self, dst: torch.Tensor, blocks: Sequence[torch.Tensor],
                     bucket: int, n_lead: int) -> None:
        """Write bucket ``bucket``'s leaves, flattened and concatenated,
        into ``dst (*lead, bucket_len)`` and zero its padding."""
        lay = self.layout
        off = 0
        for i in lay.leaves_in_bucket[bucket]:
            size = lay.local_sizes[i]
            flat = blocks[i].reshape(blocks[i].shape[:n_lead] + (size,))
            dst[..., off:off + size].copy_(flat)
            off += size
        dst[..., off:].zero_()

    def pack_bucket(self, local_leaves: Sequence[torch.Tensor],
                    bucket: int) -> torch.Tensor:
        """Concat bucket ``bucket``'s local leaves, padded to bucket_len."""
        lay = self.layout
        dev = local_leaves[0].device if local_leaves else self.ctx.device
        out = torch.empty(lay.bucket_len, dtype=self.log_dtype, device=dev)
        self._fill_bucket(out, list(local_leaves), bucket, 0)
        return out

    def split_blocks(self, leaf: Any) -> torch.Tensor:
        """Across ranks that split ``model``: each local node's block of
        ``leaf`` at this rank's position, ``(*nodes, *local_shape)``, cut
        from a ``Shard``'s ``local`` (``sharding.node_part``; a view
        where the nodes' parts are consecutive), or a replicated tensor
        whole."""
        ctx = self.ctx
        k = ctx.nodes_per_rank
        if not isinstance(leaf, sharding.Shard):
            x = leaf.expand((k,) + tuple(leaf.shape))
            return x.reshape(self._lead + tuple(leaf.shape))
        cuts = [sharding.node_part(leaf, ctx, ctx.block * k + j)
                for j in range(k)]
        if any(c is None for c in cuts):
            raise ValueError(f"rank {ctx.rank} does not store its nodes' "
                             f"blocks of a leaf of spec {leaf.spec}")
        x = leaf.local
        dims = [d for d, c in enumerate(cuts[0]) if c != slice(None)]
        d = dims[0] if len(dims) == 1 else None
        if not dims:
            x = x.expand((k,) + tuple(x.shape))
        elif d is not None and [c[d].start for c in cuts] == [
                cuts[0][d].start + j * (cuts[0][d].stop - cuts[0][d].start)
                for j in range(k)]:            # consecutive parts: a view
            step = cuts[0][d].stop - cuts[0][d].start
            x = x.narrow(d, cuts[0][d].start, k * step).unflatten(
                d, (k, step)).movedim(d, 0)
        else:
            x = torch.stack([x[c] for c in cuts])
        return x.reshape(self._lead + tuple(x.shape[1:]))

    def payloads(self, updates: Any) -> torch.Tensor:
        """Every node's packed update, ``(*nodes, n_buckets, bucket_len)``
        in the log dtype, from the global tree ``updates`` (across ranks
        that split ``model``, the tree of ``Shard``s and replicated
        tensors: the rank's nodes at its position, :meth:`split_blocks`)."""
        leaves, _ = tree_flatten(updates)
        shapes = tuple(tuple(x.shape) for x in leaves)
        if shapes != self._global_shapes:
            raise ValueError(f"update leaf shapes {shapes} are not the "
                             f"engine's {self._global_shapes}")
        if self.ctx.split_model:
            blocks = [self.split_blocks(x) for x in leaves]
        else:
            blocks = [self.local_blocks(x, s)
                      for x, s in zip(leaves, self._spec_leaves)]
        lay = self.layout
        out = torch.empty(self._lead + (lay.n_buckets, lay.bucket_len),
                          dtype=self.log_dtype, device=blocks[0].device)
        for b in range(lay.n_buckets):
            self._fill_bucket(out[..., b, :], blocks, b, len(self._lead))
        return out

    def unpack_bucket(self, vec: torch.Tensor, bucket: int
                      ) -> Dict[int, torch.Tensor]:
        """Bucket payload -> {leaf_index: local leaf tensor}."""
        lay = self.layout
        out: Dict[int, torch.Tensor] = {}
        off = 0
        for i in lay.leaves_in_bucket[bucket]:
            size, shape = lay.local_sizes[i], lay.local_shapes[i]
            out[i] = vec.reshape(-1)[off:off + size].reshape(shape)
            off += size
        return out

    def unpack(self, buckets: torch.Tensor) -> List[torch.Tensor]:
        """(n_buckets, bucket_len) -> local leaf list (views)."""
        out: List[Any] = [None] * len(self.layout.local_sizes)
        for b in range(self.layout.n_buckets):
            for i, leaf in self.unpack_bucket(buckets[b], b).items():
                out[i] = leaf
        return out

    def unflatten(self, leaves: Sequence[torch.Tensor]) -> Any:
        return tree_unflatten(self.layout.treedef, list(leaves))

    # ------------------------------------------------------------------
    # Offsets / perms
    # ------------------------------------------------------------------

    def parity_groups(self) -> List[List[int]]:
        g = self.rep.parity_group
        if self.n_nodes % g:
            raise ValueError(
                f"parity_group {g} must divide ring size {self.n_nodes}")
        return [list(range(i, i + g)) for i in range(0, self.n_nodes, g)]

    def parity_holder(self, group: int, bucket: int) -> int:
        """Node storing group ``group``'s parity for ``bucket`` -- always
        OUTSIDE the group, and collision-free by construction: every
        group rotates by the same bucket-hashed shift, so distinct groups
        always land in distinct target groups. Pure function of (group,
        bucket), recomputable by recovery."""
        g = self.rep.parity_group
        n_groups = self.n_nodes // g
        if n_groups < 2:
            raise ValueError("parity mode needs >= 2 groups")
        h = replica_groups._hash_int(bucket, self.n_nodes)
        shift = 1 + h % (n_groups - 1)           # same for all groups
        tgt_group = (group + shift) % n_groups
        return tgt_group * g + (h // 7) % g

    def _perm(self, off: int) -> List[Tuple[int, int]]:
        """The REPL ``ppermute``'s pairs by ``off`` over joined node
        indices: every ring rolled by ``off`` (the JAX engine's
        ``_perm``, ``src/repro/core/replication.py:259``, per ring)."""
        n = self.n_nodes
        return [(base + s, base + (s + off) % n)
                for base in self._ring_bases() for s in range(n)]

    def _offsets(self, bucket: int) -> Tuple[int, ...]:
        b = 0 if self.rep.coalescing else bucket
        return replica_groups.replica_offsets(b, self.rep.n_replicas,
                                              self.n_nodes)

    def shard_directory(self) -> ShardDirectory:
        """A directory of this engine's (node, bucket) shards whose
        replica sets are where the engine sends each bucket.

        ``ShardDirectory(n_nodes, n_buckets, n_replicas)`` names each
        bucket's own hash targets. With ``coalescing=True`` the engine
        sends every bucket to bucket 0's targets instead, so recovery
        over the plain directory skips true replicas and reports buckets
        unrecoverable (the JAX package does the same: 4 of 8 buckets of
        a node at 16 nodes and N_r = 3). Without coalescing the two
        directories are equal."""
        d = ShardDirectory(self.n_nodes, self.layout.n_buckets,
                           self.rep.n_replicas)
        for (node, b), e in d.entries.items():
            e.replicas = tuple((node + o) % self.n_nodes
                               for o in self._offsets(b))
        return d

    # ------------------------------------------------------------------
    # In-step replication
    # ------------------------------------------------------------------

    def replicate(self, updates: Any, logs: LogState, step: int,
                  commit_value: Any) -> Tuple[LogState, Any]:
        """Run the REPL/VAL transactions for logical step ``step``.

        ``updates``: the tree of global tensors to replicate -- the new
        state. ``logs`` is updated in place and returned;
        ``commit_value`` is returned as is (the JAX engine ties it to the
        replication's completion, which program order gives here).

        The JAX region (``src/repro/core/replication.py:298-414``) with
        its ``ppermute`` / ``psum`` as collectives over this rank's nodes
        (every node without a group), node-major (``(nodes, [model,]
        ...)``), the ring written in place through views. Across ranks
        that split ``model``, ``updates`` is the tree of the rank's
        ``Shard`` blocks (the step's updated ones) and the collectives
        run at its position.
        """
        if not self.rep.is_replicating:
            return logs, commit_value
        step = int(step)
        ctx = self.ctx
        slot = step % self.rep.log_capacity
        nb = self.layout.n_buckets
        k = ctx.nodes_per_rank
        n_batch = len(ctx.batch_axes)

        def nodes(t: torch.Tensor) -> torch.Tensor:
            return t.view((k,) + tuple(t.shape[n_batch:]))

        payload = nodes(self.payloads(updates))
        lv, lt, lg = (nodes(logs[key]) for key in ("values", "ts", "valid"))

        if self.rep.mode == "parity":
            # psum over each group, then member 0 forwards the parity to
            # the bucket's holder; every other node receives zeros.
            lo = ctx.block * k
            groups = self.parity_groups()
            for b in range(nb):
                par = self._group_sum(payload[..., b, :].float())
                perm = [(base + g[0], base + self.parity_holder(gi, b))
                        for base in self._ring_bases()
                        for gi, g in enumerate(groups)]
                recv = torch.empty_like(par)
                collectives.ppermute(par, recv, perm, ctx)
                lv[..., 0, slot, b, :] = recv.to(lv.dtype)
                holder = torch.zeros(k, dtype=torch.bool)
                for _, t in perm:
                    if ctx.owner(t) == ctx.block:
                        holder[t - lo] = True
                holder = holder.to(lt.device).reshape(
                    (k,) + (1,) * (lt.dim() - 4))
                lt[..., 0, slot, b] = torch.where(
                    holder, torch.full_like(lt[..., 0, slot, b], step),
                    lt[..., 0, slot, b])
                lg[..., 0, slot, b] = holder
            return logs, commit_value

        # REPL: every (rank, bucket) payload into the ring slot
        # (allocation); then that rank's VAL: the step, whose reception
        # writes ts and sets the valid bit.
        ts = torch.full(tuple(lt.shape[:-3]) + (nb,), step,
                        dtype=lt.dtype, device=lt.device)
        for r in range(self._nr):
            if self.rep.coalescing:
                collectives.ppermute(payload, lv[..., r, slot, :, :],
                                     self._perm(self._offsets(0)[r]), ctx)
            else:
                for b in range(nb):
                    collectives.ppermute(payload[..., b, :],
                                         lv[..., r, slot, b, :],
                                         self._perm(self._offsets(b)[r]),
                                         ctx)
            vals = ([(slice(None), self._offsets(0)[r])]
                    if self.rep.coalescing else
                    [(b, self._offsets(b)[r]) for b in range(nb)])
            for b, off in vals:
                got = collectives.ppermute(ts[..., b], lt[..., r, slot, b],
                                           self._perm(off), ctx)
                valid = lg[..., r, slot, b]
                if bool(got.all()):
                    valid.fill_(True)
                else:
                    valid.copy_(got.to(valid.device).reshape(
                        (k,) + (1,) * (valid.dim() - 1)).expand_as(valid))
        return logs, commit_value
