"""Logical-axis sharding rules for the parameters.

The parameter half of the JAX package's ``distributed/sharding.py``:
FSDP over (``pod``, ``data``) x tensor-parallel over ``model``, keyed on
parameter path + shape, with its awkward cases (GQA KV projections whose
head count does not divide the model axis, hymba's 25 heads, MoE expert
stacks) handled as there.

The port's tree holds ``layers`` / ``enc_layers`` as lists of per-layer
dicts where the JAX package stacks them on a leading L axis
(``models/model_zoo.py::params_from_jax``). Each per-layer leaf gets the
spec the JAX rule gives its stacked leaf, less the leading ``None``.

On one card, and across ranks that hold whole nodes, the specs do not
place tensors: they say which block of each global tensor a logical
node of a :class:`MeshContext` owns, for the replication engine
(``core/replication.py``) and ``install_recovered_shard``
(``distributed/elastic.py``), and ``named_shardings`` leaves every
tensor whole on ``ctx.device``. When the ranks split the ``model`` axis
(``make_context(..., split_model=True)``) ``named_shardings`` places
blocks: each leaf becomes a :class:`Shard`, this rank's block of the
global tensor by its spec -- the ``model`` entry at its model position,
the (pod, data) entries (FSDP storage) at its node block -- and the
layers take a leaf through :func:`weight`, which all-gathers the storage
dimensions over the FSDP group just in time and keeps the ``model``
split (``src/repro/models/moe.py:177-186`` does the same inside its
``shard_map``; GSPMD does it for every other leaf). For serving and for
training alike: a ``Shard``'s ``local`` may require grad, the gather's
backward then reduce-scatters the gradient over the FSDP group
(``collectives.fsdp_gather``), and :func:`part_weight` / :func:`enter`
mark where a layer enters a region the ``model`` axis partitions.
:func:`holders` is the one place that says how many ranks hold each
element of a leaf, which the gradient reduction and the global norm of
``training/steps.py`` read; :func:`sharers` says which ranks hold the
same block (or rows) of a leaf, which Adafactor's sums across blocks
read; :func:`locals_of` is the tree of blocks the optimizer updates.

The activation rules follow the reference's policy
(:func:`set_activation_policy` / :func:`get_activation_policy`, its
names, values and ``ValueError``). Under ``"batch"`` (the default) the
residual stream is replicated over a node block's ``model`` positions:
a region the axis partitions is entered by ``collectives.model_copy``
and left by ``collectives.model_sum`` (:func:`enter` / :func:`leave`).
Under ``"seq_model"`` (Megatron sequence parallelism), in the split
train step, a 3-D residual activation whose sequence the ``model`` size
divides (:func:`seq_split`) lives between the regions as this rank's
span of the positions: every region is entered by a sequence
all-gather and left by a reduce-scatter (``collectives.seq_gather`` /
``seq_scatter``); a region every rank computes whole (hymba's
attention, an unsplit MLP or vocabulary) keeps the span of its output
(:func:`to_span`), its leaves then read through :func:`part_weight`
(their gradient the span's part, summed over ``model``), and so are the
norms' scales on a span. Serving keeps the batch layout under either
policy (ROADMAP.md, "Contracts").

The serving half of the JAX module's activation rules is here too:
:func:`batch_blocks` (its ``batch_specs`` split of a batch), and the
constraint points :func:`constrain_batch` (a batch input's rows on this
rank: a block of them, or the whole batch where the node blocks do not
divide it, as the sanitized spec keeps it), :func:`constrain_heads` (a
whole-head tensor's heads on this rank) and :func:`constrain_logits`
(the vocab-split logits gathered over ``model``), which are the explicit
places where the port gathers or slices what GSPMD reshards unasked.
Of the JAX module's ``cache_specs`` the port keeps one decision,
:func:`cache_span`: the positions of a serving cache a rank holds -- its
span of the sequence when the blocks do not divide the batch but do
divide the cache (``src/repro/distributed/sharding.py:285-290``, the
B = 1 ``long_500k`` case), else every position. Its heads are what the
rank's layers read (the KV heads of
:func:`~repro_torch.models.attention.local_kv_heads`, the SSD heads and
x channels of :func:`~repro_torch.models.ssm.local_heads`), which is not
always the block that spec gives (ROADMAP.md, "Contracts": the split
serve caches).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.distributed import collectives
from repro_torch.distributed.context import (MeshContext, P,
                                             get_mesh_context)


def _leaf_spec(path: str, ndim: int, cfg: ModelConfig, n_model: int,
               fsdp: Tuple[str, ...], model_ax: Optional[str]) -> P:
    """PartitionSpec for one per-layer (or unstacked) parameter leaf of
    ``ndim`` dimensions."""
    name = path.split("/")[-1]
    m = model_ax

    if ndim <= 1:
        return P(*([None] * ndim))             # scales/biases replicated

    # --- embeddings -------------------------------------------------------
    if name == "tok":
        return P(m, fsdp)                      # vocab TP, d FSDP
    if name == "out":
        return P(fsdp, m)

    # --- MoE expert stacks (E, d, ff) / (E, ff, d) -------------------------
    if path.endswith("moe/w_gate") or path.endswith("moe/w_up"):
        if m and cfg.n_experts % n_model == 0 and cfg.n_experts >= n_model:
            return P(m, None, fsdp)
        return P(None, None, ((m,) if m else ()) + fsdp)
    if path.endswith("moe/w_down"):
        if m and cfg.n_experts % n_model == 0 and cfg.n_experts >= n_model:
            return P(m, fsdp, None)
        return P(None, ((m,) if m else ()) + fsdp, None)
    if path.endswith("moe/router"):
        return P(None, None)
    if "moe/shared" in path:
        if name == "w_down":
            return P(((m,) if m else ()) + fsdp, None)
        return P(None, ((m,) if m else ()) + fsdp)

    # --- attention ---------------------------------------------------------
    heads_tp = m is not None and cfg.n_heads % n_model == 0
    kv_tp = m is not None and cfg.n_kv_heads % n_model == 0
    if name == "wq":
        return P(fsdp, m if heads_tp else None)
    if name in ("wk", "wv"):
        return P(fsdp, m if kv_tp else None)
    if name == "wo":
        return P(m, fsdp) if heads_tp else P(fsdp, None)

    # --- SSD mixer ----------------------------------------------------------
    ssm_tp = m is not None and cfg.ssm_state > 0 and cfg.d_inner % n_model == 0
    if name in ("w_z", "w_x"):
        return P(fsdp, m if ssm_tp else None)
    if name in ("w_B", "w_C", "w_dt"):
        return P(fsdp, None)
    if name == "out_proj":
        return P(m, fsdp) if ssm_tp else P(fsdp, None)
    if name.startswith("conv_w"):
        return P(None, m if (ssm_tp and name == "conv_wx") else None)

    # --- dense MLP -----------------------------------------------------------
    ff_tp = m is not None and (cfg.d_ff % n_model == 0) and cfg.d_ff > 0
    if name in ("w_gate", "w_up"):
        return P(fsdp, m if ff_tp else None)
    if name == "w_down":
        return P(m, fsdp) if ff_tp else P(fsdp, None)

    # default: FSDP the largest dim
    dims = [None] * ndim
    dims[0] = fsdp
    return P(*dims)


def sanitize_spec(spec: P, shape: Sequence[int], ctx: MeshContext) -> P:
    """Reduce sharding on dims the node axes do not divide evenly.

    For tuple entries the longest dividing *prefix* is kept (axes are
    ordered most-important-first by the rules), as in the JAX package,
    whose jit shardings need even divisibility; axis sizes come from
    ``ctx.shape``."""
    sizes = ctx.shape
    dims = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for d, ax in enumerate(dims):
        if ax is None:
            out.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        chosen = None
        for k in range(len(axes), 0, -1):
            n = int(np.prod([sizes[a] for a in axes[:k]]))
            if shape[d] % n == 0:
                chosen = axes[:k] if k > 1 else axes[0]
                break
        out.append(chosen)
    return P(*out)


def param_specs(params: Any, cfg: ModelConfig, ctx: MeshContext,
                prefix: str = "") -> Any:
    """A tree of :class:`P` matching ``params`` (a tree of tensors, or of
    anything with a ``.shape``): dicts by key, ``layers`` /
    ``enc_layers`` lists of per-layer dicts. ``prefix`` is the path of
    a subtree (``"layers"`` for one layer's dict)."""
    fsdp = ctx.batch_axes
    n_model = ctx.model_size
    model_ax = ctx.model_axis

    def walk(node: Any, path: str) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            # a layer list: the index is the JAX package's stacked axis,
            # which is not part of the rule's path
            return type(node)(walk(x, path) for x in node)
        shape = tuple(node.shape)
        spec = _leaf_spec(path, len(shape), cfg, n_model, fsdp, model_ax)
        return sanitize_spec(spec, shape, ctx)

    return walk(params, prefix)


@dataclass(frozen=True)
class Shard:
    """This rank's block of a global parameter: ``local`` is the block,
    ``spec`` the global tensor's (sanitized) spec, ``shape`` its global
    shape. Only a context whose ranks split ``model`` makes these
    (:func:`place`), with what the layers read on every call worked out
    once: ``split``, the dimensions the ``model`` axis splits;
    ``gathers``, each storage-sharded dimension with every node block's
    start in it (none when one block holds the whole storage);
    ``model_pos`` / ``model_size``, the rank's ``model`` position and the
    axis size. In training ``local`` is a leaf that requires grad, and
    the optimizer updates it in place."""
    local: torch.Tensor
    spec: P
    shape: Tuple[int, ...]
    split: Tuple[int, ...] = ()
    gathers: Tuple[Tuple[int, Tuple[int, ...]], ...] = ()
    model_pos: int = 0
    model_size: int = 1


def entry_axes(spec: P, dim: int) -> Tuple[str, ...]:
    """The axes sharding dimension ``dim`` of a spec (``()``: none)."""
    entry = tuple(spec)[dim] if dim < len(spec) else None
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _dim_block(axes: Tuple[str, ...], size: int, ctx: MeshContext,
               block: int, model_pos: int) -> Tuple[int, int]:
    """(start, length) of dimension ``size`` sharded over ``axes`` held
    by node block ``block`` at model position ``model_pos``. The rules
    put ``model`` first and then a prefix of the (pod, data) axes, whose
    flattened index is the joined node index over ``q`` nodes."""
    shape = ctx.shape
    fsdp = tuple(a for a in axes if a != ctx.model_axis)
    if fsdp != ctx.batch_axes[:len(fsdp)] or (
            ctx.model_axis in axes and axes[0] != ctx.model_axis):
        raise ValueError(f"no block rule for a dimension over {axes}")
    parts = int(np.prod([shape[a] for a in fsdp]))
    q = ctx.n_nodes // parts                  # nodes per storage part
    k = ctx.nodes_per_rank
    lo, hi = block * k // q, ((block + 1) * k - 1) // q + 1
    if ctx.model_axis in axes:
        lo, hi = model_pos * parts + lo, model_pos * parts + hi
        parts *= ctx.model_size
    step = size // parts
    return lo * step, (hi - lo) * step


def block_slices(spec: P, shape: Sequence[int], ctx: MeshContext
                 ) -> Tuple[slice, ...]:
    """The slices of a global tensor of ``shape`` that this rank holds
    under ``spec``."""
    out = []
    for d, size in enumerate(shape):
        axes = entry_axes(spec, d)
        if not axes:
            out.append(slice(None))
            continue
        lo, n = _dim_block(axes, size, ctx, ctx.block, ctx.model_rank)
        out.append(slice(lo, lo + n))
    return tuple(out)


def node_part(leaf: "Shard", ctx: MeshContext, node: int
              ) -> Optional[Tuple[slice, ...]]:
    """The slices of ``leaf.local`` that hold joined node ``node``'s
    block at this rank's ``model`` position -- the block the JAX
    package's ``shard_map`` region gets on that (node, position) device
    -- or ``None`` when this rank's node block does not store it. A
    dimension stored over (pod, data) holds the node's storage part
    (``n_nodes / parts`` nodes share a part, ``holders``); one the
    ``model`` axis alone splits, and one nothing splits, are whole."""
    out = []
    for d, size in enumerate(leaf.shape):
        axes = entry_axes(leaf.spec, d)
        fsdp = tuple(a for a in axes if a != ctx.model_axis)
        if not fsdp:
            out.append(slice(None))
            continue
        parts = int(np.prod([ctx.shape[a] for a in fsdp]))
        part = node // (ctx.n_nodes // parts)
        if ctx.model_axis in axes:
            part += ctx.model_rank * parts
            parts *= ctx.model_size
        step = size // parts
        lo, n = _dim_block(axes, size, ctx, ctx.block, ctx.model_rank)
        start = part * step - lo
        if not 0 <= start < n:
            return None
        out.append(slice(start, start + step))
    return tuple(out)


def place(t: torch.Tensor, spec: P, ctx: MeshContext) -> Any:
    """This rank's block of the global tensor ``t``, copied onto
    ``ctx.device``: a :class:`Shard`, or for a spec that shards nothing
    the whole tensor, plain."""
    if not any(entry_axes(spec, d) for d in range(t.dim())):
        return t.to(ctx.device, copy=True)
    blk = t[block_slices(spec, t.shape, ctx)]
    gathers = []
    for d in range(t.dim()):
        axes = entry_axes(spec, d)
        if ctx.n_blocks > 1 and any(a in ctx.batch_axes for a in axes):
            gathers.append((d, tuple(
                _dim_block(axes, t.shape[d], ctx, b, ctx.model_rank)[0]
                for b in range(ctx.n_blocks))))
    return Shard(local=blk.to(ctx.device, copy=True).contiguous(),
                 spec=spec, shape=tuple(t.shape),
                 split=tuple(d for d in range(t.dim())
                             if ctx.model_axis in entry_axes(spec, d)),
                 gathers=tuple(gathers), model_pos=ctx.model_rank,
                 model_size=ctx.model_size)


def named_shardings(params: Any, cfg: ModelConfig, ctx: MeshContext,
                    prefix: str = "") -> Any:
    """The parameters placed by their specs: when the ranks split
    ``model``, every leaf this rank's :class:`Shard` of it (a replicated
    leaf, a norm's scale, stays a plain tensor); otherwise
    every tensor whole on ``ctx.device`` (the identity when they are
    there already). ``prefix`` as for :func:`param_specs`."""
    specs = (param_specs(params, cfg, ctx, prefix) if ctx.split_model
             else None)

    def walk(node: Any, spec: Any) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, None if spec is None else spec[k])
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            specs_ = spec if spec is not None else [None] * len(node)
            return type(node)(walk(x, s) for x, s in zip(node, specs_))
        if spec is None:
            return node.to(ctx.device)
        return place(node, spec, ctx)

    return walk(params, specs)


# ---------------------------------------------------------------------------
# The layers' view of a leaf
# ---------------------------------------------------------------------------

def model_split(leaf: Any, dim: int) -> bool:
    """Whether the ``model`` axis splits dimension ``dim`` of ``leaf``
    over the ranks (a :class:`Shard` whose spec keeps ``model`` there;
    a plain tensor is whole)."""
    return isinstance(leaf, Shard) and dim in leaf.split


def weight(leaf: Any) -> torch.Tensor:
    """The tensor a layer computes with: a plain tensor as it is; a
    :class:`Shard` with its storage (pod, data) dimensions all-gathered
    over the FSDP group (:func:`collectives.fsdp_gather`, whose backward
    reduce-scatters the gradient into the blocks), its ``model`` split
    kept. The rules shard the storage of one dimension a leaf, so one
    gather's backward is the whole FSDP reduction of its gradient."""
    if not isinstance(leaf, Shard):
        return leaf
    t = leaf.local
    if leaf.gathers:
        ctx = get_mesh_context()
        for d, starts in leaf.gathers:
            t = collectives.fsdp_gather(t, d, starts, ctx)
    return t


def enter(x: torch.Tensor, seq: bool = False,
          partial: bool = True) -> torch.Tensor:
    """An activation entering a region whose ranks each compute a part
    (``partial``: the heads, channels, experts or vocabulary the
    ``model`` axis partitions, or this rank's span of a whole-computed
    region's output): a replicated one through
    ``collectives.model_copy`` (its gradient summed over the ``model``
    group on the way back), this rank's span of the sequence (``seq``,
    :func:`seq_split`) gathered whole by ``collectives.seq_gather`` (its
    gradient reduce-scattered back). A span entering a region every rank
    computes whole is gathered with the span of the gradient as its
    backward; a replicated one enters such a region as it is. The
    identity without a split."""
    ctx = get_mesh_context()
    if seq:
        return collectives.seq_gather(x, ctx, summed=partial)
    return collectives.model_copy(x, ctx) if partial else x


def leave(out: torch.Tensor, seq: bool = False) -> torch.Tensor:
    """A row-parallel region's partials made whole: summed over the
    ``model`` group (``collectives.model_sum``), or, where the residual
    stream lives as spans (``seq``), reduce-scattered to this rank's
    span (``collectives.seq_scatter``)."""
    ctx = get_mesh_context()
    if seq:
        return collectives.seq_scatter(out, ctx)
    return collectives.model_sum(out, ctx)


def part_weight(leaf: Any) -> torch.Tensor:
    """:func:`weight` of a leaf used inside a region the ``model`` axis
    partitions: a leaf the axis does not split (a plain tensor, or a
    ``Shard`` stored over the FSDP group only) serves only this rank's
    heads, channels, experts or vocabulary there, so its gradient is
    this rank's part, and it goes through ``collectives.model_copy`` to
    be summed over the ``model`` group; a leaf the axis splits is whole
    on its rank already."""
    t = weight(leaf)
    if isinstance(leaf, Shard) and leaf.split:
        return t
    return collectives.model_copy(t, get_mesh_context())


class Holders(NamedTuple):
    """How many ranks of a split context hold each element of a leaf:
    ``model`` of the ``model`` positions of a block, ``blocks`` of the
    node blocks; ``gathered`` when the leaf's storage is gathered over
    the FSDP group (its gradient then reduced by the gather's
    backward)."""
    model: int
    blocks: int
    gathered: bool

    @property
    def ranks(self) -> int:
        return self.model * self.blocks


def holders(leaf: Any, ctx: MeshContext) -> Holders:
    """The ranks of ``ctx`` (whose ranks split ``model``) holding each
    element of ``leaf``: a plain leaf every rank; a ``Shard`` the ``m``
    positions of its block unless ``model`` splits it, and the node
    blocks that store the same part -- every block when the storage is
    not sharded, ``n_blocks / parts`` when it is sharded over fewer parts
    than blocks (``starts`` repeats), one otherwise."""
    if not isinstance(leaf, Shard):
        return Holders(ctx.model_size, ctx.n_blocks, False)
    model = 1 if leaf.split else ctx.model_size
    if not leaf.gathers:
        return Holders(model, ctx.n_blocks, False)
    parts = len(set(leaf.gathers[0][1]))
    return Holders(model, ctx.n_blocks // parts, True)


def _block_at(leaf: "Shard", ctx: MeshContext, block: int,
              model_pos: int) -> Tuple[Tuple[int, int], ...]:
    """(start, length) of each dimension of ``leaf``'s block on the rank
    of node block ``block`` at ``model`` position ``model_pos``."""
    out = []
    for d, size in enumerate(leaf.shape):
        axes = entry_axes(leaf.spec, d)
        out.append(_dim_block(axes, size, ctx, block, model_pos) if axes
                   else (0, size))
    return tuple(out)


def sharers(leaf: Any, ctx: MeshContext, dims: Sequence[int]) -> int:
    """The ranks of ``ctx``'s world (whose ranks split ``model``) whose
    block of ``leaf`` spans this rank's along each dimension of ``dims``
    (every dimension: the ranks holding the same block). Where several
    ranks add a part of a sum over the dimensions not in ``dims``, each
    weighs its part by one over this count, and the sum over the world
    counts every distinct part once: the one rule Adafactor's factored
    sums across blocks read (``optim/optimizers.py``). A plain leaf is
    whole on every rank."""
    if not isinstance(leaf, Shard):
        return ctx.world
    mine = _block_at(leaf, ctx, ctx.block, ctx.model_rank)
    return sum(all(other[d] == mine[d] for d in dims)
               for other in (_block_at(leaf, ctx, b, p)
                             for b in range(ctx.n_blocks)
                             for p in range(ctx.model_size)))


def locals_of(tree: Any) -> Any:
    """``tree`` with each :class:`Shard` replaced by its ``local`` block:
    the tensors a rank holds and updates (the optimizer's tree, the
    writethrough staging tier's)."""
    if isinstance(tree, dict):
        return {k: locals_of(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(locals_of(v) for v in tree)
    return tree.local if isinstance(tree, Shard) else tree


def model_block(leaf: Any, dim: int, size: int) -> Tuple[int, int]:
    """(start, length) of this rank's ``model`` block of a dimension of
    global ``size`` that ``leaf`` splits over ``model`` (``(0, size)``
    when it does not)."""
    if not model_split(leaf, dim):
        return 0, size
    n = size // leaf.model_size
    return leaf.model_pos * n, n


# ---------------------------------------------------------------------------
# Serving batches
# ---------------------------------------------------------------------------

def batch_blocks(n_rows: int, ctx: MeshContext) -> int:
    """The blocks a batch of ``n_rows`` rows splits into over the
    context's (pod, data) axes, as the JAX package's sanitized
    ``batch_specs`` entry splits its dimension 0
    (``src/repro/distributed/sharding.py:411-416``)."""
    spec = sanitize_spec(P(ctx.batch_axes), (n_rows,), ctx)
    return int(np.prod([ctx.shape[a] for a in entry_axes(spec, 0)]))


def _rows(n_rows: int, ctx: MeshContext) -> Tuple[int, int, int]:
    """(start, count, blocks) of this rank's rows of a global batch of
    ``n_rows``: dimension 0 over the longest dividing prefix of the
    (pod, data) axes (:func:`batch_blocks`), of which this rank's node
    block holds ``blocks``; with no axis left, the whole batch as one
    block."""
    spec = sanitize_spec(P(ctx.batch_axes), (n_rows,), ctx)
    axes = entry_axes(spec, 0)
    if not axes:
        return 0, n_rows, 1
    lo, n = _dim_block(axes, n_rows, ctx, ctx.block, 0)
    return lo, n, n * batch_blocks(n_rows, ctx) // n_rows


def rows_block(n_rows: int, ctx: MeshContext) -> Tuple[int, int]:
    """(start, count) of this rank's rows of a global batch of
    ``n_rows`` (every row without a group)."""
    if ctx.group is None:
        return 0, n_rows
    return _rows(n_rows, ctx)[:2]


def rows_whole(ctx: Optional[MeshContext]) -> bool:
    """Whether this rank serves the whole batch although its context
    spreads the nodes over several blocks: the blocks do not divide the
    batch the serve fns set (:func:`serving`)."""
    return (ctx is not None and ctx.group is not None and ctx.n_blocks > 1
            and ctx.serve_rows is not None
            and batch_blocks(ctx.serve_rows, ctx) == 1)


def local_batch_blocks(rows: int, ctx: MeshContext) -> int:
    """The data blocks among a process's ``rows``, each dispatched on
    its own by the MoE: without a group the blocks of the batch; across
    ranks those of the batch the serve fns set (:func:`serving`) that
    this rank holds, else (the ``Trainer``'s rows) ``rows`` times the
    node blocks' share."""
    if ctx.group is None:
        return batch_blocks(rows, ctx)
    if ctx.serve_rows is not None:
        return _rows(ctx.serve_rows, ctx)[2]
    total = batch_blocks(rows * ctx.n_blocks, ctx)
    if total % ctx.n_blocks:
        raise ValueError(f"{total} data blocks of the global batch do not "
                         f"split over {ctx.n_blocks} node blocks")
    return total // ctx.n_blocks


def serving(ctx: Optional[MeshContext], rows: int
            ) -> Optional[MeshContext]:
    """``ctx`` for serving a global batch of ``rows`` rows (a context
    without a group, or none, as it is)."""
    if ctx is None or ctx.group is None:
        return ctx
    return dataclasses.replace(ctx, serve_rows=int(rows))


def cache_span(length: int, ctx: Optional[MeshContext] = None
               ) -> Tuple[int, int]:
    """(start, count) of the positions of a serving cache's sequence of
    ``length`` positions (``k`` / ``v``; the frames of ``cross_k`` /
    ``cross_v``) that this rank holds. The JAX package's ``cache_specs``
    shards that sequence over the (pod, data) axes exactly when they do
    not divide the batch (:func:`rows_whole`) and do divide ``length``;
    a rank then holds its node block's span, and decode attention merges
    the blocks' partials (``collectives.attn_merge``). Otherwise every
    position. Where only a prefix of (pod, data) divides ``length`` the
    reference splits it partly; the port keeps the whole cache there (a
    layout, not a result, apart)."""
    ctx = ctx or get_mesh_context()
    if not rows_whole(ctx) or length % ctx.n_nodes:
        return 0, length
    n = length // ctx.n_blocks
    return ctx.block * n, n


# ---------------------------------------------------------------------------
# The activation policy
# ---------------------------------------------------------------------------

#: the reference's activation policy
#: (``src/repro/distributed/sharding.py:35-58``): ``"batch"``, the
#: residual stream's rows over (pod, data) only; ``"seq_model"``,
#: Megatron sequence parallelism -- between the regions a 3-D residual
#: activation whose sequence the ``model`` size divides is also split
#: on the sequence over ``model`` (:func:`seq_split`)
_ACTIVATION_POLICY = "batch"


def set_activation_policy(policy: str) -> None:
    """Set the activation policy; ``ValueError`` for another name."""
    global _ACTIVATION_POLICY
    if policy not in ("batch", "seq_model"):
        raise ValueError(policy)
    _ACTIVATION_POLICY = policy


def get_activation_policy() -> str:
    return _ACTIVATION_POLICY


def seq_split(length: int, ctx: Optional[MeshContext] = None) -> bool:
    """Whether a 3-D residual activation of ``length`` global positions
    lives between the regions as this rank's span of the sequence: the
    ``seq_model`` policy, ranks that split ``model`` over more than one
    position, and a ``length`` the ``model`` size divides -- the
    reference's ``P(batch_axes, model, None)``
    (``src/repro/distributed/sharding.py:57-71``). Any other activation
    keeps the batch layout, as there."""
    ctx = ctx or get_mesh_context()
    return (_ACTIVATION_POLICY == "seq_model" and ctx is not None
            and ctx.split_model and ctx.model_group is not None
            and length % ctx.model_size == 0)


def to_span(x: torch.Tensor, seq: bool = True) -> torch.Tensor:
    """``x`` ``(B, S, ...)`` -> this rank's span of dimension 1 under
    ``seq`` (a slice: a whole-computed region's output, an input with no
    gradient); ``x`` otherwise."""
    if not seq:
        return x
    ctx = get_mesh_context()
    n = x.shape[1] // ctx.model_size
    return x.narrow(1, ctx.model_rank * n, n)


# ---------------------------------------------------------------------------
# Activation constraints: where the port gathers or slices
# ---------------------------------------------------------------------------

def constrain_batch(x: torch.Tensor,
                    ctx: Optional[MeshContext] = None) -> torch.Tensor:
    """A global batch input's rows on this rank (:func:`rows_block`):
    dimension 0 split over the node blocks, every rank of a block
    holding the same rows; the whole batch on every rank where the
    blocks do not divide it, and without a group."""
    ctx = ctx or get_mesh_context()
    if ctx is None or ctx.group is None:
        return x
    lo, n = rows_block(x.shape[0], ctx)
    return x[lo:lo + n]


def constrain_heads(x: torch.Tensor,
                    ctx: Optional[MeshContext] = None) -> torch.Tensor:
    """(B, S, H, hd) with every head -> this rank's ``H / m`` heads when
    the ranks split ``model`` and ``m`` divides ``H``; else unchanged."""
    ctx = ctx or get_mesh_context()
    if ctx is None or not ctx.split_model or x.shape[2] % ctx.model_size:
        return x
    n = x.shape[2] // ctx.model_size
    return x[:, :, ctx.model_rank * n:(ctx.model_rank + 1) * n]


def constrain_logits(logits: torch.Tensor, embed: Dict[str, Any],
                     ctx: Optional[MeshContext] = None) -> torch.Tensor:
    """(..., V / m) logits of this rank's vocabulary block -> (..., V),
    all-gathered over the ``model`` group; logits the unembedding made
    whole (``embed``'s vocab leaf not split, e.g. hymba's 32 001) come
    back as they are."""
    ctx = ctx or get_mesh_context()
    leaf = embed["out"] if "out" in embed else embed["tok"]
    if ctx is None or not model_split(leaf, 1 if "out" in embed else 0):
        return logits
    return collectives.model_gather(logits, ctx)
