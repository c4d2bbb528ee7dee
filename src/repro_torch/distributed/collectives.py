"""The collectives of the ReCXL region across ranks.

The JAX package's ``ReplicationEngine.replicate`` runs inside
``shard_map`` and moves data with three ``jax.lax`` calls
(``src/repro/core/replication.py``): ``ppermute`` for REPL, VAL and the
parity forward, and a grouped ``psum`` for parity. Its recovery copies
the global ring to the host, and its ``Trainer`` lets GSPMD sum the
gradient of a batch-sharded loss. Here each is a ``torch.distributed``
call over a rank-aware :class:`~repro_torch.distributed.context.MeshContext`.

Tensors here are node-major: the first dimension is this rank's
``ctx.nodes_per_rank`` nodes, in joined (pod-major) order. A
permutation names nodes by their joined index, as ``ppermute`` names
the devices along its axes. Every rank computes the same plan from the
same permutation, so sends and receives always pair up.

When the ranks split the ``model`` axis, five collectives stand for
what GSPMD inserts into the JAX package's partitioned prefill, decode
and training step: :func:`model_sum`, the ``model``-group sum of a
row-parallel product's partials (the ``psum`` of
``src/repro/models/moe.py:224`` and GSPMD's all-reduce after every
``wo`` / ``w_down`` / ``out_proj``); :func:`model_copy`, the entry of a
replicated tensor into a region the ``model`` axis partitions;
:func:`model_sum_shared`, a ``model``-group sum that every rank then
uses for its own part (the gated norm's sum of squares);
:func:`fsdp_gather`, the FSDP all-gather of a storage-sharded parameter
dimension just in time (``_gather``, ``src/repro/models/moe.py:177-186``);
and :func:`model_gather`, the ``model``-group all-gather of the
vocab-split logits; and under the ``seq_model`` activation policy
(``sharding.seq_split``) Megatron sequence parallelism's pair,
:func:`seq_gather` (a region's entry: the sequence spans all-gathered,
the gradient reduce-scattered back) and :func:`seq_scatter` (its exit:
the partials reduce-scattered to the spans, the gradient all-gathered),
which take ``model_copy``'s and ``model_sum``'s place where the
residual stream lives as spans. Each is a ``torch.autograd.Function`` under grad
mode, its backward the rule GSPMD derives from the forward (each
docstring states it); under ``torch.no_grad()`` each runs exactly the
forward-only call serving has always made. Where a serving cache's
sequence is split over the node blocks (``sharding.cache_span``),
:func:`attn_merge` joins the blocks' decode-attention partials over the
ranks that share a ``model`` position, as GSPMD's partitioned softmax
reductions do over the reference's sequence-sharded cache (serving
only). Each call that moves data adds one to ``COUNTS[name]``, a
backward's under ``name + "_bwd"``; a group of one rank moves nothing
and counts nothing. Under ``remat="full"`` a layer's forward
collectives run again inside the backward, and count again.

Each such call also adds its link bytes to ``BYTES[name]``, under the
reference's ring-effective rules (``collective_bytes``,
``src/repro/launch/costing.py:327-337``), ``out`` the call's output on
this rank and ``n`` its group's ranks: an all-gather ``out (n - 1) /
n``, a reduce-scatter ``out (n - 1)``, an all-reduce ``out 2 (n - 1) /
n``, a permute (REPL, VAL, the parity forward) its payload -- every
node of the rank, as the reference counts a ``collective-permute`` on
every device, whether or not the peer is another rank -- and a
broadcast (recovery's :func:`share`) its payload. Beside the
collectives above they count the train step's other sums:
:func:`all_reduce_sum` (the gradient buckets), ``rank_weight`` (the
loss tokens, ``training/steps.py``), ``grad_norm`` (the global norm's
sum of squares, ``optim/optimizers.py``), Adafactor's three sums across
blocks (``adafactor_factors``, ``adafactor_denom``, ``adafactor_rms``,
``optim/optimizers.py``), the parity shard's
cross-rank sum (``group_sum``) and recovery's tables
(``gather_rows``, ``model_rows``).

Across ranks that split ``model`` the node-indexed collectives
(:func:`ppermute`, :class:`GroupSum`, :func:`gather_rows`,
:func:`share`) run within the FSDP group -- the ranks at this rank's
``model`` position, each holding a block of nodes -- as the reference's
``shard_map`` region runs its ``data``-axis collectives at each
``model`` coordinate; the ranks are named by
``MeshContext.rank_of``, the local node indices by the rank's node
block.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.context import MeshContext

#: flat f32 gradient buckets of about this many bytes, one
#: ``all_reduce`` each (qwen3-0.6b's gradient is ~38 of them). The size
#: is not tuned: on one card the step's reduce is bound by the ~750 small
#: launches of its casts, concatenations and copies back (PERF.md), not
#: by the number of buckets, and no other size was tried.
GRAD_BUCKET_BYTES = 64 << 20

#: calls of the collectives of a split ``model`` axis that moved data,
#: by name; a backward's under the forward's name + ``"_bwd"`` (the
#: backwards of ``model_sum`` and ``model_gather`` move nothing)
COUNTS: Dict[str, int] = {"model_sum": 0, "fsdp_gather": 0,
                          "model_gather": 0, "attn_merge": 0,
                          "model_copy_bwd": 0, "model_sum_shared_bwd": 0,
                          "fsdp_gather_bwd": 0, "all_reduce_sum": 0,
                          "rank_weight": 0, "grad_norm": 0,
                          "adafactor_factors": 0, "adafactor_denom": 0,
                          "adafactor_rms": 0, "seq_gather": 0,
                          "seq_gather_bwd": 0, "seq_scatter": 0,
                          "seq_scatter_bwd": 0,
                          "ppermute": 0, "group_sum": 0, "gather_rows": 0,
                          "model_rows": 0, "share": 0}

#: the link bytes of those calls, by the same names (module docstring)
BYTES: Dict[str, float] = dict.fromkeys(COUNTS, 0.0)


def reset_counts() -> None:
    """Zero ``COUNTS`` and ``BYTES``."""
    for k in COUNTS:
        COUNTS[k] = 0
        BYTES[k] = 0.0


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _size(group: Any) -> int:
    return dist.get_world_size(group)


def _account(name: str, nbytes: float) -> None:
    """One call of ``name`` that moved ``nbytes`` link bytes."""
    COUNTS[name] += 1
    BYTES[name] += float(nbytes)


def _reduced(x: torch.Tensor, group: Any) -> float:
    """An all-reduce's link bytes: ``out 2 (n - 1) / n``."""
    n = _size(group)
    return _nbytes(x) * 2 * (n - 1) / n


def _gathered(out_bytes: float, group: Any) -> float:
    """An all-gather's link bytes: ``out (n - 1) / n``."""
    n = _size(group)
    return out_bytes * (n - 1) / n


def _global(ctx: MeshContext, rank: int) -> int:
    return dist.get_global_rank(ctx.group, rank)


def _runs(pairs: Sequence[Tuple[int, int]]) -> List[Tuple[int, int, int]]:
    """``(src, dst)`` index pairs merged into ``(src0, dst0, n)`` runs in
    which both sides count up by one."""
    out: List[List[int]] = []
    for s, t in pairs:
        if out and (s, t) == (out[-1][0] + out[-1][2],
                              out[-1][1] + out[-1][2]):
            out[-1][2] += 1
        else:
            out.append([s, t, 1])
    return [tuple(r) for r in out]


def ppermute(x: torch.Tensor, out: torch.Tensor,
             perm: Sequence[Tuple[int, int]], ctx: MeshContext
             ) -> torch.Tensor:
    """``out = jax.lax.ppermute(x, axis, perm)`` over joined node indices.

    Stands for the REPL ``ppermute``s (``src/repro/core/replication.py``
    :363 coalesced, :374 per bucket), the VAL's (:395, :403) and the
    parity forward (:333). ``out`` (node-major, any strides, e.g. a slot
    of the log ring) is written in place: pairs whose source and target
    this rank holds become slice copies, merged into runs; the rest go
    in one ``dist.batch_isend_irecv`` of one message per peer rank. Local
    nodes no pair targets get zeros, as ``ppermute`` gives them. Returns
    the bool mask of the local nodes that received, on the host.

    Across ranks that split ``model`` the pairs run between the ranks at
    this rank's ``model`` position (``ctx.rank_of``): the reference's
    region permutes each ``model`` coordinate's block apart."""
    k, me = ctx.nodes_per_rank, ctx.rank
    lo = ctx.block * k
    local: List[Tuple[int, int]] = []
    sends: Dict[int, List[int]] = {}
    recvs: Dict[int, List[int]] = {}
    got = [False] * k
    if ctx.group is not None:
        _account("ppermute", _nbytes(x))
    for s, t in sorted(perm):
        src_rank, dst_rank = ctx.rank_of(s), ctx.rank_of(t)
        if dst_rank == me:
            got[t - lo] = True
            if src_rank == me:
                local.append((s - lo, t - lo))
            else:
                recvs.setdefault(src_rank, []).append(t - lo)
        elif src_rank == me:
            sends.setdefault(dst_rank, []).append(s - lo)
    ops, bufs = [], []
    for peer, idx in sorted(sends.items()):
        buf = x.index_select(0, torch.tensor(idx, device=x.device))
        ops.append(dist.P2POp(dist.isend, buf, _global(ctx, peer),
                              ctx.group))
    for peer, idx in sorted(recvs.items()):
        buf = torch.empty((len(idx),) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        ops.append(dist.P2POp(dist.irecv, buf, _global(ctx, peer),
                              ctx.group))
        bufs.append((idx, buf))
    reqs = dist.batch_isend_irecv(ops) if ops else []
    for s, t, n in _runs(local):
        out.narrow(0, t, n).copy_(x.narrow(0, s, n))
    for i, _, n in _runs([(i, i) for i in range(k) if not got[i]]):
        out.narrow(0, i, n).zero_()
    for r in reqs:
        r.wait()
    for idx, buf in bufs:
        for j, i in enumerate(idx):
            out[i].copy_(buf[j])
    return torch.tensor(got, dtype=torch.bool)


class GroupSum:
    """``jax.lax.psum(x, axis, axis_index_groups=groups)``
    (``src/repro/core/replication.py:329``, the parity shard's sum).

    ``groups`` are lists of joined node indices. Where the groups this
    rank meets are all its own, of one size and in node order (always
    without a group), each is one row of a single reduction over
    ``(group, member)``. Otherwise a group this rank holds alone is
    summed here, in node order, and a group spread over ranks is summed
    here over its local nodes and then with ``dist.all_reduce`` over a
    process group of those ranks, created once (every rank builds the
    same ``GroupSum``, so ``new_group`` runs everywhere in the same
    order), one call per rank set. Across ranks that split ``model``
    each ``model`` position sums over its own ranks (``ctx.rank_of``),
    and every rank builds the process groups of every position, since
    ``new_group`` is collective over the world."""

    def __init__(self, ctx: MeshContext, groups: Sequence[Sequence[int]]):
        self.ctx = ctx
        self.groups = [list(g) for g in groups]
        self.subgroups: Dict[Tuple[int, ...], object] = {}
        positions = range(ctx.model_size) if ctx.split_model else (None,)
        for pos in positions:
            for g in self.groups:
                ranks = tuple(sorted({ctx.rank_of(n, pos) for n in g}))
                if len(ranks) > 1 and ranks not in self.subgroups:
                    self.subgroups[ranks] = dist.new_group(
                        [_global(ctx, r) for r in ranks])
        lo = ctx.block * ctx.nodes_per_rank
        met = [g for g in self.groups if any(ctx.owner(n) == ctx.block
                                             for n in g)]
        sizes = {len(g) for g in met}
        self.tile = (sizes.pop() if len(sizes) == 1 and
                     [n - lo for g in met for n in g]
                     == list(range(ctx.nodes_per_rank)) else 0)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """``x (nodes, ...)`` -> each local node's group sum."""
        if self.tile:
            g = self.tile
            total = x.unflatten(0, (x.shape[0] // g, g)).sum(dim=1)
            return total.repeat_interleave(g, dim=0)
        ctx = self.ctx
        lo = ctx.block * ctx.nodes_per_rank
        out = torch.empty_like(x)
        spread: Dict[Tuple[int, ...], list] = {}   # rank set -> parts
        for g in self.groups:
            mine = [n - lo for n in g if ctx.owner(n) == ctx.block]
            if not mine:
                continue
            part = x[mine[0]].clone()
            for i in mine[1:]:
                part += x[i]
            ranks = tuple(sorted({ctx.rank_of(n) for n in g}))
            if len(ranks) > 1:
                spread.setdefault(ranks, []).append((mine, part))
                continue
            for i in mine:
                out[i] = part
        for ranks in sorted(spread):
            parts = spread[ranks]
            stacked = torch.stack([p for _, p in parts])
            _account("group_sum",
                     _reduced(stacked, self.subgroups[ranks]))
            dist.all_reduce(stacked, group=self.subgroups[ranks])
            for (mine, _), total in zip(parts, stacked):
                for i in mine:
                    out[i] = total
        return out


def gather_rows(rows: np.ndarray, ctx: MeshContext) -> np.ndarray:
    """Small host indices from the ranks that hold them: each rank
    fills the rows of its own nodes and leaves the others 0, and the sum
    over ranks (one ``all_reduce`` of int64) is the whole table on every
    rank, the recovering rank included. Stands for the JAX recovery's
    host copy of the global ring's ``ts`` / ``valid``
    (``src/repro/core/recovery.py:133``, ``:219``), which Algorithm 2
    walks (``:72``). Across ranks that split ``model`` each node's row
    is filled by the ranks of its block, at every position alike, so the
    sum runs over the FSDP group (the blocks at this rank's position)."""
    group = ctx.fsdp_group if ctx.split_model else ctx.group
    return _sum_rows(rows, ctx, group, "gather_rows")


def model_rows(rows: np.ndarray, ctx: MeshContext) -> np.ndarray:
    """Small host indices summed over this rank's ``model`` group (each
    position's part of a node block's table made whole on every
    position; the rows as they are without a split)."""
    return _sum_rows(rows, ctx, ctx.model_group, "model_rows")


def _sum_rows(rows: np.ndarray, ctx: MeshContext, group: Any,
              name: str) -> np.ndarray:
    if ctx.group is None or group is None:
        return rows
    t = torch.from_numpy(np.ascontiguousarray(rows, np.int64)).to(ctx.device)
    _account(name, _reduced(t, group))
    dist.all_reduce(t, group=group)
    return t.cpu().numpy()


def share(x: Optional[torch.Tensor], src: int, shape: Tuple[int, ...],
          dtype: torch.dtype, ctx: MeshContext) -> torch.Tensor:
    """Rank ``src``'s tensor ``x`` on every rank (``dist.broadcast``);
    the others pass ``None`` and the shape and dtype to receive. Stands
    for the JAX recovery's read of a replica's logged version from the
    global ring (``src/repro/core/recovery.py:178``). Across ranks that
    split ``model``, ``src`` is at this rank's position and the
    broadcast runs over the FSDP group."""
    group = ctx.fsdp_group if ctx.split_model else ctx.group
    if ctx.group is None or group is None:
        return x
    buf = (x.contiguous() if ctx.rank == src else
           torch.empty(shape, dtype=dtype, device=ctx.device))
    _account("share", _nbytes(buf))
    dist.broadcast(buf, src=_global(ctx, src), group=group)
    return buf


def all_reduce_sum(tensors: Sequence[torch.Tensor], scale: float,
                   ctx: MeshContext, group: Any = None,
                   name: str = "all_reduce_sum") -> None:
    """Every tensor <- the sum over ranks of ``scale`` x the tensor, in
    place, through flat f32 buckets of ``GRAD_BUCKET_BYTES`` (one
    ``dist.all_reduce`` a bucket, not one a leaf). Stands for the sum
    that GSPMD puts into the gradient of a loss whose batch is sharded
    ``P(batch_axes, ...)`` (``src/repro/training/trainer.py:109-116``).
    A bf16 leaf goes through f32 and back: exact at ``scale`` 1 on one
    rank. ``group`` (default ``ctx.group``): the ranks to sum over, the
    FSDP group when the ranks split ``model``. Counted under ``name``
    (Adafactor's sums across blocks have their own)."""
    group = ctx.group if group is None else group
    bucket: List[torch.Tensor] = []
    size = 0

    def flush() -> None:
        flat = torch.cat([t.reshape(-1).float() for t in bucket])
        if scale != 1.0:
            flat.mul_(scale)
        _account(name, _reduced(flat, group))
        dist.all_reduce(flat, group=group)
        off = 0
        for t in bucket:
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()

    for t in tensors:
        bucket.append(t)
        size += t.numel() * 4
        if size >= GRAD_BUCKET_BYTES:
            flush()
            bucket, size = [], 0
    if bucket:
        flush()


# ---------------------------------------------------------------------------
# Tensor parallelism and FSDP, with their backward rules
# ---------------------------------------------------------------------------

def _tracked(x: torch.Tensor) -> bool:
    """Whether autograd records an op on ``x``."""
    return torch.is_grad_enabled() and x.requires_grad


def _all_reduce(x: torch.Tensor, group: Any, name: str) -> torch.Tensor:
    """``x`` summed over ``group`` in place, counted under ``name``."""
    _account(name, _reduced(x, group))
    dist.all_reduce(x, group=group)
    return x


def all_reduce(x: torch.Tensor, group: Any, name: str) -> torch.Tensor:
    """``x`` summed over ``group`` in place and returned, counted under
    ``name`` (``rank_weight``, ``grad_norm``); a ``None`` group leaves
    it as it is."""
    if group is None:
        return x
    return _all_reduce(x, group, name)


class _ModelSum(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        return _all_reduce(x.clone(), ctx.model_group, "model_sum")

    @staticmethod
    def backward(fctx, g):
        return g, None


class _ModelCopy(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx = ctx
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return _all_reduce(g.clone(), fctx.ctx.model_group,
                           "model_copy_bwd"), None


class _ModelSumShared(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx = ctx
        return _all_reduce(x.clone(), ctx.model_group, "model_sum")

    @staticmethod
    def backward(fctx, g):
        return _all_reduce(g.clone(), fctx.ctx.model_group,
                           "model_sum_shared_bwd"), None


def model_sum(x: torch.Tensor, ctx: MeshContext) -> torch.Tensor:
    """The sum of ``x`` over this rank's ``model`` group: a row-parallel
    product's partials made whole (in place, and returned, under
    ``no_grad``). What follows is replicated, so every rank holds the
    whole gradient of the sum: the backward is the identity (summing it
    over the group would count it ``m`` times)."""
    if ctx is None or ctx.model_group is None:
        return x
    if _tracked(x):
        return _ModelSum.apply(x, ctx)
    return _all_reduce(x, ctx.model_group, "model_sum")


def model_copy(x: torch.Tensor, ctx: MeshContext) -> torch.Tensor:
    """A replicated ``x`` entering a region the ``model`` axis partitions
    (Megatron's "f"): the forward is the identity; each rank's gradient
    covers only its heads, channels, experts or vocabulary block, so the
    backward sums it over the ``model`` group. Also taken by a leaf that
    ``model`` does not split but that a rank uses only in part (its
    gradient is that rank's part)."""
    if ctx is None or ctx.model_group is None or not _tracked(x):
        return x
    return _ModelCopy.apply(x, ctx)


def model_sum_shared(x: torch.Tensor, ctx: MeshContext) -> torch.Tensor:
    """The sum of ``x`` over the ``model`` group, which every rank then
    uses for its own part (the gated norm's sum of squares over
    ``d_inner``, each rank normalising its channels with it): the
    forward sums, and so does the backward, since the sum's gradient is
    every rank's part of it. Counted as ``model_sum`` in the forward."""
    if ctx is None or ctx.model_group is None:
        return x
    if _tracked(x):
        return _ModelSumShared.apply(x, ctx)
    return _all_reduce(x, ctx.model_group, "model_sum")


def _gather(x: torch.Tensor, dim: int, starts: Sequence[int],
            ctx: MeshContext) -> torch.Tensor:
    _account("fsdp_gather",
             _gathered(_nbytes(x) * ctx.n_blocks, ctx.fsdp_group))
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(ctx.n_blocks)]
    dist.all_gather(parts, x, group=ctx.fsdp_group)
    keep = [p for b, p in enumerate(parts)
            if b == 0 or starts[b] != starts[b - 1]]
    return keep[0] if len(keep) == 1 else torch.cat(keep, dim=dim)


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, dim, starts, ctx):
        fctx.dim, fctx.starts, fctx.ctx = dim, tuple(starts), ctx
        return _gather(x, dim, starts, ctx)

    @staticmethod
    def backward(fctx, g):
        dim, starts, ctx = fctx.dim, fctx.starts, fctx.ctx
        unique = sorted(set(starts))
        n = g.shape[dim] // len(unique)
        if len(unique) == len(starts):          # one block a part
            parts = [p.contiguous() for p in g.split(n, dim=dim)]
            out = torch.empty_like(parts[0])
            _account("fsdp_gather_bwd",
                     _nbytes(out) * (_size(ctx.fsdp_group) - 1))
            dist.reduce_scatter(out, parts, group=ctx.fsdp_group)
        else:                                   # parts several blocks hold
            g = g.contiguous().clone()
            _account("fsdp_gather_bwd", _reduced(g, ctx.fsdp_group))
            dist.all_reduce(g, group=ctx.fsdp_group)
            out = g.narrow(dim, unique.index(starts[ctx.block]) * n, n)
        return out, None, None, None


def fsdp_gather(x: torch.Tensor, dim: int, starts: Sequence[int],
                ctx: MeshContext) -> torch.Tensor:
    """Dimension ``dim`` of a storage-sharded parameter block gathered
    over this rank's FSDP group, in node-block order; ``starts[b]`` is
    where block ``b``'s part begins, and a part several blocks hold (a
    dimension the sanitizer split over fewer axes than the blocks) is
    taken once. Each block computes its own rows' loss with the gathered
    tensor, so the backward sums the group's gradients of each part into
    the blocks that hold it: a reduce-scatter where each block holds its
    own part; where several hold the same part, an all-reduce and this
    block's slice, so that every holder gets the group's sum."""
    if ctx.fsdp_group is None:
        return x
    if _tracked(x):
        return _FsdpGather.apply(x, dim, tuple(starts), ctx)
    return _gather(x, dim, starts, ctx)


def _model_gather(x: torch.Tensor, ctx: MeshContext) -> torch.Tensor:
    _account("model_gather",
             _gathered(_nbytes(x) * ctx.model_size, ctx.model_group))
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(ctx.model_size)]
    dist.all_gather(parts, x, group=ctx.model_group)
    return torch.cat(parts, dim=-1)


class _ModelGather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        fctx.n, fctx.pos = x.shape[-1], ctx.model_rank
        return _model_gather(x, ctx)

    @staticmethod
    def backward(fctx, g):
        return g.narrow(-1, fctx.pos * fctx.n, fctx.n), None


def model_gather(x: torch.Tensor, ctx: MeshContext) -> torch.Tensor:
    """The last dimension of ``x`` gathered over this rank's ``model``
    group, in model order (the vocab-split logits made whole). What
    follows (the loss) is replicated, so the backward is this rank's
    slice of the gradient."""
    if ctx.model_group is None:
        return x
    if _tracked(x):
        return _ModelGather.apply(x, ctx)
    return _model_gather(x, ctx)


def _seq_gather(x: torch.Tensor, ctx: MeshContext, name: str
                ) -> torch.Tensor:
    """Dimension 1 of ``x`` gathered over the ``model`` group, in model
    order, counted under ``name``."""
    m = ctx.model_size
    _account(name, _gathered(_nbytes(x) * m, ctx.model_group))
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(m)]
    dist.all_gather(parts, x, group=ctx.model_group)
    return torch.cat(parts, dim=1)


def _seq_scatter(x: torch.Tensor, ctx: MeshContext, name: str
                 ) -> torch.Tensor:
    """The sum of ``x`` over the ``model`` group, each rank keeping its
    span of dimension 1 (a reduce-scatter), counted under ``name``."""
    m = ctx.model_size
    parts = [p.contiguous() for p in x.chunk(m, dim=1)]
    out = torch.empty_like(parts[0])
    _account(name, _nbytes(out) * (_size(ctx.model_group) - 1))
    dist.reduce_scatter(out, parts, group=ctx.model_group)
    return out


def _span(x: torch.Tensor, ctx: MeshContext) -> torch.Tensor:
    n = x.shape[1] // ctx.model_size
    return x.narrow(1, ctx.model_rank * n, n)


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, summed):
        fctx.ctx, fctx.summed = ctx, summed
        return _seq_gather(x, ctx, "seq_gather")

    @staticmethod
    def backward(fctx, g):
        if fctx.summed:
            return _seq_scatter(g, fctx.ctx, "seq_gather_bwd"), None, None
        return _span(g, fctx.ctx), None, None


class _SeqScatter(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx = ctx
        return _seq_scatter(x, ctx, "seq_scatter")

    @staticmethod
    def backward(fctx, g):
        return _seq_gather(g, fctx.ctx, "seq_scatter_bwd"), None


def seq_gather(x: torch.Tensor, ctx: MeshContext,
               summed: bool = True) -> torch.Tensor:
    """Megatron sequence parallelism's entry: ``x`` ``(B, S / m, ...)``,
    this rank's span of the sequence, gathered over the ``model`` group
    to the whole ``(B, S, ...)``. With ``summed`` (a region whose ranks
    each compute a part: its heads, channels, experts or vocabulary, or
    its span of the output) each rank's gradient of the whole is its
    part, so the backward reduce-scatters it: the sum, this rank's span
    (the fused ``model_copy``). Without, every rank's gradient of the
    whole is the same (a replicated computation: the MoE's router, an
    unsplit unembedding), and the backward is this rank's span of it."""
    if ctx is None or ctx.model_group is None:
        return x
    if _tracked(x):
        return _SeqGather.apply(x, ctx, summed)
    return _seq_gather(x, ctx, "seq_gather")


def seq_scatter(x: torch.Tensor, ctx: MeshContext) -> torch.Tensor:
    """Megatron sequence parallelism's exit: a row-parallel product's
    partials ``(B, S, ...)`` summed over the ``model`` group, each rank
    keeping its span ``(B, S / m, ...)`` (the reduce-scatter that takes
    ``model_sum``'s place). Each rank's span is then the whole of its
    positions, so the backward all-gathers the spans' gradients."""
    if ctx is None or ctx.model_group is None:
        return x
    if _tracked(x):
        return _SeqScatter.apply(x, ctx)
    return _seq_scatter(x, ctx, "seq_scatter")


def merge_partials(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor
                   ) -> torch.Tensor:
    """Softmax attention over every block from the blocks' partials,
    stacked on a leading block dimension: each block's row max ``m`` and
    row sum ``l`` ``(P, ...)`` and unnormalised output ``o`` ``(P, ...,
    hd)``, all f32 -> the normalised output ``(..., hd)``, f32. A block
    with no valid position (``m = -inf``, ``l = 0``, ``o = 0``) weighs
    exactly 0; a row where every block is empty has no defined output
    (decode always holds one valid position)."""
    top = m.amax(dim=0)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    w = torch.exp(m - top)                      # exp(-inf) = 0: no NaN
    den = (w * l).sum(dim=0)
    return (w[..., None] * o).sum(dim=0) / den[..., None]


def attn_merge(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
               ctx: MeshContext) -> torch.Tensor:
    """This rank's block partials (``m``, ``l`` ``(...)``, ``o`` ``(...,
    hd)``, f32) joined with those of the ranks at its ``model`` position
    (the FSDP group; the whole group when the ranks do not split
    ``model``): one ``all_gather`` of the three packed together, in
    block order, then :func:`merge_partials`."""
    group = ctx.fsdp_group if ctx.split_model else ctx.group
    if group is None:
        return merge_partials(m[None], l[None], o[None])
    packed = torch.cat([o, m[..., None], l[..., None]], dim=-1).contiguous()
    _account("attn_merge", _gathered(_nbytes(packed) * ctx.n_blocks, group))
    parts = [torch.empty_like(packed) for _ in range(ctx.n_blocks)]
    dist.all_gather(parts, packed, group=group)
    stacked = torch.stack(parts)
    return merge_partials(stacked[..., -2], stacked[..., -1],
                          stacked[..., :-2])
