"""Top-k MoE with sort-based (dropping) dispatch.

The JAX package's ``models/moe.py`` on torch tensors. The expert
products are ``torch.bmm``, as the JAX package leaves its einsums to
XLA. :func:`moe_apply` reads the module-level mesh context
(``distributed/context.py::get_mesh_context``), as the reference does:

* **no context, or one without a ``model`` axis**: the reference's local
  path, the process's tokens routed at once -- with the shared experts
  added under every context (the reference drops them under a context
  without ``model``: ROADMAP C6);
* **a context with a ``model`` axis**: the reference's ``shard_map``
  body (``src/repro/models/moe.py:192-227``). Each data block of the
  rows is dispatched on its own, its capacity from its own tokens, as
  ``shard_map`` hands each device its block of a batch sharded
  ``P(batch_axes)`` (``sanitize_spec`` may keep fewer axes, or none);
  the aux loss is the blocks' mean (the reference returns block 0's:
  ROADMAP C7). On one card, or across ranks that hold whole nodes, the
  process computes every expert; across ranks that split ``model`` a
  rank computes its experts (EP, ``E % m == 0``: experts ``[e_start,
  e_start + E / m)``) or its ``ff`` slice of every expert (TP), its
  shared experts' ``ff`` slice, and the ``model`` group sums the
  partials, with the reference's ``1 / m`` where the sanitizer left a
  stack unsplit. The reference's ``pmean`` of the aux loss over
  ``model`` has nothing to do here: every rank of the group already
  holds the same aux, from the replicated router and the same tokens.

Across split ranks the expert computation is a region the ``model``
axis partitions, and its gradient needs these sums over the ``model``
group (what GSPMD derives from the reference's ``shard_map``):

* the tokens dispatched to the experts and the shared experts' input
  enter it through ``sharding.enter``, while the router reads the tokens
  as they are: its aux loss is computed whole on every rank, so its
  gradient is whole already;
* the gates enter it too: the combine weighs only the rank's experts
  (or its ``ff`` slice, or ``1 / m`` of an unsplit stack), so a rank's
  gradient of them is its part, which the entry sums; the router's
  gradient is then whole from both terms;
* an expert stack or shared MLP the sanitizer left unsplit is read
  through ``sharding.part_weight`` (each rank's gradient of it is
  ``1 / m`` of the whole);
* the partial output leaves through ``collectives.model_sum``.

Under the ``seq_model`` policy (``seq=True``) the tokens come as this
rank's span of the sequence: the router runs on the span and its
probabilities are gathered whole (every rank routes every token, as
under ``"batch"``), the tokens are gathered once for the routed and the
shared experts, and the partial output is reduce-scattered back to the
span (:func:`moe_apply`).

The port gives the JAX function's answer where torch's primitives
promise less than JAX's:

* **top-k ties**: ``jax.lax.top_k`` puts the lower index first among
  equal probabilities; :func:`top_k_gates` takes the first ``k`` of a
  stable descending sort, which does the same (``torch.topk`` promises
  no order among ties);
* **capacity drops**: pairs are ranked by a stable ``argsort`` of their
  expert and a left-side ``searchsorted``, so the same pairs overflow an
  expert's ``capacity`` and are dropped; a dropped pair writes to a
  spare last row of the dispatch buffer where JAX's ``mode="drop"``
  scatter writes nowhere;
* **the combine**: JAX adds each token's ``k`` weighted expert outputs
  into a zero row in x's dtype, in sorted (expert-ascending) order.
  :func:`combine` gathers each token's contributions in that order and
  adds them one at a time, so a bf16 sum rounds as JAX's does, and the
  result never depends on an atomic ``index_add_``'s order on the card.

:func:`top_k_gates`, :func:`dispatch` and :func:`combine` are
module-level functions that ``_dispatch_and_compute`` looks up at each
call, so a caller can swap one (``chip_smoke.py`` pins routing and
plants faults that way) without a switch in the package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding
from repro_torch.distributed.context import get_mesh_context
from repro_torch.models.layers import (
    Params,
    dense_init,
    dtype_of,
    mlp_apply,
    mlp_init,
)


def _stack_init(gen: torch.Generator, n: int, in_dim: int, out_dim: int,
                dtype: torch.dtype, scale: float = 1.0) -> torch.Tensor:
    """``n`` :func:`dense_init` matrices on a leading expert axis, drawn
    in one call."""
    w = torch.empty((n, in_dim, out_dim), dtype=torch.float32,
                    device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(scale / np.sqrt(in_dim)).to(dtype)


def moe_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Stacked ``(E, d, ff)`` / ``(E, ff, d)`` experts, an f32 router and
    the shared experts fused into one dense MLP of ``ff * n_shared``."""
    dt = dtype_of(cfg)
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.expert_d_ff
    p = {
        "router": dense_init(gen, d, E, torch.float32),
        "w_up": _stack_init(gen, E, d, ff, dt),
        "w_down": _stack_init(gen, E, ff, d, dt,
                              scale=1.0 / np.sqrt(2 * cfg.n_layers)),
    }
    if cfg.mlp == "swiglu":
        p["w_gate"] = _stack_init(gen, E, d, ff, dt)
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(gen, cfg, d_ff=ff * cfg.n_shared_experts)
    return p


# ---------------------------------------------------------------------------
# Routing, dispatch and combine
# ---------------------------------------------------------------------------

def top_k_gates(probs: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gates, expert indices), each ``(T, k)``: the ``k`` largest
    probabilities of each row, the lower index first on a tie, as
    ``jax.lax.top_k`` gives them; the gates renormalised to sum to 1."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate = vals[:, :k]
    return gate / gate.sum(dim=-1, keepdim=True), idx[:, :k]


def dispatch(x_flat: torch.Tensor, idx: torch.Tensor, n_experts: int,
             capacity: int, e_start: int, e_count: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor]:
    """Scatter the (T, d) tokens to their experts' rows.

    Returns (buf, slot, valid, order). ``order`` sorts the ``T * k``
    flat (token, expert) pairs by expert (stable); in that order a pair's
    ``slot`` is its expert's row block plus its rank within the expert,
    and ``valid`` is False for pairs past ``capacity`` or outside experts
    ``[e_start, e_start + e_count)``, whose slot is the spare row
    ``e_count * capacity``. ``buf`` is ``(e_count * capacity + 1, d)``:
    each valid pair's token at its slot, zeros elsewhere, the spare row
    last."""
    K = idx.shape[1]
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(
        sorted_e, torch.arange(n_experts, dtype=sorted_e.dtype,
                               device=idx.device))
    pos = torch.arange(flat_e.numel(), device=idx.device) - starts[sorted_e]
    valid = ((pos < capacity) & (sorted_e >= e_start)
             & (sorted_e < e_start + e_count))
    slot = torch.where(valid, (sorted_e - e_start) * capacity + pos,
                       e_count * capacity)
    buf = x_flat.new_zeros((e_count * capacity + 1, x_flat.shape[1]))
    buf[slot] = x_flat[order // K]
    return buf, slot, valid, order


def combine(out_buf: torch.Tensor, slot: torch.Tensor, valid: torch.Tensor,
            order: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """``(T, d)``: each token's gate-weighted expert outputs added into a
    zero row in ``out_buf``'s dtype, one at a time in sorted order."""
    T, K = gate.shape
    dt = out_buf.dtype
    y = out_buf[torch.where(valid, slot, 0)] * valid[:, None].to(dt)
    contrib = y * gate.reshape(-1)[order].to(dt)[:, None]
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=order.device)
    # a token's pairs in sorted order: its K sorted positions, ascending
    parts = contrib[rank.reshape(T, K).sort(dim=1).values]   # (T, K, d)
    out = torch.zeros((T, out_buf.shape[1]), dtype=dt,
                      device=out_buf.device)
    for j in range(K):
        out = out + parts[:, j]
    return out


def _router_probs(x: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """The router's softmax over the experts, in f32, of ``x`` (..., d)."""
    return torch.softmax((x @ router.to(x.dtype)).float(), dim=-1)


def _dispatch_and_compute(x_flat: torch.Tensor, params: Params,
                          cfg: ModelConfig, e_start: int, e_count: int,
                          w_gate: Optional[torch.Tensor], w_up: torch.Tensor,
                          w_down: torch.Tensor,
                          probs: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based dispatch of (T, d) tokens to experts [e_start,
    e_start + e_count). Returns (partial_out (T, d), aux_loss ()).
    ``w_*`` are the expert stacks ``(e_count, d|ff, ff|d)``. ``probs``,
    given, are the tokens' router probabilities and ``x_flat`` has
    entered the experts' region already (the ``seq_model`` policy)."""
    T, d = x_flat.shape
    E, K = cfg.n_experts, cfg.top_k
    entered = probs is not None
    if probs is None:
        probs = _router_probs(x_flat, params["router"])       # (T, E)
    gate, idx = top_k_gates(probs, K)                         # (T, K)
    # the experts' region: its tokens and gates summed over ``model`` on
    # the way back (the identity without a split ``model`` axis)
    gate = sharding.enter(gate)
    if not entered:
        x_flat = sharding.enter(x_flat)

    # Load-balancing aux loss (Switch): E * sum_e f_e * p_e.
    me = probs.mean(dim=0)
    ce = F.one_hot(idx, E).float().sum(dim=1).mean(dim=0)
    aux = E * torch.sum(me * ce)

    capacity = max(1, int(cfg.capacity_factor * T * K / E))
    buf, slot, valid, order = dispatch(x_flat, idx, E, capacity, e_start,
                                       e_count)
    h = buf[:-1].view(e_count, capacity, d)
    up = torch.bmm(h, w_up)
    if w_gate is not None:
        act = F.silu(torch.bmm(h, w_gate)) * up
    else:
        act = F.gelu(up, approximate="tanh")    # jax.nn.gelu's default
    out_buf = torch.bmm(act, w_down).view(e_count * capacity, d)
    return combine(out_buf, slot, valid, order, gate), aux


def moe_apply(params: Params, x: torch.Tensor, cfg: ModelConfig,
              seq: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss ()): the routed experts,
    then the shared ones added after them; per data block under a
    context with a ``model`` axis (module docstring). The aux loss needs
    no ``model`` collective: it comes from the replicated router and the
    block's tokens, so every rank of the group holds the same value.

    ``seq`` (the ``seq_model`` policy): ``x`` is this rank's span of the
    S positions, and so is ``out``. The router runs on the span (its
    weight's gradient the span's part, summed over ``model``) and its
    probabilities are gathered whole, every rank routing every token as
    before (the gather's backward the span: every rank's gradient of
    them is whole); the tokens are gathered once for the routed and the
    shared experts (the backward reduce-scatters), and the partials are
    reduce-scattered to the span."""
    b, s, d = x.shape
    E = cfg.n_experts
    ctx = get_mesh_context()
    probs = None
    if seq:
        probs = collectives.seq_gather(
            _router_probs(x.reshape(-1, d), sharding.part_weight(
                params["router"])).reshape(b, s, E),
            ctx, summed=False).reshape(-1, E)
        x = sharding.enter(x, seq)
        s = x.shape[1]
    xf = x.reshape(-1, d)
    if ctx is None or ctx.model_axis is None:
        out, aux = _dispatch_and_compute(
            xf, params, cfg, 0, E, params.get("w_gate"), params["w_up"],
            params["w_down"])
        if "shared" in params:
            out = out + mlp_apply(params["shared"], xf, cfg)
        return out.reshape(b, s, d), aux

    n_blocks = _data_blocks(b, ctx)
    m = ctx.model_size
    ep = E % m == 0 and E >= m
    up = params["w_up"]
    e_start, e_count = (sharding.model_block(up, 0, E) if ep else (0, E))
    summed = ctx.split_model and m > 1
    w = sharding.part_weight if summed else sharding.weight
    wg = params.get("w_gate")
    wg, wu, wd = (None if wg is None else w(wg)), w(up), w(params["w_down"])
    outs, auxs = [], []
    pblocks = ([None] * n_blocks if probs is None
               else probs.chunk(n_blocks))
    for blk, pb in zip(xf.chunk(n_blocks), pblocks):
        o, a = _dispatch_and_compute(blk, params, cfg, e_start, e_count,
                                     wg, wu, wd, pb)
        outs.append(o)
        auxs.append(a)
    out = outs[0] if n_blocks == 1 else torch.cat(outs)
    aux = auxs[0] if n_blocks == 1 else torch.stack(auxs).mean()
    if summed and not sharding.model_split(up, 0 if ep else 2):
        out = out / m                      # every rank computed it whole
    if "shared" in params:
        sh = mlp_apply(params["shared"], xf if seq else sharding.enter(xf),
                       cfg, reduce=False, w=w)
        if summed and not sharding.model_split(params["shared"]["w_up"], 1):
            sh = sh / m
        out = out + sh
    out = out.reshape(b, s, d)
    if summed:
        out = sharding.leave(out, seq)
    return out, aux


def _data_blocks(rows: int, ctx) -> int:
    """The data blocks of a process's ``rows``
    (``sharding.local_batch_blocks``): its share of the blocks the
    global batch splits into over the (pod, data) axes, one block where
    it is the whole of a batch they do not divide."""
    return sharding.local_batch_blocks(rows, ctx)
