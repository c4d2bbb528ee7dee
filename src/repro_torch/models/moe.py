"""Top-k MoE with sort-based (dropping) dispatch.

The JAX package's ``models/moe.py`` on torch tensors: its local path,
which is the whole function on one card (the JAX package takes it
whenever no mesh context is set). The EP / TP ``shard_map`` layouts need
more than one device and wait for the multi-card port (ROADMAP
A4(d)). The expert products are ``torch.bmm``, as the JAX package leaves
its einsums to XLA.

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


def _dispatch_and_compute(x_flat: torch.Tensor, params: Params,
                          cfg: ModelConfig, e_start: int, e_count: int,
                          w_gate: Optional[torch.Tensor], w_up: torch.Tensor,
                          w_down: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based dispatch of (T, d) tokens to experts [e_start,
    e_start + e_count). Returns (partial_out (T, d), aux_loss ()).
    ``w_*`` are the expert stacks ``(e_count, d|ff, ff|d)``."""
    T, d = x_flat.shape
    E, K = cfg.n_experts, cfg.top_k
    logits = (x_flat @ params["router"].to(x_flat.dtype)).float()
    probs = torch.softmax(logits, dim=-1)                     # (T, E)
    gate, idx = top_k_gates(probs, K)                         # (T, K)

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


def moe_apply(params: Params, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss ()): the routed experts,
    then the shared ones added after them."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    out, aux = _dispatch_and_compute(
        xf, params, cfg, 0, cfg.n_experts, params.get("w_gate"),
        params["w_up"], params["w_down"])
    if "shared" in params:
        out = out + mlp_apply(params["shared"], xf, cfg)
    return out.reshape(b, s, d), aux
