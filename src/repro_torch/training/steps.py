"""Step functions: train (fwd + bwd + opt + ReCXL replication), eval,
prefill and decode.

The JAX package's ``training/steps.py`` on torch tensors. The train step
is where the paper's mechanism meets the training loop:

    grads  = d(loss)/d(params)           # loss.backward()
    update = optimizer(grads)            # the "store"
    logs'  = REPL/VAL of update -> replica Logging Units (variant-shaped)
    commit = params' usable only after replication validated

``writethrough`` (the paper's WT strawman) instead copies every update
into a bf16 staging buffer, the persistent tier, before the step ends.

The JAX package jits a pure step that returns a new state. Here the
step runs eagerly and updates the parameters, the optimizer state, the
log ring and the staging buffer in place (``optim/optimizers.py``,
``core/replication.py``), and returns the state with ``step`` advanced.
On the card every attention of the forward and of its gradient runs in
the ``flash_attn`` kernels (``kernels/flash_attn/ops.py``).

Data-parallel across ranks (a rank-aware context): each rank's batch is
its nodes' rows of the global batch, and its gradient and loss are
weighted by its share of the loss's tokens and summed over ranks in flat
f32 buckets (``distributed/collectives.py``) before the clip and the
optimizer, so every rank applies the same update to its copy of the
parameters. The token shares make the sum the global token mean, masked
or not (the per-rank means are not averaged). A MoE's load-balancing
term is then the ranks' weighted mean, not the global batch's.

Across ranks that split the ``model`` axis (``ctx.split_model``) the
step runs inside the context and a rank holds its ``sharding.Shard``
blocks, which require grad; the forward's collectives carry their
backward rules (``collectives.model_sum`` / ``model_copy`` /
``model_sum_shared`` / ``fsdp_gather`` / ``model_gather``), so the
backward of the rank's loss, weighted by its node block's token share
(:func:`rank_weight`, over the FSDP group), already sums the partial
gradients over ``model`` and reduce-scatters the gathered leaves over
the FSDP group. What is left is summed over the FSDP group: the leaves
whose storage no gather reduced (``sharding.holders``), and the loss.
The global norm weighs each leaf by one over its holders and sums over
the world; the optimizer updates the blocks (``sharding.locals_of``),
and reads the ``Shard``s where its sums span blocks (Adafactor's
factored moments and RMS clip, ``optim/optimizers.py``).
This stands for the JAX step that GSPMD partitions on the same mesh
(``src/repro/training/steps.py:67-72``). The replicating variants
replicate the rank's updated ``Shard`` blocks, under ``no_grad``, at its
``model`` position (``core/replication.py``); ``writethrough``'s staging
tier is each rank's blocks in bf16.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.config import RunConfig
from repro_torch.core.replication import ReplicationEngine
from repro_torch.distributed import collectives, sharding
from repro_torch.distributed.context import MeshContext, mesh_context
from repro_torch.models.model_zoo import Model
from repro_torch.optim import make_optimizer, make_schedule
from repro_torch.optim.optimizers import (clip_by_global_norm, tree_leaves,
                                          tree_map)


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    logs: Dict[str, torch.Tensor]       # ReCXL replica log rings
    step: int
    wt_buffer: Optional[Any] = None     # writethrough staging tier


def _scope(ctx: Optional[MeshContext]):
    """The models' mesh context for a step over ranks that split
    ``model``; otherwise the caller's, untouched."""
    if ctx is not None and ctx.split_model:
        return mesh_context(ctx)
    return contextlib.nullcontext()


def init_train_state(run: RunConfig, model: Model, seed: int,
                     engine: Optional[ReplicationEngine],
                     device=None, params: Any = None,
                     ctx: Optional[MeshContext] = None) -> TrainState:
    """Weights from ``model.init(seed, device)`` (or ``params``, made
    leaves that require grad: a ``Shard``'s block), the optimizer's
    state (of the blocks, across ranks that split ``model``), an empty
    log ring for the replicating variants and a staging buffer for
    ``writethrough``."""
    if params is None:
        params = model.init(seed, device=device)
    held = sharding.locals_of(params)
    for p in tree_leaves(held):
        p.requires_grad_(True)
    opt_init, _ = make_optimizer(run.train)
    logs = engine.init_logs() if engine is not None and \
        run.replication.is_replicating else {}
    wt = None
    if run.replication.variant == "writethrough":
        wt = tree_map(lambda x: torch.zeros_like(x, dtype=torch.bfloat16,
                                                 requires_grad=False), held)
    with _scope(ctx):
        opt_state = opt_init(held)
    return TrainState(params=params, opt_state=opt_state, logs=logs,
                      step=0, wt_buffer=wt)


def rank_weight(batch: Dict[str, torch.Tensor], ctx: MeshContext) -> float:
    """This rank's share of the global batch's loss tokens: its mask's
    sum over the ranks' (one ``all_reduce``), or, unmasked, 1 / world
    (every rank holds as many rows). Exactly 1.0 on one rank. Across
    ranks that split ``model`` the ``m`` ranks of a node block hold the
    same rows, so the share is its block's: over the FSDP group, 1 /
    ``n_blocks`` unmasked. The JAX package takes the token mean of the
    whole batch (``cross_entropy_loss``,
    ``src/repro/models/layers.py:144``), whose gradient GSPMD sums over
    the shards."""
    group, n = ((ctx.fsdp_group, ctx.n_blocks) if ctx.split_model
                else (ctx.group, ctx.world))
    if "mask" not in batch:
        return 1.0 / n
    n = batch["mask"].float().sum().reshape(1)
    total = collectives.all_reduce(n.clone(), group, "rank_weight")
    return float(n) / float(total)


def make_grad_fn(run: RunConfig, model: Model,
                 ctx: Optional[MeshContext] = None
                 ) -> Callable[[Any, Dict[str, torch.Tensor]],
                               Tuple[torch.Tensor, Dict[str, Any], Any,
                                     torch.Tensor]]:
    """``grad_fn(params, batch) -> (loss, metrics, grads, grad_norm)``:
    the train step's gradient, reduced across the context's ranks and
    clipped by the global norm (``run.train.grad_clip``). ``grads`` is
    shaped as ``params``, or, across ranks that split ``model``, as the
    tree of this rank's blocks (``sharding.locals_of``); the loss and
    the metrics are the global batch's there, the rank's own otherwise."""
    across = ctx is not None and ctx.group is not None
    split = ctx is not None and ctx.split_model
    remat = run.train.remat

    def grad_fn(params: Any, batch: Dict[str, torch.Tensor]):
        if split:
            return _split_grads(params, batch)
        leaves = tree_leaves(params)
        for p in leaves:
            p.grad = None
        loss, metrics = model.loss_fn(params, batch, remat=remat)
        loss.backward()
        grads = tree_map(
            lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
            params)
        for p in leaves:
            p.grad = None
        if across:
            loss = loss.detach().float().reshape(1)
            collectives.all_reduce_sum(tree_leaves(grads) + [loss],
                                       rank_weight(batch, ctx), ctx)
            loss = loss[0]
        grads, gnorm = clip_by_global_norm(grads, run.train.grad_clip)
        return loss, metrics, grads, gnorm

    def _split_grads(params: Any, batch: Dict[str, torch.Tensor]):
        held = sharding.locals_of(params)
        leaves = tree_leaves(held)
        for p in leaves:
            p.grad = None
        weight = rank_weight(batch, ctx)
        with _scope(ctx):
            loss, metrics = model.loss_fn(params, batch, remat=remat)
            (loss * weight).backward()
        grads = tree_map(
            lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
            held)
        for p in leaves:
            p.grad = None
        held_by = [sharding.holders(x, ctx) for x in tree_leaves(params)]
        names = sorted(metrics)
        scalars = torch.stack([loss.detach().float()] + [
            metrics[k].detach().float() for k in names]) * weight
        if ctx.fsdp_group is not None:
            unreduced = [g for g, h in zip(tree_leaves(grads), held_by)
                         if h.blocks > 1 and not h.gathered]
            collectives.all_reduce_sum(unreduced + [scalars], 1.0, ctx,
                                       group=ctx.fsdp_group)
        metrics = dict(zip(names, scalars[1:]))
        grads, gnorm = clip_by_global_norm(
            grads, run.train.grad_clip, [h.ranks for h in held_by],
            ctx.group)
        return scalars[0], metrics, grads, gnorm

    return grad_fn


def make_train_step(run: RunConfig, model: Model,
                    engine: Optional[ReplicationEngine],
                    ctx: Optional[MeshContext] = None
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Tuple[TrainState, Dict[str, Any]]]:
    """The train step; with a rank-aware ``ctx``, data-parallel over its
    ranks (the JAX step under a batch sharded ``P(batch_axes, ...)``,
    ``src/repro/training/trainer.py:109-116``, whose gradient GSPMD
    sums over the batch axes), and, where they split ``model``, inside
    the context with each rank's blocks (module docstring)."""
    split = ctx is not None and ctx.split_model
    grad_fn = make_grad_fn(run, model, ctx)
    _, opt_update = make_optimizer(run.train)
    schedule = make_schedule(run.train)
    rep = run.replication

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, Any]]:
        with _scope(ctx):
            loss, metrics, grads, gnorm = grad_fn(state.params, batch)
            lr = schedule(state.step)
            held = sharding.locals_of(state.params) if split \
                else state.params
            new_params, new_opt = opt_update(
                grads, state.opt_state, held, lr,
                state.params if split else None)
        if split:
            new_params = state.params     # its blocks updated in place
        del grads

        logs = state.logs
        wt_buffer = state.wt_buffer
        if engine is not None and rep.is_replicating:
            with torch.no_grad():
                logs, new_params = engine.replicate(
                    new_params, logs, state.step, new_params)
        elif rep.variant == "writethrough":
            # WT: a synchronous persist of every update into the staging
            # tier before the step ends (the paper's 7.6x path; its cost is
            # the protocol simulator's to quantify)
            with torch.no_grad():
                for dst, src in zip(tree_leaves(wt_buffer), tree_leaves(
                        sharding.locals_of(new_params))):
                    dst.copy_(src)

        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update({"loss": loss.detach(), "grad_norm": gnorm,
                        "lr": lr})
        return TrainState(params=new_params, opt_state=new_opt, logs=logs,
                          step=state.step + 1, wt_buffer=wt_buffer), metrics

    return train_step


def make_eval_step(run: RunConfig, model: Model):
    def eval_step(params: Any, batch: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            loss, metrics = model.loss_fn(params, batch, remat="none")
        return {"loss": loss, **metrics}

    return eval_step


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

class ServeState(NamedTuple):
    cache: Dict[str, Any]
    tokens: torch.Tensor               # last emitted token per sequence (B,)
    rows: Optional[int] = None         # the global batch's rows


def make_serve_fns(model: Model, ctx: Optional[MeshContext] = None):
    """(prefill_fn, decode_fn) for the serving path.

    ``prefill_fn(params, batch, max_len)`` consumes the prompt and returns
    (first_tokens, ServeState): the greedy argmax over the last
    position's logits. ``decode_fn(params, state)`` emits one token per
    sequence against the cache, which it advances in place.

    Under ``ctx`` (set as the models' mesh context for each call) the
    prefill takes this rank's rows of the global ``batch``
    (``sharding.constrain_batch``) and every token is the argmax over the
    logits gathered over ``model`` (``sharding.constrain_logits``): the
    lowest global index on a tie, as ``jnp.argmax`` gives it
    (``src/repro/training/steps.py:126``, ``:132``). The tokens and the
    cache are the rank's rows: a block of the batch, or the whole batch
    where the node blocks do not divide it, and then the caches hold the
    rank's span of the sequence (``sharding.cache_span``). The context
    each call sets carries the global rows (``sharding.serving``; the
    state keeps them as ``rows``).
    """
    def scope(rows: Optional[int]):
        if ctx is None:
            return contextlib.nullcontext()
        return mesh_context(sharding.serving(ctx, rows))

    def greedy(params: Any, logits: torch.Tensor) -> torch.Tensor:
        full = sharding.constrain_logits(logits, params["embed"], ctx)
        return torch.argmax(full, dim=-1).to(torch.int32)

    def prefill_fn(params: Any, batch: Dict[str, torch.Tensor],
                   max_len: Optional[int] = None
                   ) -> Tuple[torch.Tensor, ServeState]:
        rows = batch["tokens"].shape[0]
        with scope(rows):
            batch = {k: sharding.constrain_batch(v, ctx)
                     for k, v in batch.items()}
            logits, cache = model.prefill(params, batch, max_len=max_len)
            toks = greedy(params, logits[:, -1, :])
        return toks, ServeState(cache=cache, tokens=toks, rows=rows)

    def decode_fn(params: Any, state: ServeState
                  ) -> Tuple[torch.Tensor, ServeState]:
        with scope(state.rows):
            logits, cache = model.decode_step(params, state.cache,
                                              state.tokens)
            toks = greedy(params, logits)
        return toks, ServeState(cache=cache, tokens=toks, rows=state.rows)

    return prefill_fn, decode_fn
