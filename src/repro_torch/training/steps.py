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
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.config import RunConfig
from repro_torch.core.replication import ReplicationEngine
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


def init_train_state(run: RunConfig, model: Model, seed: int,
                     engine: Optional[ReplicationEngine],
                     device=None, params: Any = None) -> TrainState:
    """Weights from ``model.init(seed, device)`` (or ``params``, made
    leaves that require grad), the optimizer's state, an empty log ring
    for the replicating variants and a staging buffer for
    ``writethrough``."""
    if params is None:
        params = model.init(seed, device=device)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    opt_init, _ = make_optimizer(run.train)
    logs = engine.init_logs() if engine is not None and \
        run.replication.is_replicating else {}
    wt = None
    if run.replication.variant == "writethrough":
        wt = tree_map(lambda x: torch.zeros_like(x, dtype=torch.bfloat16,
                                                 requires_grad=False), params)
    return TrainState(params=params, opt_state=opt_init(params), logs=logs,
                      step=0, wt_buffer=wt)


def make_train_step(run: RunConfig, model: Model,
                    engine: Optional[ReplicationEngine]
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Tuple[TrainState, Dict[str, Any]]]:
    _, opt_update = make_optimizer(run.train)
    schedule = make_schedule(run.train)
    rep = run.replication
    remat = run.train.remat

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, Any]]:
        leaves = tree_leaves(state.params)
        for p in leaves:
            p.grad = None
        loss, metrics = model.loss_fn(state.params, batch, remat=remat)
        loss.backward()
        grads = tree_map(
            lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
            state.params)
        for p in leaves:
            p.grad = None
        grads, gnorm = clip_by_global_norm(grads, run.train.grad_clip)
        lr = schedule(state.step)
        new_params, new_opt = opt_update(grads, state.opt_state,
                                         state.params, lr)
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
                for dst, src in zip(tree_leaves(wt_buffer),
                                    tree_leaves(new_params)):
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


def make_serve_fns(model: Model):
    """(prefill_fn, decode_fn) for the serving path.

    ``prefill_fn(params, batch, max_len)`` consumes the prompt and returns
    (first_tokens, ServeState): the greedy argmax over the last
    position's logits. ``decode_fn(params, state)`` emits one token per
    sequence against the cache, which it advances in place.
    """
    def prefill_fn(params: Any, batch: Dict[str, torch.Tensor],
                   max_len: Optional[int] = None
                   ) -> Tuple[torch.Tensor, ServeState]:
        logits, cache = model.prefill(params, batch, max_len=max_len)
        toks = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return toks, ServeState(cache=cache, tokens=toks)

    def decode_fn(params: Any, state: ServeState
                  ) -> Tuple[torch.Tensor, ServeState]:
        logits, cache = model.decode_step(params, state.cache, state.tokens)
        toks = torch.argmax(logits, dim=-1).to(torch.int32)
        return toks, ServeState(cache=cache, tokens=toks)

    return prefill_fn, decode_fn
