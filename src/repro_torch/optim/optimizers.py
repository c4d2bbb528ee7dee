"""Optimizers as (init, update) pairs over parameter trees.

The JAX package's ``optim/optimizers.py`` on the port's trees: dicts,
with ``layers`` (and ``enc_layers``) lists of per-layer dicts.

* AdamW -- f32 moments (+ an f32 master copy when ``master_dtype`` is
  not ``param_dtype``), the default.
* Adafactor -- factored second moment and RMS-1 update clipping.
* SGD-momentum -- for completeness / ablations.

Unlike the JAX package, whose updates return new trees, ``update``
writes the optimizer state and the parameters **in place**, under
``torch.no_grad()``, and returns them: at qwen3-0.6b's full width the
state is ~8 GB, and a second copy per step would double it. The
arithmetic is the reference's, in f32, in its order.

AdamW and SGD are elementwise, so their per-layer state is the JAX
package's stacked state sliced by layer. Adafactor is not: the JAX
package factors each *stacked* leaf (a per-layer ``(d,)`` norm scale is
an ``(L, d)`` leaf there, with a second moment shared across layers)
and clips the update by the RMS over all layers. So the port's
Adafactor keeps its ``vs`` tree in the JAX package's stacked layout
(``vs["layers"]`` one dict whose leaves carry the layer axis first) and
updates each list of per-layer leaves as one stacked tensor.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch.config import TrainConfig
from repro_torch.core.replication import tree_flatten, tree_unflatten

OptState = Dict[str, Any]

#: The subtrees whose lists hold one parameter dict per layer.
LAYER_KEYS = ("layers", "enc_layers")


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order: dicts by
    sorted key, lists and tuples in order."""
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and of the trees ``rest`` of
    the same structure)."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def tree_rebuild(template: Any, leaves: List[Any]) -> Any:
    """A tree shaped as ``template`` whose leaves are ``leaves``, given in
    :func:`tree_leaves` order."""
    return tree_unflatten(tree_flatten(template)[1], leaves)


def _zeros_like(tree: Any, dtype: torch.dtype = None) -> Any:
    return tree_map(lambda x: torch.zeros_like(x, dtype=dtype or x.dtype),
                    tree)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32: a 0-d tensor."""
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves))


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """``grads`` scaled by ``min(1, max_norm / max(norm, 1e-6))`` in f32,
    each leaf back in its dtype (new tensors), and the global norm."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-6), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params: Any, cfg: TrainConfig) -> OptState:
    master = getattr(torch, cfg.master_dtype)
    state: OptState = {
        "m": _zeros_like(params, master),
        "v": _zeros_like(params, master),
        "count": 0,
    }
    if cfg.master_dtype != cfg.param_dtype:
        state["master"] = tree_map(lambda x: x.to(master, copy=True), params)
    return state


@torch.no_grad()
def adamw_update(grads: Any, state: OptState, params: Any, lr: float,
                 cfg: TrainConfig) -> Tuple[Any, OptState]:
    b1, b2, eps, wd = cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay
    count = state["count"] + 1
    f32 = torch.float32
    c1 = float(1.0 - torch.tensor(b1, dtype=f32) ** count)
    c2 = float(1.0 - torch.tensor(b2, dtype=f32) ** count)
    lr = float(lr)
    has_master = "master" in state
    ref_leaves = tree_leaves(state["master"] if has_master else params)
    for g, m, v, p, ref in zip(tree_leaves(grads), tree_leaves(state["m"]),
                               tree_leaves(state["v"]), tree_leaves(params),
                               ref_leaves):
        g32 = g.float()
        m.mul_(b1).add_(g32, alpha=1 - b1)
        v.mul_(b2).addcmul_(g32, g32, value=1 - b2)
        step = torch.div(m, c1)
        step.div_(torch.div(v, c2).sqrt_().add_(eps))
        step.add_(ref.float(), alpha=wd).mul_(lr)
        if has_master:
            ref.sub_(step)
            p.copy_(ref)
        else:
            p.copy_(p.float() - step)
    state["count"] = count
    return params, state


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, no first moment)
# ---------------------------------------------------------------------------

def _stacked(tree: Any) -> Any:
    """``tree`` with each ``layers`` list of per-layer dicts as one dict
    of lists (the JAX package's stacked layout, lists in place of the
    leading axis)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k in LAYER_KEYS and isinstance(v, list):
                out[k] = tree_map(lambda *xs: list(xs), v[0], *v[1:])
            else:
                out[k] = _stacked(v)
        return out
    return tree


def _is_stack(x: Any) -> bool:
    return isinstance(x, list) and all(isinstance(t, torch.Tensor)
                                       for t in x)


def _stack_leaves(tree: Any) -> List[Any]:
    """Leaves of a :func:`_stacked` tree, a list of per-layer tensors
    counting as one leaf, in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _stack_leaves(tree[k])]
    return [tree]


def adafactor_init(params: Any, cfg: TrainConfig) -> OptState:
    def factored(x: Any) -> Dict[str, torch.Tensor]:
        lead = (len(x),) if _is_stack(x) else ()
        t = x[0] if _is_stack(x) else x
        shape, dev = lead + tuple(t.shape), t.device
        if len(shape) >= 2:
            return {"vr": torch.zeros(shape[:-1], device=dev),
                    "vc": torch.zeros(shape[:-2] + shape[-1:], device=dev)}
        return {"v": torch.zeros(shape, device=dev)}

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return factored(node)

    return {"vs": walk(_stacked(params)), "count": 0}


@torch.no_grad()
def adafactor_update(grads: Any, state: OptState, params: Any, lr: float,
                     cfg: TrainConfig) -> Tuple[Any, OptState]:
    eps = 1e-30
    count = state["count"] + 1
    beta2t = float(1.0 - (torch.tensor(float(count), dtype=torch.float32)
                          + 1.0) ** -0.8)
    lr, wd = float(lr), cfg.weight_decay

    def upd(g: torch.Tensor, v: Dict[str, torch.Tensor], p: torch.Tensor
            ) -> torch.Tensor:
        g32 = torch.square(g.float()) + eps
        if g.dim() >= 2:
            v["vr"].mul_(beta2t).add_(g32.mean(dim=-1), alpha=1 - beta2t)
            v["vc"].mul_(beta2t).add_(g32.mean(dim=-2), alpha=1 - beta2t)
            vr, vc = v["vr"], v["vc"]
            denom = torch.sqrt(
                vr[..., :, None] * vc[..., None, :]
                / torch.clamp(vr.mean(dim=-1, keepdim=True)[..., None],
                              min=eps))
        else:
            v["v"].mul_(beta2t).add_(g32, alpha=1 - beta2t)
            denom = torch.sqrt(v["v"])
        step = g.float() / torch.clamp(denom, min=1e-12)
        # update clipping (Adafactor's RMS-1 rule)
        rms = torch.sqrt(torch.mean(torch.square(step)) + 1e-12)
        step = step / torch.clamp(rms, min=1.0)
        p32 = p.float()
        return p32 - lr * (step + wd * p32)

    for g, v, p in zip(_stack_leaves(_stacked(grads)),
                       _stack_leaves_v(state["vs"]),
                       _stack_leaves(_stacked(params))):
        if _is_stack(p):
            new = upd(torch.stack(g), v, torch.stack(p))
            for dst, src in zip(p, new.unbind(0)):
                dst.copy_(src)
        else:
            p.copy_(upd(g, v, p))
    state["count"] = count
    return params, state


def _stack_leaves_v(tree: Any) -> List[Dict[str, torch.Tensor]]:
    """The per-leaf ``{vr, vc}`` / ``{v}`` dicts of Adafactor's ``vs``,
    in sorted-key order."""
    if isinstance(tree, dict) and ("vr" in tree or "v" in tree) and all(
            isinstance(x, torch.Tensor) for x in tree.values()):
        return [tree]
    return [x for k in sorted(tree) for x in _stack_leaves_v(tree[k])]


# ---------------------------------------------------------------------------
# SGD momentum
# ---------------------------------------------------------------------------

def sgd_init(params: Any, cfg: TrainConfig) -> OptState:
    return {"mom": _zeros_like(params, torch.float32), "count": 0}


@torch.no_grad()
def sgd_update(grads: Any, state: OptState, params: Any, lr: float,
               cfg: TrainConfig) -> Tuple[Any, OptState]:
    lr = float(lr)
    for g, mo, p in zip(tree_leaves(grads), tree_leaves(state["mom"]),
                        tree_leaves(params)):
        mo.mul_(cfg.beta1).add_(g.float())
        p.copy_(p.float() - lr * mo)
    state["count"] = state["count"] + 1
    return params, state


# ---------------------------------------------------------------------------
# Factory
# ---------------------------------------------------------------------------

def make_optimizer(cfg: TrainConfig) -> Tuple[Callable, Callable]:
    """``(init(params), update(grads, state, params, lr))``; ``update``
    writes ``state`` and ``params`` in place and returns them."""
    if cfg.optimizer == "adamw":
        return (lambda p: adamw_init(p, cfg),
                lambda g, s, p, lr: adamw_update(g, s, p, lr, cfg))
    if cfg.optimizer == "adafactor":
        return (lambda p: adafactor_init(p, cfg),
                lambda g, s, p, lr: adafactor_update(g, s, p, lr, cfg))
    if cfg.optimizer == "sgd":
        return (lambda p: sgd_init(p, cfg),
                lambda g, s, p, lr: sgd_update(g, s, p, lr, cfg))
    raise ValueError(f"unknown optimizer {cfg.optimizer}")
