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

On one card the specs do not place tensors: they say which block of
each global tensor a logical node of a :class:`MeshContext` owns, for
the replication engine (``core/replication.py``) and
``install_recovered_shard`` (``distributed/elastic.py``).
``named_shardings`` is the identity: every tensor on ``ctx.device``.
The activation constraints, cache, tile and bank specs of the JAX module
are not ported (identities on one card, or the engine's own layout).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np

from repro_torch.config import ModelConfig
from repro_torch.distributed.context import MeshContext, P


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


def param_specs(params: Any, cfg: ModelConfig, ctx: MeshContext) -> Any:
    """A tree of :class:`P` matching ``params`` (a tree of tensors, or of
    anything with a ``.shape``): dicts by key, ``layers`` /
    ``enc_layers`` lists of per-layer dicts."""
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

    return walk(params, "")


def named_shardings(params: Any, cfg: ModelConfig, ctx: MeshContext) -> Any:
    """The parameters placed by their specs: on one card, every tensor on
    ``ctx.device`` (the identity when they are there already)."""
    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(x) for x in node)
        return node.to(ctx.device)

    return walk(params)
