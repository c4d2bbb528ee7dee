"""Cost accounting for the dry-run: FLOPs and bytes of a step, counted
op by op on the ``meta`` device.

The JAX package walks the traced jaxpr of a step (``jaxpr_cost``),
multiplying scan bodies by their trip counts and ``shard_map`` regions
by the device count, because XLA's own cost analysis counts a loop body
once. The port runs its steps eagerly, so its layer loop, the blockwise
attention's pair walk and the SSD scan's chunk loop run every trip, and
its logical nodes are the leading dimensions of every per-node tensor:
a pass that sees each aten op as it runs counts the trip counts and the
nodes by construction. :func:`step_cost` runs a function under a
``TorchDispatchMode`` on tensors of the ``meta`` device (shapes and
dtypes, no storage, no computation) and counts:

* ``flops``: ``2 m n k`` for ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm``
  and ``2 x out x (in / groups) x kernel`` for convolutions;
* ``bytes``: HBM traffic under the JAX package's fusion model: views and
  dtype casts are free (``_FREE``), every other op writes its outputs
  once, a matmul reads its inputs, the ops that cannot fuse into their
  consumer (``_EXPENSIVE``: reductions, softmax, sort, top-k, cumsum)
  read their inputs, and gathers, scatters and slice copies move only
  their slice (twice: read and write) and their indices;
* ``transcendentals``: one per output element of ``exp`` / ``log`` /
  ``tanh`` / ``sigmoid`` / ... (``_TRANSCENDENTAL``);
* ``eltwise_flops``: one per output element of add / mul / sub / div /
  max / min;
* the top-level inputs, read once.

The backward runs inside the same pass, so ``remat_apply``'s recompute
(``torch.utils.checkpoint``) is counted where the backward runs it.

A hand-written kernel's op reached on ``meta`` is counted by the formula
registered beside its ops (``KERNEL_COSTS`` of ``kernels/flash_attn/
ops.py`` and ``kernels/ssd_scan/ops.py``: the FLOPs and bytes of
``chip_smoke.py``'s bound helpers). With ``flash_accounting`` (the JAX
package's ``vmem_scan_lengths``) the models take that route
(``kernels.on_meta``), as they take the kernels on the card: attention
counts its FLOPs and only q, k, v, out and lse as bytes, and the SSD
scan its inputs, outputs and priors. Without it the plain versions run
on ``meta`` and are counted op by op, as the JAX package counts its
blockwise and chunked scans.

There is no counterpart of the JAX package's HLO collective parser
(``collective_bytes``): a logical mesh on one card issues no
collectives, and the replication traffic of such a step is the
engine's layout (``launch/dryrun.py``). Across ranks that split
``model`` the port counts its collectives' link bytes as they run
(``distributed/collectives.py``'s ``BYTES``, under the parser's
ring-effective rules), and ``launch/dryrun.py``'s split cell (ROADMAP
A4(d2b2)) reports them for rank 0 of the layout, the REPL / VAL permutes
from the engine's layout.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch import kernels
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops

aten = torch.ops.aten

#: matrix products: (m, n, k) products counted as 2 m n k
_MATMUL = {aten.mm.default, aten.bmm.default, aten.addmm.default,
           aten.baddbmm.default}

_CONV = {aten.convolution.default, aten._convolution.default}

#: ops that cannot fuse into their consumer: their inputs are read
_EXPENSIVE = {
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
    "prod", "var", "std", "var_mean", "logsumexp", "norm",
    "linalg_vector_norm", "_softmax", "_log_softmax",
    "_softmax_backward_data", "_log_softmax_backward_data", "sort", "topk",
    "cumsum", "cumprod", "nll_loss_forward", "nll_loss_backward", "any",
    "all",
}

#: views, dtype casts and shape-only ops: no HBM traffic of their own
_FREE = {
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose",
    "t", "unsqueeze", "squeeze", "select", "slice", "narrow", "as_strided",
    "alias", "detach", "unflatten", "flatten", "split", "split_with_sizes",
    "chunk", "unbind", "_to_copy", "to", "lift_fresh", "view_as_real",
    "view_as_complex", "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "diagonal", "_reshape_alias", "clone",
    "contiguous", "sym_size", "sym_stride", "sym_numel", "is_same_size",
    "_has_compatible_shallow_copy_type", "set_",
}

_TRANSCENDENTAL = {
    "exp", "exp_", "exp2", "expm1", "log", "log_", "log1p", "log2", "tanh",
    "sigmoid", "logistic", "erf", "rsqrt", "sqrt", "sin", "cos", "pow",
    "silu", "gelu", "softplus", "_softmax", "_log_softmax",
    "tanh_backward", "sigmoid_backward", "silu_backward", "gelu_backward",
}

_ELTWISE = {"add", "add_", "mul", "mul_", "sub", "sub_", "div", "div_",
            "maximum", "minimum", "max", "min", "clamp", "clamp_",
            "addcmul", "addcmul_", "addcdiv", "addcdiv_", "lerp", "lerp_"}

#: index ops: they move their slice (read + write) and their indices
_GATHER = {"index_select", "gather", "index", "embedding",
           "embedding_dense_backward", "take_along_dim"}
_SCATTER = {"scatter", "scatter_", "scatter_add", "scatter_add_",
            "index_put", "index_put_", "index_add", "index_add_",
            "index_copy", "index_copy_", "_index_put_impl_",
            "scatter_reduce", "scatter_reduce_"}
_COPY = {"copy_", "copy", "fill_", "zero_", "masked_fill_"}

_KERNEL_COSTS: Dict[Any, Callable[[Sequence[Any]], Dict[str, float]]] = {
    **flash_ops.KERNEL_COSTS, **ssd_ops.KERNEL_COSTS}


def _tensors(tree: Any):
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _mm_flops(func, args) -> int:
    if func in (aten.addmm.default, aten.baddbmm.default):
        a, b = args[1], args[2]
    else:
        a, b = args[0], args[1]
    batch = a.shape[0] if a.dim() == 3 else 1
    m, k = a.shape[-2], a.shape[-1]
    return 2 * batch * m * k * b.shape[-1]


def _conv_flops(args, out: torch.Tensor) -> int:
    w = args[1]                 # (out, in / groups, *kernel)
    kernel = int(np.prod(w.shape[2:])) if w.dim() > 2 else 1
    return 2 * out.numel() * w.shape[1] * kernel


class CostMode(TorchDispatchMode):
    """Counts the aten ops that run inside it (see the module
    docstring); ``acc`` holds the totals."""

    def __init__(self):
        super().__init__()
        self.acc = {"flops": 0.0, "bytes": 0.0, "transcendentals": 0.0,
                    "eltwise_flops": 0.0}
        self.kernel_calls: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        acc = self.acc
        if func in _KERNEL_COSTS:
            cost = _KERNEL_COSTS[func](args)
            for k, v in cost.items():
                acc[k] += v
            name = func.name()
            self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1
            return
        name = func.overloadpacket.__name__
        if name in _FREE:
            return
        outs = ([out] if isinstance(out, torch.Tensor) else
                [t for t in out if isinstance(t, torch.Tensor)]
                if isinstance(out, (tuple, list)) else [])
        if func in _MATMUL:
            acc["flops"] += _mm_flops(func, args)
            acc["bytes"] += sum(_nbytes(t) for t in _tensors(args)) \
                + sum(_nbytes(t) for t in outs)
            return
        if func in _CONV:
            acc["flops"] += _conv_flops(args, outs[0])
            acc["bytes"] += sum(_nbytes(t) for t in _tensors(args)) \
                + sum(_nbytes(t) for t in outs)
            return
        if not outs:
            return
        if name in _GATHER:
            idx = [t for t in _tensors(args)[1:]
                   if not t.is_floating_point()]
            acc["bytes"] += 2 * sum(_nbytes(t) for t in outs) \
                + sum(_nbytes(t) for t in idx)
            return
        if name in _SCATTER:
            ts = _tensors(args)
            src = [t for t in ts[1:] if t.is_floating_point()]
            idx = [t for t in ts[1:] if not t.is_floating_point()]
            acc["bytes"] += 2 * sum(_nbytes(t) for t in src) \
                + sum(_nbytes(t) for t in idx)
            return
        if name in _COPY:
            acc["bytes"] += 2 * _nbytes(outs[0])
            return
        out_b = sum(_nbytes(t) for t in outs)
        acc["bytes"] += out_b
        if name in _EXPENSIVE:
            acc["bytes"] += sum(_nbytes(t) for t in _tensors((args, kwargs)))
        if name in _TRANSCENDENTAL:
            acc["transcendentals"] += outs[0].numel()
        if name in _ELTWISE:
            acc["eltwise_flops"] += outs[0].numel()


def step_cost(fn: Callable[..., Any], *args: Any,
              flash_accounting: bool = False) -> Dict[str, float]:
    """Global logical cost of ``fn(*args)`` (meta tensors, or anything
    ``fn`` turns into meta tensors): ``flops``, ``bytes``,
    ``transcendentals``, ``eltwise_flops``, and ``kernel_calls`` (the
    kernel ops counted by their formula, by name). Per-node numbers are
    these over the node count (even sharding)."""
    mode = CostMode()
    with kernels.on_meta(flash_accounting), mode:
        fn(*args)
    out: Dict[str, Any] = dict(mode.acc)
    # top-level inputs read once
    out["bytes"] += sum(_nbytes(t) for t in _tensors(args))
    out["kernel_calls"] = dict(mode.kernel_calls)
    return out
