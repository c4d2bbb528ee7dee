"""Public op of the flash-attention kernel.

``flash_attention(q, k, v, causal, block_q, block_k)`` with the JAX
package's signature (``kernels/flash_attn/ops.py``), routed by the
device of its tensors: a CUDA tensor launches the hand-written kernel
of its dtype (``kernel.py``: bf16 on the tensor cores, f32 on the CUDA
cores; their own tiles) or raises; a CPU tensor runs the plain
version, the port's ``_blockwise_attention`` with ``block_q`` /
``block_k`` tiles, as the JAX ops' non-TPU route does, and autograd
differentiates it; other devices raise. There is no override that sends
a CUDA tensor to the plain version.

On the CUDA route with grad mode on and an input that requires grad,
the call goes through :class:`FlashAttention`, an
``autograd.Function``: its forward launches the forward kernel with the
rows' log-sum-exp and saves q, k, v, the output and lse (not P); its
backward launches the backward kernels (``csrc/flash_attn_bwd.cu``) for
the inputs that need a gradient. Under ``torch.utils.checkpoint`` the
forward runs again in the backward pass and launches again. Under
``no_grad`` / ``inference_mode`` the forward launches without lse, as
every serving path runs.

:func:`flash_attention_meta` is the kernels' route on meta tensors
(``launch/costing.py``'s shapes-only pass): two shape-only ops,
``torch.ops.repro_torch.flash_attention_fwd`` / ``_bwd``, so a cost pass
sees each launch as one op, and :func:`attention_cost` is what one
launch moves and computes, the count of ``chip_smoke.py``'s
``attn_bound_ms`` / ``bwd_bound_ms``. They launch nothing and are not
counted.

``flash_attention.launches`` counts forward launches and
``flash_attention.launches_by_kernel`` splits them by kernel ("mma",
"simt"); ``flash_attention.bwd_launches`` counts backward launches and
``flash_attention.bwd_launches_by_kernel`` splits them the same way
(bf16 on the tensor cores, "mma"; f32 on the CUDA cores, "simt";
``kernel.bwd_kernel_for``), so a run can show which kernels its
attention went through.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from repro_torch.kernels.flash_attn import kernel


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got "
                         f"{t.device}")
    return t.device.type


# ---------------------------------------------------------------------------
# The meta route: one shape-only op per launch, and its cost
# ---------------------------------------------------------------------------

def attention_cost(q_shape: Sequence[int], k_shape: Sequence[int],
                   causal: bool, itemsize: int, backward: bool = False,
                   with_lse: bool = False) -> Dict[str, float]:
    """FLOPs and bytes of one launch on q ``(B, Sq, H, D)`` and k / v
    ``(B, Skv, K, D)``: 4 D operations a head per allowed (query, key)
    pair forward (q.k and p.v), 10 D backward (s, dP, dV, dK, dQ), over
    the exact causal pairs (right-aligned); forward q, k, v read and out
    (and the f32 lse when asked) written once, backward q, k, v, out,
    dout, lse read and dq, dk, dv written once. ``exp`` of each pair is
    the transcendentals (twice backward, which forms P again)."""
    b, sq, h, d = q_shape
    skv, kh = k_shape[1], k_shape[2]
    q_n, k_n = b * sq * h * d, b * skv * kh * d
    if causal:
        off = skv - sq
        pairs = sum(min(i + off + 1, skv) for i in range(sq))
    else:
        pairs = sq * skv
    pairs *= b * h
    lse = b * h * sq * 4
    if backward:
        return {"flops": 10.0 * d * pairs, "transcendentals": float(pairs),
                "bytes": float((4 * q_n + 4 * k_n) * itemsize + lse)}
    return {"flops": 4.0 * d * pairs, "transcendentals": float(pairs),
            "bytes": float((2 * q_n + 2 * k_n) * itemsize
                           + (lse if with_lse else 0))}


def _meta_fwd(q, k, v, causal: bool, with_lse: bool):
    b, sq, h, _ = q.shape
    return (q.new_empty(q.shape),
            q.new_empty((b, h, sq) if with_lse else (0,),
                        dtype=torch.float32))


def _meta_bwd(q, k, v, out, lse, dout, causal: bool):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


if not hasattr(torch.ops.repro_torch, "flash_attention_fwd"):
    _LIB = torch.library.Library("repro_torch", "FRAGMENT")
    _LIB.define("flash_attention_fwd(Tensor q, Tensor k, Tensor v, "
                "bool causal, bool with_lse) -> (Tensor, Tensor)")
    _LIB.define("flash_attention_bwd(Tensor q, Tensor k, Tensor v, "
                "Tensor out, Tensor lse, Tensor dout, bool causal) "
                "-> (Tensor, Tensor, Tensor)")
    _LIB.impl("flash_attention_fwd", _meta_fwd, "Meta")
    _LIB.impl("flash_attention_bwd", _meta_bwd, "Meta")


def _fwd_cost(args) -> Dict[str, float]:
    q, k, _, causal, with_lse = args
    return attention_cost(q.shape, k.shape, causal, q.element_size(),
                          with_lse=with_lse)


def _bwd_cost(args) -> Dict[str, float]:
    q, k = args[0], args[1]
    return attention_cost(q.shape, k.shape, args[6], q.element_size(),
                          backward=True)


#: op -> its cost from the op's arguments, for ``launch/costing.py``
KERNEL_COSTS = {torch.ops.repro_torch.flash_attention_fwd.default: _fwd_cost,
                torch.ops.repro_torch.flash_attention_bwd.default: _bwd_cost}


class _MetaFlashAttention(torch.autograd.Function):
    """The kernels' route on meta tensors: shapes only."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = torch.ops.repro_torch.flash_attention_fwd(
            q, k, v, causal, True)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = torch.ops.repro_torch.flash_attention_bwd(
            *ctx.saved_tensors, dout, ctx.causal)
        return dq, dk, dv, None


def flash_attention_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """:func:`flash_attention`'s kernel route on meta tensors: one
    shape-only op a launch, forward (with lse when autograd will ask for
    the gradient) and backward, as the CUDA route launches them."""
    if q.device.type != "meta":
        raise ValueError(f"flash_attention_meta takes meta tensors, got "
                         f"{q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _MetaFlashAttention.apply(q, k, v, causal)
    return torch.ops.repro_torch.flash_attention_fwd(q, k, v, causal,
                                                     False)[0]


def _forward(q, k, v, causal: bool, with_lse: bool):
    which = kernel.kernel_for(q.dtype)
    res = (kernel.launch(q, k, v, causal, which, with_lse=True) if with_lse
           else kernel.launch(q, k, v, causal, which))
    flash_attention.launches += 1
    flash_attention.launches_by_kernel[which] += 1
    return res


class FlashAttention(torch.autograd.Function):
    """The kernels' attention with their gradient (the CUDA route)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = _forward(q, k, v, causal, with_lse=True)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        need_q, need_k, need_v = ctx.needs_input_grad[:3]
        which = kernel.bwd_kernel_for(q.dtype)
        dq, dk, dv = kernel.launch_bwd(q, k, v, out, lse, dout, ctx.causal,
                                       need_dq=need_q,
                                       need_dkv=need_k or need_v,
                                       which=which)
        flash_attention.bwd_launches += 1
        flash_attention.bwd_launches_by_kernel[which] += 1
        return (dq, dk if need_k else None, dv if need_v else None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_q: int = 512,
                    block_k: int = 512) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Skv, K, D) -> (B, Sq, H, D)."""
    if _route(q) == "cpu":
        # imported here: models.attention imports this module
        from repro_torch.models.attention import _blockwise_attention
        return _blockwise_attention(q, k, v, causal, q_block=block_q,
                                    kv_block=block_k)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal)
    return _forward(q, k, v, causal, with_lse=False)


def reset_counts() -> None:
    """Set the launch counters to 0."""
    flash_attention.launches = 0
    flash_attention.launches_by_kernel = {"mma": 0, "simt": 0}
    flash_attention.bwd_launches = 0
    flash_attention.bwd_launches_by_kernel = {"mma": 0, "simt": 0}


#: Kernel launches since import or :func:`reset_counts` (CPU calls are
#: not counted), in all and by kernel, forward and backward.
reset_counts()
