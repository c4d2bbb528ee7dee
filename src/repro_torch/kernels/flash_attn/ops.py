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

``flash_attention.launches`` counts forward launches and
``flash_attention.launches_by_kernel`` splits them by kernel ("mma",
"simt"); ``flash_attention.bwd_launches`` counts backward launches and
``flash_attention.bwd_launches_by_kernel`` splits them the same way
(bf16 on the tensor cores, "mma"; f32 on the CUDA cores, "simt";
``kernel.bwd_kernel_for``), so a run can show which kernels its
attention went through.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attn import kernel


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got "
                         f"{t.device}")
    return t.device.type


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
