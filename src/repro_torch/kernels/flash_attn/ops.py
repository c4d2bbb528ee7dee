"""Public op of the flash-attention kernel.

``flash_attention(q, k, v, causal, block_q, block_k)`` with the JAX
package's signature (``kernels/flash_attn/ops.py``), routed by the
device of its tensors: a CUDA tensor launches the hand-written kernel
of its dtype (``kernel.py``: bf16 on the tensor cores, f32 on the CUDA
cores; their own tiles) or raises; a CPU tensor runs the plain
version, the port's ``_blockwise_attention`` with ``block_q`` /
``block_k`` tiles, as the JAX ops' non-TPU route does; other devices
raise. There is no override that sends a CUDA tensor to the plain
version. The kernels compute the forward only: on the CUDA route, with
grad mode on and an input that requires grad, the op raises instead of
returning an output that autograd cannot trace back (the backward comes
with training, ROADMAP A7). ``flash_attention.launches`` counts kernel
launches and ``flash_attention.launches_by_kernel`` splits them by
kernel ("mma", "simt"), so a run can show which kernel its attention
went through.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._tensor import refuse_grad
from repro_torch.kernels.flash_attn import kernel


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got "
                         f"{t.device}")
    return t.device.type


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_q: int = 512,
                    block_k: int = 512) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Skv, K, D) -> (B, Sq, H, D)."""
    if _route(q) == "cpu":
        # imported here: models.attention imports this module
        from repro_torch.models.attention import _blockwise_attention
        return _blockwise_attention(q, k, v, causal, q_block=block_q,
                                    kv_block=block_k)
    refuse_grad("flash_attention", q, k, v)
    which = kernel.kernel_for(q.dtype)
    out = kernel.launch(q, k, v, causal, which)
    flash_attention.launches += 1
    flash_attention.launches_by_kernel[which] += 1
    return out


def reset_counts() -> None:
    """Set the launch counters to 0."""
    flash_attention.launches = 0
    flash_attention.launches_by_kernel = {"mma": 0, "simt": 0}


#: Kernel launches since import or :func:`reset_counts` (CPU calls are
#: not counted), in all and by kernel.
reset_counts()
