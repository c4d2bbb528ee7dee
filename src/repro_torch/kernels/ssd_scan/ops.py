"""Public op of the SSD-scan kernels.

``ssd_scan(x, dt, A, B, C, chunk, init_state)`` with the JAX package's
signature (``kernels/ssd_scan/ops.py``) plus the optional initial state
of ``ssd_chunked``, routed by the device of its tensors: a CUDA tensor
launches the hand-written kernel of its dtype (``kernel.py``: bf16 as
three chunk-parallel passes on the tensor cores, f32 on the CUDA cores)
or raises; a CPU tensor runs the plain version, the port's
``ssd_chunked``, and autograd differentiates it; other devices raise.
There is no override that sends a CUDA tensor to the plain version.

On the CUDA route with grad mode on and an input that requires grad,
the call goes through :class:`SSDScan`, an ``autograd.Function``: its
forward launches the forward kernel with the states entering each chunk
(the priors) and saves the inputs and the priors; its backward launches
the backward kernels (``csrc/ssd_scan_bwd.cu``) for the inputs that need
a gradient. Under ``torch.utils.checkpoint`` the forward runs again in
the backward pass and launches again. Under ``no_grad`` /
``inference_mode`` the forward launches without priors, as every
serving path runs.

``ssd_scan.launches`` counts forward launches (one per call, whatever
the passes inside) and ``ssd_scan.launches_by_kernel`` splits them by
kernel ("mma", "simt"); ``ssd_scan.bwd_launches`` counts backward
launches and ``ssd_scan.bwd_launches_by_kernel`` splits them the same
way (``kernel.bwd_kernel_for``), so a run can show which kernels its
scan went through.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.ssd_scan import kernel


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan runs on CUDA or CPU tensors, got "
                         f"{t.device}")
    return t.device.type


def _forward(x, dt, A, B, C, chunk, init_state, with_priors: bool):
    which = kernel.kernel_for(x.dtype)
    out = kernel.launch(x, dt, A, B, C, chunk, init_state, which,
                        with_priors=with_priors)
    ssd_scan.launches += 1
    ssd_scan.launches_by_kernel[which] += 1
    return out


class SSDScan(torch.autograd.Function):
    """The kernels' scan with their gradient (the CUDA route)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk: int, init_state):
        y, state, priors = _forward(x, dt, A, B, C, chunk, init_state,
                                    with_priors=True)
        ctx.chunk = chunk
        ctx.init_dtype = None if init_state is None else init_state.dtype
        ctx.save_for_backward(x, dt, A, B, C, priors)
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, B, C, priors = ctx.saved_tensors
        need = ctx.needs_input_grad
        which = kernel.bwd_kernel_for(x.dtype)
        if dy is None:
            dy = torch.zeros_like(x)
        dx, ddt, dA, dB, dC, dinit = kernel.launch_bwd(
            x, dt, A, B, C, ctx.chunk, priors, dy, dstate,
            dinit_dtype=ctx.init_dtype if need[6] else None,
            need=tuple(need[:5]))
        ssd_scan.bwd_launches += 1
        ssd_scan.bwd_launches_by_kernel[which] += 1
        return dx, ddt, dA, dB, dC, None, dinit


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int = 256,
             init_state: Optional[torch.Tensor] = None,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, l, h, p); dt: (b, l, h); A: (h,); B, C: (b, l, n).
    Returns (y (b, l, h, p), final state (b, h, p, n))."""
    if _route(x) == "cpu":
        # imported here: models.ssm imports this module
        from repro_torch.models.ssm import ssd_chunked
        return ssd_chunked(x, dt, A, B, C, chunk, init_state)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, B, C, init_state)):
        return SSDScan.apply(x, dt, A, B, C, chunk, init_state)
    return _forward(x, dt, A, B, C, chunk, init_state, with_priors=False)


def reset_counts() -> None:
    """Set the launch counters to 0."""
    ssd_scan.launches = 0
    ssd_scan.launches_by_kernel = {"mma": 0, "simt": 0}
    ssd_scan.bwd_launches = 0
    ssd_scan.bwd_launches_by_kernel = {"simt": 0}


#: Kernel launches since import or :func:`reset_counts` (CPU calls are
#: not counted), in all and by kernel, forward and backward.
reset_counts()
