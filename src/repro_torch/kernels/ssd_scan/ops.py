"""Public op of the SSD-scan kernels.

``ssd_scan(x, dt, A, B, C, chunk, init_state)`` with the JAX package's
signature (``kernels/ssd_scan/ops.py``) plus the optional initial state
of ``ssd_chunked``, routed by the device of its tensors: a CUDA tensor
launches the hand-written kernel of its dtype (``kernel.py``: bf16 as
three chunk-parallel passes on the tensor cores, f32 on the CUDA cores)
or raises; a CPU tensor runs the plain version, the port's
``ssd_chunked``; other devices raise. There is no override that sends a
CUDA tensor to the plain version. The kernels compute the forward only:
on the CUDA route, with grad mode on and an input that requires grad,
the op raises (its backward kernel is ROADMAP A7b; ``flash_attn`` has
its backward since the training slice).
``ssd_scan.launches`` counts calls
that launched a kernel (one per call, whatever the passes inside), and
``ssd_scan.launches_by_kernel`` splits them by kernel ("mma", "simt"),
so a run can show which kernel its scan went through.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels._tensor import refuse_grad
from repro_torch.kernels.ssd_scan import kernel


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan runs on CUDA or CPU tensors, got "
                         f"{t.device}")
    return t.device.type


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
    refuse_grad("ssd_scan", x, dt, A, B, C, init_state)
    which = kernel.kernel_for(x.dtype)
    out = kernel.launch(x, dt, A, B, C, chunk, init_state, which)
    ssd_scan.launches += 1
    ssd_scan.launches_by_kernel[which] += 1
    return out


def reset_counts() -> None:
    """Set the launch counters to 0."""
    ssd_scan.launches = 0
    ssd_scan.launches_by_kernel = {"mma": 0, "simt": 0}


#: Kernel launches since import or :func:`reset_counts` (CPU calls are
#: not counted), in all and by kernel.
reset_counts()
