"""Public op of the SSD-scan kernel.

``ssd_scan(x, dt, A, B, C, chunk, init_state)`` with the JAX package's
signature (``kernels/ssd_scan/ops.py``) plus the optional initial state
of ``ssd_chunked``, routed by the device of its tensors: a CUDA tensor
launches the hand-written kernel (``kernel.py``) or raises; a CPU tensor
runs the plain version, the port's ``ssd_chunked``; other devices raise.
There is no override that sends a CUDA tensor to the plain version.
``ssd_scan.launches`` counts kernel launches.
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
    out = kernel.launch(x, dt, A, B, C, chunk, init_state)
    ssd_scan.launches += 1
    return out


#: Kernel launches since import (CPU calls are not counted).
ssd_scan.launches = 0
