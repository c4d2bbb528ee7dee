"""Oracle for the SSD scan: the naive O(L) sequential recurrence, the
JAX package's ``kernels/ssd_scan/ref.py``.

    state_t = exp(dt_t * A) * state_{t-1} + dt_t * x_t (outer) B_t
    y_t     = state_t @ C_t

Independent of the chunked algorithm (``models/ssm.py::ssd_chunked``,
the kernel's plain version) and of the CUDA kernel, so it validates both.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor,
            init_state: Optional[torch.Tensor] = None,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, l, h, p); dt: (b, l, h) post-softplus; A: (h,) negative;
    B, C: (b, l, n). Returns (y (b, l, h, p), state (b, h, p, n))."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    x32, dt32, B32, C32 = x.float(), dt.float(), B.float(), C.float()
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    ys = []
    for t in range(l):
        dA = torch.exp(dt32[:, t] * A[None, :])                   # (b, h)
        upd = (dt32[:, t, :, None] * x32[:, t])[..., None] \
            * B32[:, t, None, None, :]
        state = dA[..., None, None] * state + upd                # (b, h, p, n)
        ys.append(torch.einsum("bhpn,bn->bhp", state, C32[:, t]))
    y = torch.stack(ys, dim=1).to(x.dtype)                       # (b, l, h, p)
    return y, state.to(x.dtype)
