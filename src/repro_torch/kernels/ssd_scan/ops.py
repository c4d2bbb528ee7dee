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

:func:`ssd_scan_meta` is the kernels' route on meta tensors
(``launch/costing.py``): two shape-only ops,
``torch.ops.repro_torch.ssd_scan_fwd`` / ``_bwd``, counted by
:func:`ssd_cost`, the count of ``chip_smoke.py``'s ``ssd_bound_ms`` /
``ssd_bwd_bound_ms``. They launch nothing and are not counted.

``ssd_scan.launches`` counts forward launches (one per call, whatever
the passes inside) and ``ssd_scan.launches_by_kernel`` splits them by
kernel ("mma", "simt"); ``ssd_scan.bwd_launches`` counts backward
launches (one per call, whatever the kernels inside) and
``ssd_scan.bwd_launches_by_kernel`` splits them the same way
(``kernel.bwd_kernel_for``: bf16 "mma", f32 "simt"), so a run can show
which kernels its scan went through.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.ssd_scan import kernel


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan runs on CUDA or CPU tensors, got "
                         f"{t.device}")
    return t.device.type


# ---------------------------------------------------------------------------
# The meta route: one shape-only op per launch, and its cost
# ---------------------------------------------------------------------------

def ssd_cost(x_shape: Sequence[int], n: int, chunk: int, itemsize: int,
             backward: bool = False) -> Dict[str, float]:
    """FLOPs and bytes of one call on x ``(b, l, h, p)`` and B / C ``(b,
    l, n)``, as ``chip_smoke.py``'s ``ssd_bound_ms`` / ``ssd_bwd_bound_ms``
    count them. Forward: x, dt, A, B, C read and y and the state written
    once, against C.B^T and att.x on the causal half of each chunk, C.state
    and the chunk summary. Backward: x, dy, B, C, dt and the priors
    (``(b, h, nc, p, n)``) read, dx, dB, dC and ddt written once, against
    2 p MACs per allowed (row, key) pair and head (dP, dx), 4 p n per
    position and head, and 3 n per pair for G, dC and dB once per (b,
    chunk). ``exp`` of each position and head is the transcendentals."""
    b, l, h, p = x_shape
    chunk = min(chunk, l)
    nc = -(-l // chunk)
    x_n, bc_n = b * l * h * p, b * l * n
    if backward:
        sizes = [chunk] * (l // chunk) + ([l % chunk] if l % chunk else [])
        pairs = sum(q * (q + 1) // 2 for q in sizes)
        macs = b * (h * (pairs * 2 * p + 4 * l * p * n) + 3 * pairs * n)
        nbytes = ((3 * x_n + 4 * bc_n) * itemsize + 2 * b * l * h * 4
                  + b * h * nc * p * n * itemsize)
        return {"flops": 2.0 * macs, "bytes": float(nbytes),
                "transcendentals": float(b * l * h)}
    tri = chunk * (chunk + 1) / 2
    nbytes = (2 * x_n * itemsize + b * l * h * 4 + h * 4
              + 2 * bc_n * itemsize + b * h * p * n * itemsize)
    ops = b * nc * (2 * tri * n + h * (2 * tri * p + 4 * chunk * n * p))
    return {"flops": float(ops), "bytes": float(nbytes),
            "transcendentals": float(b * l * h)}


def _meta_fwd(x, dt, A, B, C, chunk: int, with_priors: bool):
    b, l, h, p = x.shape
    n = B.shape[-1]
    nc = -(-l // min(chunk, l))
    return (x.new_empty(x.shape), x.new_empty((b, h, p, n)),
            x.new_empty((b, h, nc, p, n) if with_priors else (0,)))


def _meta_bwd(x, dt, A, B, C, chunk: int, priors, dy):
    return (x.new_empty(x.shape), dt.new_empty(dt.shape, dtype=torch.float32),
            A.new_empty(A.shape, dtype=torch.float32), B.new_empty(B.shape),
            C.new_empty(C.shape))


if not hasattr(torch.ops.repro_torch, "ssd_scan_fwd"):
    _LIB = torch.library.Library("repro_torch", "FRAGMENT")
    _LIB.define("ssd_scan_fwd(Tensor x, Tensor dt, Tensor A, Tensor B, "
                "Tensor C, int chunk, bool with_priors) "
                "-> (Tensor, Tensor, Tensor)")
    _LIB.define("ssd_scan_bwd(Tensor x, Tensor dt, Tensor A, Tensor B, "
                "Tensor C, int chunk, Tensor priors, Tensor dy) "
                "-> (Tensor, Tensor, Tensor, Tensor, Tensor)")
    _LIB.impl("ssd_scan_fwd", _meta_fwd, "Meta")
    _LIB.impl("ssd_scan_bwd", _meta_bwd, "Meta")


#: op -> its cost from the op's arguments, for ``launch/costing.py``
KERNEL_COSTS = {
    torch.ops.repro_torch.ssd_scan_fwd.default:
        lambda a: ssd_cost(a[0].shape, a[3].shape[-1], a[5],
                           a[0].element_size()),
    torch.ops.repro_torch.ssd_scan_bwd.default:
        lambda a: ssd_cost(a[0].shape, a[3].shape[-1], a[5],
                           a[0].element_size(), backward=True),
}


class _MetaSSDScan(torch.autograd.Function):
    """The kernels' route on meta tensors: shapes only."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk: int):
        y, state, priors = torch.ops.repro_torch.ssd_scan_fwd(
            x, dt, A, B, C, chunk, True)
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, A, B, C, priors)
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, B, C, priors = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        return torch.ops.repro_torch.ssd_scan_bwd(
            x, dt, A, B, C, ctx.chunk, priors, dy) + (None,)


def ssd_scan_meta(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, chunk: int = 256,
                  init_state: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`ssd_scan`'s kernel route on meta tensors: one shape-only op
    a launch, forward (with the priors when autograd will ask for the
    gradient) and backward, as the CUDA route launches them. An initial
    state is read but gets no gradient here."""
    if x.device.type != "meta":
        raise ValueError(f"ssd_scan_meta takes meta tensors, got {x.device}")
    del init_state              # the same shapes with or without it
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, dt, A, B, C)):
        return _MetaSSDScan.apply(x, dt, A, B, C, chunk)
    y, state, _ = torch.ops.repro_torch.ssd_scan_fwd(x, dt, A, B, C, chunk,
                                                     False)
    return y, state


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
    ssd_scan.bwd_launches_by_kernel = {"mma": 0, "simt": 0}


#: Kernel launches since import or :func:`reset_counts` (CPU calls are
#: not counted), in all and by kernel, forward and backward.
reset_counts()
