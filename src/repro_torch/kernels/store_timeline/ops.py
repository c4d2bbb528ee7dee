"""Dispatchers of the store-timeline kernel (the five commit rules before
the max-plus collapse).

:func:`store_timeline` is the serial oracle's scan (one cell, its rule
and SB depth fixed), :func:`store_timeline_batch` the per-step engine's
(time-major cells, a rule and a depth per lane). A CUDA tensor launches
the hand-written kernel (``kernel.py``) or raises; a CPU tensor runs the
plain torch version (``ref.py``). There is no override that sends a CUDA
tensor to the plain version. ``store_timeline.launches`` counts kernel
launches of both, ``store_timeline.launches_by_mode`` splits them
("serial", "perstep") and ``store_timeline.launches_by_ring`` by the ring
instantiation each took ("register", "shared", "scratch"), so a run can
show that its scans went through the kernel, and on which ring.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.store_timeline import kernel
from repro_torch.kernels.store_timeline.ref import (
    CONFIGS,
    store_timeline_batch_ref,
    store_timeline_ref,
)


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"store_timeline runs on CUDA or CPU tensors, got "
                         f"{t.device}")
    return t.device.type


def _check(inputs, per_lane: Optional[dict], dim: int) -> None:
    names = ("arrivals", "coalesce", "exposed", "t_repl_i", "svc_i")
    args = dict(zip(names, inputs))
    want = {n: torch.bool if n == "coalesce" else torch.float32
            for n in names}
    if per_lane:
        args.update(per_lane)
        want.update({n: torch.int32 for n in per_lane})
    dev = inputs[0].device
    for name, t in args.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, arrivals on {dev}")
        if t.dtype != want[name]:
            raise TypeError(f"{name} must be {want[name]}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    shape = inputs[0].shape
    if len(shape) != dim:
        raise ValueError(f"arrivals must have {dim} dimension(s), got "
                         f"{tuple(shape)}")
    for name, t in zip(names[1:], inputs[1:]):
        if t.shape != shape:
            raise ValueError(f"{name} must be {tuple(shape)} like arrivals, "
                             f"got {tuple(t.shape)}")
    for name, t in (per_lane or {}).items():
        if t.shape != shape[1:]:
            raise ValueError(f"{name} must be ({shape[1]},), got "
                             f"{tuple(t.shape)}")


def store_timeline(arrivals: torch.Tensor, coalesce: torch.Tensor,
                   exposed: torch.Tensor, t_repl_i: torch.Tensor,
                   svc_i: torch.Tensor, *, config: str, sb: int,
                   t_l1: float, t_wt: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The serial oracle's timeline of one cell: ``(n_stores,)`` inputs
    (arrivals, exposed, t_repl_i, svc_i f32; coalesce bool), the rule
    ``config`` (one of ``"wb"``, ``"wt"``, ``"baseline"``,
    ``"parallel"``, ``"proactive"``) and an SB of ``sb`` entries.
    ``t_l1`` / ``t_wt`` are rounded to f32. Returns 0-d ``(last commit
    time f32, at_head i32, sb_full i32)`` on the inputs' device, without
    synchronising."""
    inputs = (arrivals, coalesce, exposed, t_repl_i, svc_i)
    _check(inputs, None, 1)
    if config not in CONFIGS:
        raise ValueError(f"unknown config {config!r}")
    if int(sb) < 1:
        raise ValueError(f"sb must be >= 1, got {sb}")
    if _route(arrivals) == "cpu":
        return store_timeline_ref(*inputs, config=config, sb=int(sb),
                                  t_l1=t_l1, t_wt=t_wt)
    ring = kernel.ring_for(int(sb))
    out = kernel.launch(*inputs, None, None, CONFIGS.index(config), int(sb),
                        int(sb), ring, t_l1, t_wt)
    _count("serial", ring)
    return tuple(x.reshape(()) for x in out)


def store_timeline_batch(arrivals: torch.Tensor, coalesce: torch.Tensor,
                         exposed: torch.Tensor, t_repl_i: torch.Tensor,
                         svc_i: torch.Tensor, config_idx: torch.Tensor,
                         sb_size: torch.Tensor, *, sb_max: int,
                         t_l1: float, t_wt: float
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The per-step engine's timeline of ``B`` lanes: time-major
    ``(n_stores, B)`` inputs, ``config_idx`` (index into ``CONFIGS``) and
    ``sb_size`` ``(B,)`` int32, and a ring of ``sb_max`` slots shared by
    every depth (each in ``[1, sb_max]``). When every lane has one depth
    of ``kernel.register_ring_depths()``, the launch keeps the ring in
    registers (the card reads ``sb_size``'s least and greatest depth back
    to the host to see it). Returns ``(B,)`` ``(last commit time f32,
    at_head i32, sb_full i32)`` on the inputs' device, without
    synchronising on the outputs. On the card a lane whose depth or rule
    is out of range gets NaN and -1 counts; the plain version raises."""
    inputs = (arrivals, coalesce, exposed, t_repl_i, svc_i)
    _check(inputs, {"config_idx": config_idx, "sb_size": sb_size}, 2)
    if int(sb_max) < 1:
        raise ValueError(f"sb_max must be >= 1, got {sb_max}")
    if _route(arrivals) == "cpu":
        return store_timeline_batch_ref(*inputs, config_idx, sb_size,
                                        sb_max=int(sb_max), t_l1=t_l1,
                                        t_wt=t_wt)
    uniform = _uniform_depth(sb_size)
    ring = kernel.ring_for(uniform, int(sb_max))
    # the depth goes to the kernel only for the register ring: every lane
    # has it
    sb = uniform if ring == "register" else 0
    out = kernel.launch(*inputs, config_idx, sb_size,
                        kernel.PER_LANE_CONFIG, sb, int(sb_max), ring,
                        t_l1, t_wt)
    _count("perstep", ring)
    return out


def _uniform_depth(sb_size: torch.Tensor) -> Optional[int]:
    """The one depth of every lane, if they share one, else None."""
    lo, hi = torch.stack(torch.aminmax(sb_size)).tolist()
    return lo if lo == hi else None


def _count(mode: str, ring: str) -> None:
    store_timeline.launches += 1
    store_timeline.launches_by_mode[mode] += 1
    store_timeline.launches_by_ring[ring] += 1


def reset_counts() -> None:
    """Set the launch counters to 0."""
    store_timeline.launches = 0
    store_timeline.launches_by_mode = {"serial": 0, "perstep": 0}
    store_timeline.launches_by_ring = {ring: 0 for ring in kernel.RINGS}


#: Kernel launches since import or :func:`reset_counts` (CPU calls are
#: not counted), in all, by mode and by ring instantiation.
reset_counts()
