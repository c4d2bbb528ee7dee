"""Build and ctypes binding of the CUDA store-timeline kernel.

The kernel (``src/repro_torch/csrc/store_timeline.cu``) is compiled by
hand with ``nvcc`` for ``sm_90a`` at first use, through the port's shared
build helper (:mod:`repro_torch.kernels.nvcc`), into
``build/repro_torch/libstore_timeline-<hash>.so``. Nothing here runs at
import time: the CPU tests import this module on machines without
``nvcc``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels._tensor import on_card
from repro_torch.kernels.nvcc import CudaLibrary

#: The code for "each lane's rule from config_idx" (the per-step engine);
#: 0-4 are the rules in ``ref.CONFIGS`` order.
PER_LANE_CONFIG = -1
#: The ring instantiations, by the code ``store_timeline_launch`` takes.
RINGS = {"register": 0, "shared": 1, "scratch": 2}


def _bind(lib: ctypes.CDLL) -> None:
    lib.store_timeline_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.store_timeline_launch.restype = ctypes.c_int
    lib.store_timeline_max_shared_ring.argtypes = []
    lib.store_timeline_max_shared_ring.restype = ctypes.c_int
    lib.store_timeline_chunk_stores.argtypes = []
    lib.store_timeline_chunk_stores.restype = ctypes.c_int
    lib.store_timeline_register_ring_depth.argtypes = [ctypes.c_int]
    lib.store_timeline_register_ring_depth.restype = ctypes.c_int
    lib.store_timeline_error_string.argtypes = [ctypes.c_int]
    lib.store_timeline_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("store_timeline", _bind)
load = LIBRARY.load


def register_ring_depths() -> Tuple[int, ...]:
    """The store-buffer depths with a register-ring instantiation in the
    built kernel (``kRegisterDepths``: the paper's SB, Table II, and the
    mega-grid's second size)."""
    lib = load()
    depths = []
    while (sb := lib.store_timeline_register_ring_depth(len(depths))) > 0:
        depths.append(sb)
    return tuple(depths)


def ring_for(sb: Optional[int], ring_width: Optional[int] = None) -> str:
    """The ring instantiation that runs lanes of depth ``sb`` (None: the
    lanes' depths differ) in a ring of ``ring_width`` slots (default
    ``sb``): "register" for a depth of :func:`register_ring_depths`,
    else "shared" up to the kernel's shared-memory limit and "scratch"
    (a device buffer) above. Other depths, depths past ``ring_width``,
    and per-step batches of mixed depths keep the ring in memory."""
    width = sb if ring_width is None else ring_width
    if sb is not None and sb <= width and sb in register_ring_depths():
        return "register"
    return "shared" if width <= load().store_timeline_max_shared_ring() \
        else "scratch"


def launch(arrivals: torch.Tensor, coalesce: torch.Tensor,
           exposed: torch.Tensor, t_repl_i: torch.Tensor,
           svc_i: torch.Tensor, config_idx: Optional[torch.Tensor],
           sb_size: Optional[torch.Tensor], config: int, sb: int,
           ring_width: int, ring: str, t_l1: float, t_wt: float
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream of the tensors' card.

    The five inputs are time-major ``(n_stores, lanes)`` (a 1-D input is
    one lane). ``config`` is the rule's index in ``ref.CONFIGS`` for every
    lane (``config_idx`` None) or :data:`PER_LANE_CONFIG`; ``sb`` is every
    lane's depth when ``sb_size`` is None, and on the register ring the
    depth each lane of ``sb_size`` must have. ``ring`` is the
    instantiation :func:`ring_for` picks. ``t_l1`` / ``t_wt`` go to the
    kernel as f32. The caller (``ops``) has checked devices, dtypes,
    shapes and contiguity. Allocates the outputs and, for the scratch
    ring, ``ring_width * lanes`` floats of ring. Raises ``RuntimeError``
    on a non-zero launch status; does not synchronise."""
    lib = load()
    dev = arrivals.device
    n_stores = int(arrivals.shape[0])
    n_lanes = int(arrivals.shape[1]) if arrivals.dim() == 2 else 1
    out_c = torch.empty(n_lanes, dtype=torch.float32, device=dev)
    out_ah = torch.empty(n_lanes, dtype=torch.int32, device=dev)
    out_sf = torch.empty(n_lanes, dtype=torch.int32, device=dev)
    scratch = None
    if ring == "scratch":
        scratch = torch.empty(ring_width * n_lanes, dtype=torch.float32,
                              device=dev)
    with on_card(dev) as stream:
        status = lib.store_timeline_launch(
            arrivals.data_ptr(), coalesce.data_ptr(), exposed.data_ptr(),
            t_repl_i.data_ptr(), svc_i.data_ptr(),
            config_idx.data_ptr() if config_idx is not None else None,
            sb_size.data_ptr() if sb_size is not None else None,
            int(config), int(sb), n_lanes, n_stores, int(ring_width),
            RINGS[ring], float(np.float32(t_l1)), float(np.float32(t_wt)),
            scratch.data_ptr() if scratch is not None else None,
            out_c.data_ptr(), out_ah.data_ptr(), out_sf.data_ptr(), stream)
    if status != 0:
        msg = lib.store_timeline_error_string(status).decode()
        raise RuntimeError(f"store_timeline launch failed: CUDA error "
                           f"{status} ({msg}) at lanes={n_lanes} "
                           f"n_stores={n_stores} ring={ring} "
                           f"width={ring_width} config={config}")
    return out_c, out_ah, out_sf
