"""Build and ctypes binding of the CUDA bank-scan kernel.

The kernel (``src/repro_torch/csrc/bank_scan.cu``) is compiled by hand
with ``nvcc`` for ``sm_90a`` at first use, through the port's shared
build helper (:mod:`repro_torch.kernels.nvcc`), into
``build/repro_torch/libbank_scan-<hash>.so``. Nothing here runs at
import time: the CPU tests import this module on machines without
``nvcc``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels._tensor import on_card
from repro_torch.kernels.nvcc import CudaLibrary

#: Store-buffer depths with a register-ring instantiation in
#: ``bank_scan.cu``: the paper's SB (Table II) and the mega-grid's second
#: size. Other depths keep the ring in shared memory, or past
#: ``bank_scan_max_shared_sb()`` in a scratch buffer.
REGISTER_RING_DEPTHS = (48, 72)
#: The ring instantiations, by the code ``bank_scan_launch`` takes.
RINGS = {"register": 0, "shared": 1, "scratch": 2}


def _bind(lib: ctypes.CDLL) -> None:
    lib.bank_scan_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.bank_scan_launch.restype = ctypes.c_int
    lib.bank_scan_max_shared_sb.argtypes = []
    lib.bank_scan_max_shared_sb.restype = ctypes.c_int
    lib.bank_scan_error_string.argtypes = [ctypes.c_int]
    lib.bank_scan_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("bank_scan", _bind)
load = LIBRARY.load


def ring_for(sb: int) -> str:
    """The ring instantiation that runs depth ``sb``: "register",
    "shared" or "scratch"."""
    if sb in REGISTER_RING_DEPTHS:
        return "register"
    return "shared" if sb <= load().bank_scan_max_shared_sb() else "scratch"


def launch(a_bank: torch.Tensor, w_bank: torch.Tensor, v_bank: torch.Tensor,
           p_bank: torch.Tensor, trace_idx: torch.Tensor,
           wv_idx: torch.Tensor, sb: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream of the tensors' card, with
    the ring instantiation :func:`ring_for` picks.

    The caller (``ops.bank_scan``) has checked devices, dtypes, shapes
    and contiguity. Allocates the outputs and, for the scratch ring,
    ``sb * lanes`` floats of ring. Raises ``RuntimeError`` on a non-zero
    launch status; does not synchronise."""
    lib = load()
    ring = ring_for(sb)
    dev = a_bank.device
    n_lanes = int(trace_idx.shape[0])
    out_c = torch.empty(n_lanes, dtype=torch.float32, device=dev)
    out_ah = torch.empty(n_lanes, dtype=torch.int32, device=dev)
    out_sf = torch.empty(n_lanes, dtype=torch.int32, device=dev)
    scratch = None
    if ring == "scratch":
        scratch = torch.empty(sb * n_lanes, dtype=torch.float32, device=dev)
    with on_card(dev) as stream:
        status = lib.bank_scan_launch(
            a_bank.data_ptr(), w_bank.data_ptr(), v_bank.data_ptr(),
            p_bank.data_ptr(), trace_idx.data_ptr(), wv_idx.data_ptr(),
            n_lanes, int(a_bank.shape[1]), int(a_bank.shape[0]),
            int(w_bank.shape[0]), int(sb), RINGS[ring],
            scratch.data_ptr() if scratch is not None else None,
            out_c.data_ptr(), out_ah.data_ptr(), out_sf.data_ptr(), stream)
    if status != 0:
        msg = lib.bank_scan_error_string(status).decode()
        raise RuntimeError(f"bank_scan launch failed: CUDA error {status} "
                           f"({msg}) at lanes={n_lanes} sb={sb} ring={ring}")
    return out_c, out_ah, out_sf
