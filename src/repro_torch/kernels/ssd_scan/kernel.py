"""Build and ctypes binding of the CUDA SSD-scan kernel.

The kernel (``src/repro_torch/csrc/ssd_scan.cu``) is compiled by hand
with ``nvcc`` for ``sm_90a`` at first use, through the port's shared
build helper (:mod:`repro_torch.kernels.nvcc`), into
``build/repro_torch/libssd_scan-<hash>.so``. Nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels.nvcc import CudaLibrary

HEAD_DIMS = (16, 32, 64, 128)
MAX_STATE = 128
MAX_SMEM_BYTES = 227 * 1024
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    lib.ssd_scan_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.ssd_scan_launch.restype = ctypes.c_int
    lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int]
    lib.ssd_scan_smem_bytes.restype = ctypes.c_int
    lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("ssd_scan", _bind)
load = LIBRARY.load


def check_inputs(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, chunk: int,
                 init_state: Optional[torch.Tensor]) -> None:
    """Raise on what the kernel does not take."""
    if x.dim() != 4:
        raise ValueError(f"x must be (b, l, h, p), got {tuple(x.shape)}")
    b, l, h, p = x.shape
    n = B.shape[-1] if B.dim() == 3 else -1
    if (dt.shape != (b, l, h) or A.shape != (h,) or B.shape != (b, l, n)
            or C.shape != B.shape):
        raise ValueError(f"shapes do not fit x {tuple(x.shape)}: dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}")
    if init_state is not None and init_state.shape != (b, h, p, n):
        raise ValueError(f"init_state must be {(b, h, p, n)}, got "
                         f"{tuple(init_state.shape)}")
    if not x.dtype == B.dtype == C.dtype or x.dtype not in DTYPES:
        raise TypeError(f"x, B, C must share float32 or bfloat16, got "
                        f"{x.dtype}, {B.dtype}, {C.dtype}")
    for name, t in (("dt", dt), ("A", A), ("init_state", init_state)):
        if t is not None and not t.is_floating_point():
            raise TypeError(f"{name} must be floating point, got {t.dtype}")
    if p not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, got {p}")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"the kernel takes a state of 1..{MAX_STATE}, "
                         f"got {n}")
    if min(b, l, h) == 0 or chunk < 1:
        raise ValueError(f"empty input or chunk {chunk} < 1")
    devs = {t.device for t in (x, dt, A, B, C, init_state) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: "
                         f"{sorted(map(str, devs))}")


def launch(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
           B: torch.Tensor, C: torch.Tensor, chunk: int,
           init_state: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked scan on the current stream of the tensors' card;
    returns ``(y (b, l, h, p), state (b, h, p, n))`` in x's dtype. Checks
    its inputs; raises ``RuntimeError`` on a non-zero launch status; does
    not synchronise."""
    check_inputs(x, dt, A, B, C, chunk, init_state)
    lib = load()
    b, l, h, p = x.shape
    n = B.shape[-1]
    chunk = min(chunk, l)
    smem = lib.ssd_scan_smem_bytes(p, n, chunk)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"chunk {chunk} at p={p}, n={n} needs {smem} bytes "
                         f"of shared memory, more than {MAX_SMEM_BYTES}")
    x, B, C = x.contiguous(), B.contiguous(), C.contiguous()
    dt, A = dt.float().contiguous(), A.float().contiguous()
    init = None if init_state is None else init_state.float().contiguous()
    dev = x.device
    with torch.cuda.device(dev):
        y = torch.empty_like(x)
        state = torch.empty((b, h, p, n), dtype=x.dtype, device=dev)
        status = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), None if init is None else init.data_ptr(),
            y.data_ptr(), state.data_ptr(), b, l, h, p, n, chunk,
            DTYPES[x.dtype], torch.cuda.current_stream(dev).cuda_stream)
    if status != 0:
        msg = lib.ssd_scan_error_string(status).decode()
        raise RuntimeError(f"ssd_scan launch failed (x {tuple(x.shape)}, "
                           f"n={n}, chunk={chunk}, {x.dtype}): CUDA error "
                           f"{status} ({msg})")
    return y, state
