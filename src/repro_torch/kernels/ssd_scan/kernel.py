"""Build and ctypes binding of the CUDA SSD-scan kernels.

The kernels (``src/repro_torch/csrc/ssd_scan.cu``) are compiled by hand
with ``nvcc`` for ``sm_90a`` at first use, through the port's shared
build helper (:mod:`repro_torch.kernels.nvcc`), into
``build/repro_torch/libssd_scan-<hash>.so``. Nothing here runs at import
time. Two kernels live in the library, and the dtype picks one
(:data:`KERNEL_FOR_DTYPE`): bf16 runs as three chunk-parallel passes on
the tensor cores (``ssd_scan_mma_launch``, with a workspace allocated
here), f32 on the CUDA cores (``ssd_scan_launch``), since TF32 products
would miss the f32 tolerance of 1e-5.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels._tensor import aligned16, on_card
from repro_torch.kernels.nvcc import CudaLibrary

HEAD_DIMS = (16, 32, 64, 128)
MAX_STATE = 128
MAX_GRID_YZ = 65535              # b and h index the grid's y and z axes
MAX_SMEM_BYTES = 227 * 1024
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: The kernel of each dtype: "mma" on the tensor cores, "simt" on the
#: CUDA cores.
KERNEL_FOR_DTYPE = {torch.bfloat16: "mma", torch.float32: "simt"}


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_launch.argtypes = [ptr] * 8 + [i32] * 7 + [ptr]
    lib.ssd_scan_launch.restype = i32
    lib.ssd_scan_mma_launch.argtypes = [ptr] * 9 + [i32] * 6 + [ptr]
    lib.ssd_scan_mma_launch.restype = i32
    lib.ssd_scan_smem_bytes.argtypes = [i32] * 3
    lib.ssd_scan_smem_bytes.restype = i32
    lib.ssd_scan_mma_smem_bytes.argtypes = [i32] * 3
    lib.ssd_scan_mma_smem_bytes.restype = i32
    lib.ssd_scan_mma_workspace_bytes.argtypes = [i32] * 6
    lib.ssd_scan_mma_workspace_bytes.restype = ctypes.c_longlong
    lib.ssd_scan_error_string.argtypes = [i32]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("ssd_scan", _bind)
load = LIBRARY.load


def check_inputs(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, chunk: int,
                 init_state: Optional[torch.Tensor]) -> None:
    """Raise on what the kernels do not take."""
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
    if max(b, h) > MAX_GRID_YZ:
        raise ValueError(f"the kernels take b and h up to {MAX_GRID_YZ}, "
                         f"got b={b}, h={h}")
    devs = {t.device for t in (x, dt, A, B, C, init_state) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: "
                         f"{sorted(map(str, devs))}")


def kernel_for(dtype: torch.dtype) -> str:
    """The kernel that runs ``dtype``: the one place the choice is made."""
    if dtype not in KERNEL_FOR_DTYPE:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {dtype}")
    return KERNEL_FOR_DTYPE[dtype]


def launch(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
           B: torch.Tensor, C: torch.Tensor, chunk: int,
           init_state: Optional[torch.Tensor] = None,
           which: Optional[str] = None,
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked scan on the current stream of the tensors' card;
    returns ``(y (b, l, h, p), state (b, h, p, n))`` in x's dtype.
    ``which`` names the kernel ("mma" or "simt"); by default the dtype's
    (:func:`kernel_for`), the only choice the public op makes. Checks its
    inputs; raises ``RuntimeError`` on a non-zero launch status; does not
    synchronise."""
    check_inputs(x, dt, A, B, C, chunk, init_state)
    which = which or kernel_for(x.dtype)
    if which == "mma" and x.dtype != torch.bfloat16:
        raise TypeError(f"the tensor-core kernel takes bfloat16, got "
                        f"{x.dtype}")
    if which not in ("mma", "simt"):
        raise ValueError(f"no ssd_scan kernel {which!r}")
    lib = load()
    b, l, h, p = x.shape
    n = B.shape[-1]
    chunk = min(chunk, l)
    smem = (lib.ssd_scan_mma_smem_bytes if which == "mma"
            else lib.ssd_scan_smem_bytes)(p, n, chunk)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"chunk {chunk} at p={p}, n={n} needs {smem} bytes "
                         f"of shared memory, more than {MAX_SMEM_BYTES}")
    x, B, C = aligned16(x), aligned16(B), aligned16(C)
    dt, A = dt.float().contiguous(), A.float().contiguous()
    init = None if init_state is None else init_state.float().contiguous()
    dev = x.device
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=x.dtype, device=dev)
    ptrs = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), None if init is None else init.data_ptr(),
            y.data_ptr(), state.data_ptr())
    with on_card(dev) as stream:
        if which == "mma":
            nbytes = lib.ssd_scan_mma_workspace_bytes(b, l, h, p, n, chunk)
            ws = torch.empty(nbytes, dtype=torch.uint8, device=dev)
            status = lib.ssd_scan_mma_launch(*ptrs, ws.data_ptr(), b, l, h,
                                             p, n, chunk, stream)
        else:
            status = lib.ssd_scan_launch(*ptrs, b, l, h, p, n, chunk,
                                         DTYPES[x.dtype], stream)
    if status != 0:
        msg = lib.ssd_scan_error_string(status).decode()
        raise RuntimeError(f"ssd_scan {which} launch failed (x "
                           f"{tuple(x.shape)}, n={n}, chunk={chunk}, "
                           f"{x.dtype}): CUDA error {status} ({msg})")
    return y, state
