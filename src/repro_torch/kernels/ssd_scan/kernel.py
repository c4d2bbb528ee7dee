"""Build and ctypes binding of the CUDA SSD-scan kernels.

The kernels (``src/repro_torch/csrc/ssd_scan.cu``) are compiled by hand
with ``nvcc`` for ``sm_90a`` at first use, through the port's shared
build helper (:mod:`repro_torch.kernels.nvcc`), into
``build/repro_torch/libssd_scan-<hash>.so``. Nothing here runs at import
time. Two kernels live in the library, and the dtype picks one
(:data:`KERNEL_FOR_DTYPE`): bf16 runs as three chunk-parallel passes on
the tensor cores (``ssd_scan_mma_launch``, with a workspace allocated
here), f32 on the CUDA cores (``ssd_scan_launch``), since TF32 products
would miss the f32 tolerance of 1e-5. Each also has an entry point that
writes the state entering each chunk (``*_priors_launch``), which the
backward reads.

The backward (``csrc/ssd_scan_bwd.cu``) is built the same way into
``libssd_scan_bwd-<hash>.so``, with two routes picked by dtype
(:data:`BWD_KERNEL_FOR_DTYPE`): bf16 on the tensor cores
(``ssd_scan_bwd_mma_launch``, seven launches, the products with B and C
once per head group), f32 on the CUDA cores (``ssd_scan_bwd_launch``,
six launches, f32 products; it also runs bf16 when asked by name, the
yardstick the tensor-core route is timed against). Both take a
workspace allocated here and use no atomics.
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
#: The faults :func:`launch_bwd` can plant for the check on the card
#: (``ssd_scan_bwd_planted_launch``): every chunk decay taken as 1 in the
#: reverse walk, or the last chunk's seg_last gradient dropped.
PLANTED_FAULTS = {"walk": 1, "tail": 2}
#: The kernel of each dtype: "mma" on the tensor cores, "simt" on the
#: CUDA cores.
KERNEL_FOR_DTYPE = {torch.bfloat16: "mma", torch.float32: "simt"}
#: The backward kernels of each dtype: "mma" on the tensor cores, "simt"
#: on the CUDA cores (f32 products: TF32 or bf16 would miss the f32
#: gradient check).
BWD_KERNEL_FOR_DTYPE = {torch.bfloat16: "mma", torch.float32: "simt"}


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
    lib.ssd_scan_priors_launch.argtypes = [ptr] * 9 + [i32] * 7 + [ptr]
    lib.ssd_scan_priors_launch.restype = i32
    lib.ssd_scan_mma_priors_launch.argtypes = [ptr] * 10 + [i32] * 6 + [ptr]
    lib.ssd_scan_mma_priors_launch.restype = i32
    lib.ssd_scan_mma_prior_width.argtypes = [i32]
    lib.ssd_scan_mma_prior_width.restype = i32
    lib.ssd_scan_error_string.argtypes = [i32]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p


def _bind_bwd(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_bwd_launch.argtypes = ([ptr] * 6 + [i32] + [ptr] * 9
                                        + [i32] * 7 + [ptr])
    lib.ssd_scan_bwd_launch.restype = i32
    lib.ssd_scan_bwd_workspace_bytes.argtypes = [i32] * 6
    lib.ssd_scan_bwd_workspace_bytes.restype = ctypes.c_longlong
    lib.ssd_scan_bwd_smem_bytes.argtypes = [i32] * 4
    lib.ssd_scan_bwd_smem_bytes.restype = i32
    lib.ssd_scan_bwd_mma_launch.argtypes = ([ptr] * 6 + [i32] + [ptr] * 9
                                            + [i32] * 6 + [ptr])
    lib.ssd_scan_bwd_mma_launch.restype = i32
    lib.ssd_scan_bwd_planted_launch.argtypes = ([ptr] * 6 + [i32] + [ptr] * 9
                                                + [i32] * 9 + [ptr])
    lib.ssd_scan_bwd_planted_launch.restype = i32
    lib.ssd_scan_bwd_mma_workspace_bytes.argtypes = [i32] * 6
    lib.ssd_scan_bwd_mma_workspace_bytes.restype = ctypes.c_longlong
    lib.ssd_scan_bwd_mma_smem_bytes.argtypes = [i32] * 4
    lib.ssd_scan_bwd_mma_smem_bytes.restype = i32
    lib.ssd_scan_bwd_error_string.argtypes = [i32]
    lib.ssd_scan_bwd_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("ssd_scan", _bind)
load = LIBRARY.load
BWD_LIBRARY = CudaLibrary("ssd_scan_bwd", _bind_bwd)
load_bwd = BWD_LIBRARY.load


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


def bwd_kernel_for(dtype: torch.dtype) -> str:
    """The backward kernels that run ``dtype``: the one place the choice
    is made."""
    if dtype not in BWD_KERNEL_FOR_DTYPE:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {dtype}")
    return BWD_KERNEL_FOR_DTYPE[dtype]


def launch(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
           B: torch.Tensor, C: torch.Tensor, chunk: int,
           init_state: Optional[torch.Tensor] = None,
           which: Optional[str] = None, with_priors: bool = False):
    """The chunked scan on the current stream of the tensors' card;
    returns ``(y (b, l, h, p), state (b, h, p, n))`` in x's dtype -- or
    ``(y, state, priors)`` with ``with_priors``: the state entering each
    chunk, ``(b, h, nc, p, w)`` in x's dtype, ``w`` n ("simt") or n
    padded to 16, 32, 64 or 128 ("mma", zeros past n), which
    :func:`launch_bwd` reads. ``which`` names the kernel ("mma" or
    "simt"); by default the dtype's (:func:`kernel_for`), the only choice
    the public op makes. Checks its inputs; raises ``RuntimeError`` on a
    non-zero launch status; does not synchronise."""
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
    priors = None
    if with_priors:
        width = lib.ssd_scan_mma_prior_width(n) if which == "mma" else n
        priors = torch.empty((b, h, -(-l // chunk), p, width),
                             dtype=x.dtype, device=dev)
    with on_card(dev) as stream:
        if which == "mma":
            nbytes = lib.ssd_scan_mma_workspace_bytes(b, l, h, p, n, chunk)
            ws = torch.empty(nbytes, dtype=torch.uint8, device=dev)
            if priors is None:
                status = lib.ssd_scan_mma_launch(*ptrs, ws.data_ptr(), b, l,
                                                 h, p, n, chunk, stream)
            else:
                status = lib.ssd_scan_mma_priors_launch(
                    *ptrs, priors.data_ptr(), ws.data_ptr(), b, l, h, p, n,
                    chunk, stream)
        elif priors is None:
            status = lib.ssd_scan_launch(*ptrs, b, l, h, p, n, chunk,
                                         DTYPES[x.dtype], stream)
        else:
            status = lib.ssd_scan_priors_launch(*ptrs, priors.data_ptr(), b,
                                                l, h, p, n, chunk,
                                                DTYPES[x.dtype], stream)
    if status != 0:
        msg = lib.ssd_scan_error_string(status).decode()
        raise RuntimeError(f"ssd_scan {which} launch failed (x "
                           f"{tuple(x.shape)}, n={n}, chunk={chunk}, "
                           f"{x.dtype}): CUDA error {status} ({msg})")
    return (y, state) if priors is None else (y, state, priors)


def launch_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               B: torch.Tensor, C: torch.Tensor, chunk: int,
               priors: torch.Tensor, dy: torch.Tensor,
               dstate: Optional[torch.Tensor] = None,
               dinit_dtype: Optional[torch.dtype] = None,
               need: Tuple[bool, ...] = (True,) * 5,
               which: Optional[str] = None, fault: Optional[str] = None):
    """The gradient of the chunked scan on the card: ``(dx, ddt, dA, dB,
    dC, dinit)`` in the dtypes of x, dt, A, B, C and ``dinit_dtype``,
    from the forward's inputs, its ``priors`` (:func:`launch` with
    ``with_priors``), y's gradient ``dy`` (made contiguous here: autograd
    may hand over a strided one) and the final state's ``dstate`` (None:
    unused). ``need`` flags the first five (x, dt, A, B, C); a part not
    asked for is None, and ``dinit`` is None without ``dinit_dtype`` (no
    initial state, or none that needs a gradient). ``which`` names the
    kernels ("mma" or "simt"); by default the dtype's
    (:func:`bwd_kernel_for`), the only choice the public op makes.
    ``fault`` (a key of :data:`PLANTED_FAULTS`) plants that fault in the
    kernels, for the check on the card that it shows in the gradients;
    the op never passes one. Checks its inputs; raises ``RuntimeError`` on
    a non-zero launch status; does not synchronise."""
    check_inputs(x, dt, A, B, C, chunk, None)
    which = which or bwd_kernel_for(x.dtype)
    if which == "mma" and x.dtype != torch.bfloat16:
        raise TypeError(f"the tensor-core backward takes bfloat16, got "
                        f"{x.dtype}")
    if which not in ("mma", "simt"):
        raise ValueError(f"no ssd_scan backward kernel {which!r}")
    if fault is not None and fault not in PLANTED_FAULTS:
        raise ValueError(f"no planted ssd_scan backward fault {fault!r}")
    mma = which == "mma"
    b, l, h, p = x.shape
    n = B.shape[-1]
    chunk = min(chunk, l)
    nc = -(-l // chunk)
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} must be x's {tuple(x.shape)}")
    if (priors.dim() != 5 or priors.shape[:4] != (b, h, nc, p)
            or priors.shape[4] < n or priors.dtype != x.dtype):
        raise ValueError(f"priors must be ({b}, {h}, {nc}, {p}, >= {n}) "
                         f"{x.dtype}, got {tuple(priors.shape)} "
                         f"{priors.dtype}")
    if dstate is not None and dstate.shape != (b, h, p, n):
        raise ValueError(f"dstate must be {(b, h, p, n)}, got "
                         f"{tuple(dstate.shape)}")
    lib = load_bwd()
    smem = (lib.ssd_scan_bwd_mma_smem_bytes if mma
            else lib.ssd_scan_bwd_smem_bytes)(p, n, chunk, l)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"the backward at chunk {chunk}, p={p}, n={n}, "
                         f"l={l} needs {smem} bytes of shared memory, more "
                         f"than {MAX_SMEM_BYTES}")
    dev = x.device
    x, B, C = aligned16(x), aligned16(B), aligned16(C)
    dy, priors = aligned16(dy.to(x.dtype)), aligned16(priors)
    dtf, Af = dt.float().contiguous(), A.float().contiguous()
    dsf = None if dstate is None else dstate.float().contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    need_x, need_dt, need_A, need_B, need_C = need
    outs = (torch.empty_like(x) if need_x else None,
            torch.empty((b, l, h), **f32) if need_dt else None,
            torch.empty((h,), **f32) if need_A else None,
            torch.empty_like(B) if need_B else None,
            torch.empty_like(C) if need_C else None,
            torch.empty((b, h, p, n), **f32) if dinit_dtype else None)
    nbytes = (lib.ssd_scan_bwd_mma_workspace_bytes if mma
              else lib.ssd_scan_bwd_workspace_bytes)(b, l, h, p, n, chunk)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    ptr = (lambda t: None if t is None else t.data_ptr())
    args = (x.data_ptr(), dtf.data_ptr(), Af.data_ptr(), B.data_ptr(),
            C.data_ptr(), priors.data_ptr(), priors.shape[4], dy.data_ptr(),
            ptr(dsf), *map(ptr, outs), ws.data_ptr(), b, l, h, p, n, chunk)
    with on_card(dev) as stream:
        if fault is not None:
            status = lib.ssd_scan_bwd_planted_launch(
                *args, DTYPES[x.dtype], int(mma), PLANTED_FAULTS[fault],
                stream)
        elif mma:
            status = lib.ssd_scan_bwd_mma_launch(*args, stream)
        else:
            status = lib.ssd_scan_bwd_launch(*args, DTYPES[x.dtype], stream)
    if status != 0:
        msg = lib.ssd_scan_bwd_error_string(status).decode()
        raise RuntimeError(f"ssd_scan backward {which} launch failed (x "
                           f"{tuple(x.shape)}, n={n}, chunk={chunk}, "
                           f"{x.dtype}): CUDA error {status} ({msg})")
    dx, ddt, dA, dB, dC, dinit = outs
    return (dx, None if ddt is None else ddt.to(dt.dtype),
            None if dA is None else dA.to(A.dtype), dB, dC,
            None if dinit is None else dinit.to(dinit_dtype))
