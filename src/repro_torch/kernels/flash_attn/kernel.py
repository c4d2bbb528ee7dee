"""Build and ctypes binding of the CUDA flash-attention kernel.

The kernel (``src/repro_torch/csrc/flash_attn.cu``) is compiled by hand
with ``nvcc`` for ``sm_90a`` at first use, through the port's shared
build helper (:mod:`repro_torch.kernels.nvcc`), into
``build/repro_torch/libflash_attn-<hash>.so``. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels._tensor import aligned16
from repro_torch.kernels.nvcc import CudaLibrary

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    lib.flash_attn_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    lib.flash_attn_launch.restype = ctypes.c_int
    lib.flash_attn_error_string.argtypes = [ctypes.c_int]
    lib.flash_attn_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("flash_attn", _bind)
load = LIBRARY.load


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool) -> None:
    """Raise on what the kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, Sq, H, D) and k, v (B, Skv, K, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2] != 0:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}: batch and head dim must agree "
                         f"and H a multiple of K")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.dtype not in DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, got {d}")
    if min(q.shape) == 0 or min(k.shape) == 0:
        raise ValueError("empty q or k")
    if causal and k.shape[1] < sq:
        raise ValueError(f"causal attention needs Skv >= Sq, got "
                         f"Skv={k.shape[1]}, Sq={sq}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool) -> torch.Tensor:
    """Attention on the current stream of the tensors' card; returns
    ``(B, Sq, H, D)`` in q's dtype. Checks its inputs; raises
    ``RuntimeError`` on a non-zero launch status; does not synchronise."""
    check_inputs(q, k, v, causal)
    lib = load()
    q, k, v = aligned16(q), aligned16(k), aligned16(v)
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    dev = q.device
    with torch.cuda.device(dev):
        out = torch.empty_like(q)
        status = lib.flash_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            skv, h, kh, d, int(causal), float(1.0 / np.sqrt(d)),
            DTYPES[q.dtype], torch.cuda.current_stream(dev).cuda_stream)
    if status != 0:
        msg = lib.flash_attn_error_string(status).decode()
        raise RuntimeError(f"flash_attn launch failed (q {tuple(q.shape)}, "
                           f"k {tuple(k.shape)}, {q.dtype}): CUDA error "
                           f"{status} ({msg})")
    return out
