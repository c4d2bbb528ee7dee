"""Build and ctypes binding of the CUDA log-dump compressor.

The kernels (``src/repro_torch/csrc/log_compress.cu``) are compiled by
hand with ``nvcc`` for ``sm_90a`` at first use, through the port's
shared build helper (:mod:`repro_torch.kernels.nvcc`), into
``build/repro_torch/liblog_compress-<hash>.so``. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.nvcc import CudaLibrary


def _bind(lib: ctypes.CDLL) -> None:
    lib.log_compress_block.argtypes = []
    lib.log_compress_block.restype = ctypes.c_int
    lib.log_compress_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.log_compress_launch.restype = ctypes.c_int
    lib.log_decompress_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.log_decompress_launch.restype = ctypes.c_int
    lib.log_compress_error_string.argtypes = [ctypes.c_int]
    lib.log_compress_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("log_compress", _bind)
load = LIBRARY.load


def _raise_on(lib: ctypes.CDLL, status: int, what: str) -> None:
    if status != 0:
        msg = lib.log_compress_error_string(status).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {status} "
                           f"({msg})")


def _check_block(lib: ctypes.CDLL, block: int) -> None:
    if block != lib.log_compress_block():
        raise ValueError(f"the kernel takes rows of "
                         f"{lib.log_compress_block()} words, got {block}")


def launch_compress(values: torch.Tensor, base: torch.Tensor, bits: int
                    ) -> tuple:
    """Compress ``(n, 256)`` f32 rows on the current stream of their
    card; returns ``(codes int8 (n, 256), scales f32 (n, 1))``.

    The caller (``ops.compress``) has checked devices, dtypes, shapes
    and contiguity. Raises ``RuntimeError`` on a non-zero launch status;
    does not synchronise."""
    lib = load()
    n, block = values.shape
    _check_block(lib, block)
    dev = values.device
    with torch.cuda.device(dev):
        codes = torch.empty((n, block), dtype=torch.int8, device=dev)
        scales = torch.empty((n, 1), dtype=torch.float32, device=dev)
        status = lib.log_compress_launch(
            values.data_ptr(), base.data_ptr(), n, int(bits),
            codes.data_ptr(), scales.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, status, f"log_compress (n={n}, bits={bits})")
    return codes, scales


def launch_decompress(codes: torch.Tensor, scales: torch.Tensor,
                      base: torch.Tensor) -> torch.Tensor:
    """``base + codes * scales`` over ``(n, 256)`` rows on the current
    stream of their card; returns f32 ``(n, 256)``. Checked by the
    caller (``ops.decompress``); raises on a non-zero launch status."""
    lib = load()
    n, block = codes.shape
    _check_block(lib, block)
    dev = codes.device
    with torch.cuda.device(dev):
        out = torch.empty((n, block), dtype=torch.float32, device=dev)
        status = lib.log_decompress_launch(
            codes.data_ptr(), scales.data_ptr(), base.data_ptr(), n,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, status, f"log_decompress (n={n})")
    return out
