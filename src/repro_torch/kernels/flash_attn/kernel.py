"""Build and ctypes binding of the CUDA flash-attention kernels.

The forward kernels (``src/repro_torch/csrc/flash_attn.cu``) and the
backward's (``csrc/flash_attn_bwd.cu``) are compiled by hand with
``nvcc`` for ``sm_90a`` at first use, through the port's shared build
helper (:mod:`repro_torch.kernels.nvcc`), into
``build/repro_torch/libflash_attn-<hash>.so`` and
``libflash_attn_bwd-<hash>.so``. Nothing here runs at import time. Two
forward kernels live in the first library, and the dtype picks one
(:data:`KERNEL_FOR_DTYPE`): bf16 runs on the tensor cores
(``flash_attn_mma_launch``), f32 on the CUDA cores
(``flash_attn_launch``), since TF32 products would miss the f32
tolerance of 2e-5. Each also has an entry point that writes the rows'
log-sum-exp (``*_lse_launch``), which the backward reads. The backward
library has two kernel pairs too, picked the same way
(:data:`BWD_KERNEL_FOR_DTYPE`): bf16 on the tensor cores
(``flash_attn_bwd_mma_launch``), f32 on the CUDA cores with f32 sums
(``flash_attn_bwd_launch``, which also takes bf16 when asked by name:
the yardstick the tensor-core pair is timed against).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels._tensor import aligned16, on_card
from repro_torch.kernels.nvcc import CudaLibrary

#: The head dims the kernels are instantiated at. The Pallas kernel takes
#: any D (its blocks carry D whole); these are the widths of the configs
#: the port serves, 160 being stablelm-12b's.
HEAD_DIMS = (16, 32, 64, 128, 160)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: The kernel of each dtype: "mma" on the tensor cores, "simt" on the
#: CUDA cores.
KERNEL_FOR_DTYPE = {torch.bfloat16: "mma", torch.float32: "simt"}
#: The backward kernels of each dtype, named as the forward's.
BWD_KERNEL_FOR_DTYPE = {torch.bfloat16: "mma", torch.float32: "simt"}


def _bind(lib: ctypes.CDLL) -> None:
    lib.flash_attn_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    lib.flash_attn_launch.restype = ctypes.c_int
    lib.flash_attn_mma_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    lib.flash_attn_mma_launch.restype = ctypes.c_int
    lib.flash_attn_lse_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.flash_attn_lse_launch.restype = ctypes.c_int
    lib.flash_attn_mma_lse_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p]
    lib.flash_attn_mma_lse_launch.restype = ctypes.c_int
    lib.flash_attn_error_string.argtypes = [ctypes.c_int]
    lib.flash_attn_error_string.restype = ctypes.c_char_p


def _bind_bwd(lib: ctypes.CDLL) -> None:
    lib.flash_attn_bwd_launch.argtypes = [ctypes.c_void_p] * 10 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p]
    lib.flash_attn_bwd_launch.restype = ctypes.c_int
    lib.flash_attn_bwd_mma_launch.argtypes = [ctypes.c_void_p] * 10 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p]
    lib.flash_attn_bwd_mma_launch.restype = ctypes.c_int
    lib.flash_attn_bwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_attn_bwd_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("flash_attn", _bind)
load = LIBRARY.load
BWD_LIBRARY = CudaLibrary("flash_attn_bwd", _bind_bwd)
load_bwd = BWD_LIBRARY.load


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
        raise ValueError(
            f"the kernel is instantiated at head dims {HEAD_DIMS}, got {d}; "
            f"the JAX kernel takes any D, so a config at another width "
            f"needs its instantiation added (ROADMAP B3)")
    if min(q.shape) == 0 or min(k.shape) == 0:
        raise ValueError("empty q or k")
    if causal and k.shape[1] < sq:
        raise ValueError(f"causal attention needs Skv >= Sq, got "
                         f"Skv={k.shape[1]}, Sq={sq}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")


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


def _check_which(which: str, dtype: torch.dtype) -> None:
    if which == "mma" and dtype != torch.bfloat16:
        raise TypeError(f"the tensor-core kernel takes bfloat16, got "
                        f"{dtype}")
    if which not in ("mma", "simt"):
        raise ValueError(f"no flash_attn kernel {which!r}")


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool, which: str | None = None, with_lse: bool = False):
    """Attention on the current stream of the tensors' card; returns
    ``(B, Sq, H, D)`` in q's dtype -- or ``(out, lse)`` with
    ``with_lse``, lse the rows' log-sum-exp ``(B, H, Sq)`` in f32.
    ``which`` names the kernel ("mma" or "simt"); by default the dtype's
    (:func:`kernel_for`), the only choice the public op makes. Checks its
    inputs; raises ``RuntimeError`` on a non-zero launch status; does
    not synchronise."""
    check_inputs(q, k, v, causal)
    which = which or kernel_for(q.dtype)
    _check_which(which, q.dtype)
    lib = load()
    q, k, v = aligned16(q), aligned16(k), aligned16(v)
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    scale = float(1.0 / np.sqrt(d))
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with on_card(q.device) as stream:
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
        dims = (b, sq, skv, h, kh, d, int(causal), scale)
        if which == "mma" and lse is None:
            status = lib.flash_attn_mma_launch(*ptrs, *dims, stream)
        elif which == "mma":
            status = lib.flash_attn_mma_lse_launch(*ptrs, lse.data_ptr(),
                                                   *dims, stream)
        elif lse is None:
            status = lib.flash_attn_launch(*ptrs, *dims, DTYPES[q.dtype],
                                           stream)
        else:
            status = lib.flash_attn_lse_launch(*ptrs, lse.data_ptr(), *dims,
                                               DTYPES[q.dtype], stream)
    if status != 0:
        msg = lib.flash_attn_error_string(status).decode()
        raise RuntimeError(f"flash_attn {which} launch failed (q "
                           f"{tuple(q.shape)}, k {tuple(k.shape)}, "
                           f"{q.dtype}): CUDA error {status} ({msg})")
    return (out, lse) if with_lse else out


def launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
               causal: bool, need_dq: bool = True, need_dkv: bool = True,
               which: str | None = None):
    """The gradient of attention on the card: ``(dq, dk, dv)`` in the
    inputs' dtype, ``None`` for a part not asked for, from the forward's
    inputs, output and lse (:func:`launch` with ``with_lse``) and the
    output's gradient ``dout`` (made contiguous here: autograd may hand
    over a strided one). ``which`` names the kernels ("mma" or "simt");
    by default the dtype's (:func:`bwd_kernel_for`), the only choice the
    autograd op makes. Raises ``RuntimeError`` on a non-zero launch
    status; does not synchronise."""
    check_inputs(q, k, v, causal)
    which = which or bwd_kernel_for(q.dtype)
    _check_which(which, q.dtype)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must be q's {tuple(q.shape)}")
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({b}, {h}, {sq}) float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    lib = load_bwd()
    q, k, v, out = aligned16(q), aligned16(k), aligned16(v), aligned16(out)
    dout, lse = aligned16(dout.to(q.dtype)), lse.contiguous()
    dq = torch.empty_like(q) if need_dq else None
    dk = torch.empty_like(k) if need_dkv else None
    dv = torch.empty_like(v) if need_dkv else None
    dvec = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    ptr = (lambda t: 0 if t is None else t.data_ptr())
    with on_card(q.device) as stream:
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), dout.data_ptr(), ptr(dq), ptr(dk), ptr(dv),
                dvec.data_ptr())
        dims = (b, sq, skv, h, kh, d, int(causal), float(1.0 / np.sqrt(d)))
        if which == "mma":
            status = lib.flash_attn_bwd_mma_launch(*ptrs, *dims, stream)
        else:
            status = lib.flash_attn_bwd_launch(*ptrs, *dims,
                                               DTYPES[q.dtype], stream)
    if status != 0:
        msg = lib.flash_attn_bwd_error_string(status).decode()
        raise RuntimeError(f"flash_attn backward launch failed ({which} "
                           f"kernels, q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype}): CUDA error "
                           f"{status} ({msg})")
    return dq, dk, dv
