"""Tensor helpers shared by the kernels' launch wrappers."""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, as the kernels' vector loads
    need it (a copy only when the storage offset breaks the alignment)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@contextlib.contextmanager
def on_card(dev: torch.device) -> Iterator[int]:
    """Make ``dev`` the current CUDA device and yield the handle of its
    current stream, the one a kernel is launched on."""
    with torch.cuda.device(dev):
        yield torch.cuda.current_stream(dev).cuda_stream


def refuse_grad(op: str, *tensors) -> None:
    """Raise when grad mode is on and one of ``tensors`` (``None``s
    skipped) requires grad: for a kernel that computes the forward only
    (``ssd_scan``), an output written through ctypes would silently carry
    no gradient back to its inputs. Its backward kernel is ROADMAP A7b."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{op}: the CUDA kernel has no backward yet (ROADMAP A7b, the "
            f"ssd_scan backward); call it under torch.no_grad() or "
            f"torch.inference_mode(), or on CPU tensors, whose plain "
            f"version autograd differentiates")
