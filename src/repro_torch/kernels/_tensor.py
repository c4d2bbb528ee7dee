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
