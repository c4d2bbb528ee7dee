"""Dispatcher of the fused bank gather + max-plus scan.

A CUDA tensor launches the hand-written kernel (``kernel.py``) or
raises; a CPU tensor runs the plain torch version (``ref.py``). There is
no override that sends a CUDA tensor to the plain version.
``bank_scan.launches`` counts kernel launches, so a run can show that
its scans went through the kernel, and ``bank_scan.launches_by_ring``
splits them by ring instantiation ("register", "shared", "scratch").
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.bank_scan import kernel
from repro_torch.kernels.bank_scan.ref import bank_scan_ref


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bank_scan runs on CUDA or CPU tensors, got "
                         f"{t.device}")
    return t.device.type


def _check(a_bank: torch.Tensor, w_bank: torch.Tensor, v_bank: torch.Tensor,
           p_bank: torch.Tensor, trace_idx: torch.Tensor,
           wv_idx: torch.Tensor, sb: int) -> None:
    args = {"a_bank": a_bank, "w_bank": w_bank, "v_bank": v_bank,
            "p_bank": p_bank, "trace_idx": trace_idx, "wv_idx": wv_idx}
    want = {"a_bank": torch.float32, "w_bank": torch.float32,
            "v_bank": torch.float32, "p_bank": torch.bool,
            "trace_idx": torch.int32, "wv_idx": torch.int32}
    for name, t in args.items():
        if t.device != a_bank.device:
            raise ValueError(f"{name} is on {t.device}, a_bank on "
                             f"{a_bank.device}")
        if t.dtype != want[name]:
            raise TypeError(f"{name} must be {want[name]}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a_bank.dim() != 2:
        raise ValueError(f"a_bank must be (T, n), got {tuple(a_bank.shape)}")
    for name in ("w_bank", "v_bank", "p_bank"):
        t = args[name]
        if t.dim() != 2 or t.shape != w_bank.shape \
                or t.shape[1] != a_bank.shape[1]:
            raise ValueError(f"{name} must be (P, {a_bank.shape[1]}) like "
                             f"w_bank, got {tuple(t.shape)}")
    if trace_idx.dim() != 1 or trace_idx.shape != wv_idx.shape:
        raise ValueError("trace_idx and wv_idx must be (B,) each, got "
                         f"{tuple(trace_idx.shape)} / {tuple(wv_idx.shape)}")
    if int(sb) < 1:
        raise ValueError(f"sb must be >= 1, got {sb}")


def bank_scan(a_bank: torch.Tensor, w_bank: torch.Tensor,
              v_bank: torch.Tensor, p_bank: torch.Tensor,
              trace_idx: torch.Tensor, wv_idx: torch.Tensor, *,
              chunk: int, sb: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused gather + store-buffer max-plus scan over a columnar bank.

    Banks are store-contiguous (``a_bank (T, n)`` f32; ``w_bank,
    v_bank (P, n)`` f32; ``p_bank (P, n)`` bool); ``trace_idx`` /
    ``wv_idx`` are ``(B,)`` int32 row indices, all on one device. ``sb``
    is the (uniform) store-buffer depth; ``chunk`` is accepted for
    parity with the JAX package, clamped to ``sb`` and the trace, and
    changes no result. Returns per-lane ``(exec_time_ns f32,
    at_head_count i32, sb_full_count i32)`` on the same device, without
    synchronising. CUDA tensors launch the kernel (a lane with an
    out-of-range index gets NaN and -1 counts); CPU tensors run
    :func:`bank_scan_ref`; other devices raise.
    """
    _check(a_bank, w_bank, v_bank, p_bank, trace_idx, wv_idx, sb)
    if _route(a_bank) == "cpu":
        return bank_scan_ref(a_bank, w_bank, v_bank, p_bank, trace_idx,
                             wv_idx, chunk=chunk, sb=sb)
    out = kernel.launch(a_bank, w_bank, v_bank, p_bank, trace_idx, wv_idx,
                        int(sb))
    bank_scan.launches += 1
    bank_scan.launches_by_ring[kernel.ring_for(int(sb))] += 1
    return out


#: Kernel launches since import (CPU calls are not counted), in all and by
#: ring instantiation.
bank_scan.launches = 0
bank_scan.launches_by_ring = {ring: 0 for ring in kernel.RINGS}
