"""Plain PyTorch version of the fused bank-gather + max-plus scan.

Self-contained: it re-states the recurrence instead of importing the
simulator, so the kernel tests pin the CUDA kernel, this version and the
JAX package against each other. Inputs are the store-contiguous
:class:`~repro_torch.core.simulator.TraceBank` columns: ``a_bank (T, n)``
arrivals, ``w_bank / v_bank (P, n)`` the precollapsed max-plus terms,
``p_bank (P, n)`` the proactive non-coalesced mask, plus per-lane
``int32`` row indices. Per store ``i`` of a lane::

    r_i = max(a_i, c_{i-sb})          # retire waits for a free SB slot
    c_i = max(r_i + w_i, c_{i-1} + v_i)

with the SB-full census counting ``c_{i-sb} > a_i`` and the
REPL-at-head census counting ``p_i and r_i >= c_{i-1}``. The commit
history starts all zero.

The loop walks the stores in blocks of ``chunk <= sb``: every
``c_{i-sb}`` a block reads was committed in an earlier block, so the
block's ring reads, retire times and SB-full census are one vectorised
step and only ``c = max(u_k, c + v_k)`` runs per store. The arithmetic
is the same IEEE add and max in the same order for every chunk, so the
result does not depend on it. Runs on any device; vectorised over lanes.
"""

from __future__ import annotations

from typing import Tuple

import torch


def bank_scan_ref(a_bank: torch.Tensor, w_bank: torch.Tensor,
                  v_bank: torch.Tensor, p_bank: torch.Tensor,
                  trace_idx: torch.Tensor, wv_idx: torch.Tensor, *,
                  chunk: int, sb: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gather each lane's rows, then run the store-buffer recurrence.

    Returns per-lane ``(exec_time_ns f32, at_head i32, sb_full i32)``,
    each ``(B,)``, on the inputs' device. ``chunk`` is clamped to
    ``[1, min(sb, n)]``.
    """
    n = a_bank.shape[1]
    chunk = max(1, min(chunk, sb, n))
    tr, wv = trace_idx.long(), wv_idx.long()
    a = a_bank.index_select(0, tr).T.contiguous()         # (n, B)
    w = w_bank.index_select(0, wv).T.contiguous()
    v = v_bank.index_select(0, wv).T.contiguous()
    p = p_bank.index_select(0, wv).T.contiguous()
    n_b = tr.shape[0]
    dev = a_bank.device
    hist = torch.zeros((sb, n_b), dtype=torch.float32, device=dev)
    last = torch.zeros(n_b, dtype=torch.float32, device=dev)
    at_head = torch.zeros(n_b, dtype=torch.int32, device=dev)
    sb_full = torch.zeros(n_b, dtype=torch.int32, device=dev)
    for base in range(0, n, chunk):
        k_len = min(chunk, n - base)
        a_b = a[base:base + k_len]
        old = hist[:k_len]                  # c_{i-sb}, oldest first
        r = torch.maximum(a_b, old)
        sb_full += (old > a_b).sum(0, dtype=torch.int32)
        u = r + w[base:base + k_len]
        v_b = v[base:base + k_len]
        prev = [last]
        for k in range(k_len):
            last = torch.maximum(u[k], last + v_b[k])
            prev.append(last)
        c = torch.stack(prev[1:])
        at_head += (p[base:base + k_len] & (r >= torch.stack(prev[:-1]))
                    ).sum(0, dtype=torch.int32)
        hist = torch.cat([hist[k_len:], c])
    return last, at_head, sb_full
