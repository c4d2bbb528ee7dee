"""Plain PyTorch versions of the store-buffer timeline under the five
commit rules, before the max-plus collapse.

Self-contained: they re-state the rules instead of importing the
simulator, so the tests pin the CUDA kernel, these loops and the JAX
package against each other. :func:`store_timeline_ref` walks one cell
step by step as the JAX package's ``simulator._timeline`` does (a ring of
the last ``sb`` commit times, oldest first, all zero at the start);
:func:`store_timeline_batch_ref` walks time-major ``(n_stores, B)`` cells
as ``simulator._timeline_batch`` does (every rule evaluated per step, the
lane's picked by ``config_idx``, one ``(B, sb_max)`` circular ring read at
slot ``(i - sb) % sb_max``). Per store::

    r = max(a, c_{i-sb})                 sb_full += c_{i-sb} > a
    wb         c = max(r, c_{i-1}) + t_l1
    wt         c = max(r, c_{i-1}) + t_wt
    baseline   c = max(r, c_{i-1}) + (co ? t_l1 : coh + tr)
    parallel   c = max(r, c_{i-1}) + (co ? t_l1 : max(coh, tr))
    proactive  c = co ? max(r, c_{i-1}) + t_l1
                      : max(max(r + tr, r + coh), c_{i-1} + sv)
               at_head += !co and r >= c_{i-1}

IEEE f32 add, max and compares only, so the result is bit-identical to
the JAX package's. Both return ``(last commit time f32, at_head i32,
sb_full i32)``; they run on any device, one torch op at a time.
"""

from __future__ import annotations

from typing import Tuple

import torch

#: The commit rules, by their index in ``config_idx``.
CONFIGS = ("wb", "wt", "baseline", "parallel", "proactive")


def store_timeline_ref(arrivals: torch.Tensor, coalesce: torch.Tensor,
                       exposed: torch.Tensor, t_repl_i: torch.Tensor,
                       svc_i: torch.Tensor, *, config: str, sb: int,
                       t_l1: float, t_wt: float
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One cell's timeline under ``config``'s rule with an SB of ``sb``
    entries. Inputs are ``(n_stores,)``; returns three 0-d tensors."""
    if config not in CONFIGS:
        raise ValueError(config)
    if sb < 1:
        raise ValueError(f"sb must be >= 1, got {sb}")
    dev = arrivals.device
    f32 = torch.float32
    t_l1 = torch.tensor(t_l1, dtype=f32, device=dev)
    t_wt = torch.tensor(t_wt, dtype=f32, device=dev)
    ring = torch.zeros(sb, dtype=f32, device=dev)
    head = 0                              # ring[head] is c_{i-sb}
    last = torch.zeros((), dtype=f32, device=dev)
    at_head = torch.zeros((), dtype=torch.int32, device=dev)
    sb_full = torch.zeros((), dtype=torch.int32, device=dev)
    steps = zip(arrivals.unbind(0), coalesce.unbind(0), exposed.unbind(0),
                t_repl_i.unbind(0), svc_i.unbind(0))
    for a_i, co_i, coh_i, tr_i, sv_i in steps:
        oldest = ring[head]
        r_i = torch.maximum(a_i, oldest)
        sb_full = sb_full + (oldest > a_i).to(torch.int32)
        if config == "wb":
            c_i = torch.maximum(r_i, last) + t_l1
        elif config == "wt":
            c_i = torch.maximum(r_i, last) + t_wt
        elif config == "baseline":
            extra = torch.where(co_i, t_l1, coh_i + tr_i)
            c_i = torch.maximum(r_i, last) + extra
        elif config == "parallel":
            extra = torch.where(co_i, t_l1, torch.maximum(coh_i, tr_i))
            c_i = torch.maximum(r_i, last) + extra
        else:
            ack_i = r_i + tr_i
            coh_done = r_i + coh_i
            c_raw = torch.maximum(torch.maximum(ack_i, coh_done),
                                  last + sv_i)
            c_i = torch.where(co_i, torch.maximum(r_i, last) + t_l1, c_raw)
            at_head = at_head + (~co_i & (r_i >= last)).to(torch.int32)
        # the oldest slot becomes the newest: the JAX roll(-1).at[-1]
        ring[head] = c_i
        head = head + 1 if head + 1 < sb else 0
        last = c_i
    return last, at_head, sb_full


def store_timeline_batch_ref(arrivals: torch.Tensor, coalesce: torch.Tensor,
                             exposed: torch.Tensor, t_repl_i: torch.Tensor,
                             svc_i: torch.Tensor, config_idx: torch.Tensor,
                             sb_size: torch.Tensor, *, sb_max: int,
                             t_l1: float, t_wt: float
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Per-step timeline of ``B`` lanes over time-major ``(n_stores, B)``
    inputs; ``config_idx`` / ``sb_size`` are ``(B,)`` int32, every depth
    in ``[1, sb_max]``. Returns three ``(B,)`` tensors."""
    n_b = arrivals.shape[1]
    dev = arrivals.device
    if n_b and (int(sb_size.min()) < 1 or int(sb_size.max()) > sb_max):
        raise ValueError(f"every sb_size must be in [1, {sb_max}]")
    if n_b and (int(config_idx.min()) < 0
                or int(config_idx.max()) >= len(CONFIGS)):
        raise ValueError(f"every config_idx must be in [0, {len(CONFIGS)})")
    f32 = torch.float32
    t_l1 = torch.tensor(t_l1, dtype=f32, device=dev)
    t_wt = torch.tensor(t_wt, dtype=f32, device=dev)
    is_wt = config_idx == CONFIGS.index("wt")
    is_bl = config_idx == CONFIGS.index("baseline")
    is_pl = config_idx == CONFIGS.index("parallel")
    is_pr = config_idx == CONFIGS.index("proactive")
    sb = sb_size.long()
    ring = torch.zeros((n_b, sb_max), dtype=f32, device=dev)
    last = torch.zeros(n_b, dtype=f32, device=dev)
    at_head = torch.zeros(n_b, dtype=torch.int32, device=dev)
    sb_full = torch.zeros(n_b, dtype=torch.int32, device=dev)
    steps = zip(arrivals.unbind(0), coalesce.unbind(0), exposed.unbind(0),
                t_repl_i.unbind(0), svc_i.unbind(0))
    for i, (a_i, co_i, coh_i, tr_i, sv_i) in enumerate(steps):
        read = (i - sb) % sb_max
        oldest = ring.gather(1, read[:, None])[:, 0]
        r_i = torch.maximum(a_i, oldest)
        sb_full = sb_full + (oldest > a_i).to(torch.int32)

        serial = torch.maximum(r_i, last)
        c_wb = serial + t_l1
        c_wt = serial + t_wt
        c_bl = serial + torch.where(co_i, t_l1, coh_i + tr_i)
        c_pl = serial + torch.where(co_i, t_l1, torch.maximum(coh_i, tr_i))
        c_pr_raw = torch.maximum(torch.maximum(r_i + tr_i, r_i + coh_i),
                                 last + sv_i)
        c_pr = torch.where(co_i, serial + t_l1, c_pr_raw)
        c_i = torch.where(is_pr, c_pr,
                          torch.where(is_pl, c_pl,
                                      torch.where(is_bl, c_bl,
                                                  torch.where(is_wt, c_wt,
                                                              c_wb))))
        at_head = at_head + (is_pr & ~co_i & (r_i >= last)).to(torch.int32)
        ring[:, i % sb_max] = c_i
        last = c_i
    return last, at_head, sb_full
