"""Plain torch oracles: exact (materialized-scores) GQA attention, the
JAX package's ``kernels/flash_attn/ref.py``, with its rows' log-sum-exp
and its gradient from the formulas the backward kernel computes."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

NEG_INF = -1e30


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """Scaled f32 scores ``(B, H, Sq, Skv)`` with k expanded to q's heads,
    NEG_INF where the right-aligned causal mask hides a key."""
    sq, h, d = q.shape[1], q.shape[2], q.shape[3]
    skv, kh = k.shape[1], k.shape[2]
    if kh != h:
        k = torch.repeat_interleave(k, h // kh, dim=2)
    scale = 1.0 / np.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        ki = torch.arange(skv, device=q.device)[None, :]
        s = torch.where(ki <= qi, s, NEG_INF)
    return s


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Skv, K, D) with H % K == 0.
    f32 softmax; output in q's dtype."""
    h = q.shape[2]
    if v.shape[2] != h:
        v = torch.repeat_interleave(v, h // v.shape[2], dim=2)
    p = torch.softmax(_scores(q, k, causal), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).to(q.dtype)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                      causal: bool = True) -> torch.Tensor:
    """The rows' log-sum-exp of the scaled scores, ``(B, H, Sq)`` f32:
    what the forward kernel writes beside its output for the backward."""
    return torch.logsumexp(_scores(q, k, causal), dim=-1)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                      causal: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of attention, in the inputs' dtype, from the
    backward kernel's formulas in plain torch (f32 throughout):

    ``P = exp(s * scale - lse)`` (0 where masked), ``Dv = rowsum(dout *
    o)``, ``dV = P~^T dout`` with ``P~`` P rounded to v's dtype (the
    forward rounds p before p . v), ``dP = dout V^T``, ``dS = P * (dP -
    Dv)``, ``dQ = scale * dS K``, ``dK = scale * dS^T Q``; dK and dV
    summed over each GQA group. ``o`` and ``lse`` are the forward's
    output and rows' log-sum-exp."""
    b, sq, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    scale = 1.0 / np.sqrt(d)
    qf, kf, vf = q.float(), k.float(), v.float()
    of, dof = o.float(), dout.float()
    ke = torch.repeat_interleave(kf, g, dim=2) if g > 1 else kf
    ve = torch.repeat_interleave(vf, g, dim=2) if g > 1 else vf
    s = _scores(qf, ke, causal)
    p = torch.exp(s - lse.float()[..., None])      # exactly 0 where masked
    pt = p.to(v.dtype).float()
    dvec = (dof * of).sum(dim=-1).permute(0, 2, 1)           # (b, h, sq)
    dv = torch.einsum("bhqk,bqhd->bkhd", pt, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, ve)
    ds = p * (dp - dvec[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, ke) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale

    def group_sum(t: torch.Tensor) -> torch.Tensor:
        skv = t.shape[1]
        return t.reshape(b, skv, kh, g, d).sum(dim=3) if g > 1 else t

    return (dq.to(q.dtype), group_sum(dk).to(k.dtype),
            group_sum(dv).to(v.dtype))
