"""Plain torch oracle: exact (materialized-scores) GQA attention, the
JAX package's ``kernels/flash_attn/ref.py``."""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Skv, K, D) with H % K == 0.
    f32 softmax; output in q's dtype."""
    sq, h, d = q.shape[1], q.shape[2], q.shape[3]
    skv, kh = k.shape[1], k.shape[2]
    if kh != h:
        k = torch.repeat_interleave(k, h // kh, dim=2)
        v = torch.repeat_interleave(v, h // kh, dim=2)
    scale = 1.0 / np.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        ki = torch.arange(skv, device=q.device)[None, :]
        s = torch.where(ki <= qi, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).to(q.dtype)
