"""GQA attention: full / blockwise-causal self-attention, cross-attention,
prefill, decode.

The JAX package's ``models/attention.py`` on torch tensors, with its
layouts: q ``(B, S, H, hd)``, k / v ``(B, S, K, hd)``, weights
``(in, out)``. Three execution paths share one set of weights:

* ``full``      -- materialized-scores attention for short sequences.
* ``blockwise`` -- exact-causal blocked online-softmax attention over the
  statically enumerated lower-triangular (q_block, kv_block) pairs, as a
  Python loop; no (S, S) score tensor is materialized.
* ``decode``    -- one-token attention against a KV cache, grouped
  against the unexpanded cache.

Routing of prefill attention -- causal self-attention (``self_attention``,
``prefill_self_attention``), the encoder's non-causal self-attention and
cross-attention (``cross_attention``, no mask, ``Sq != Skv``): a CUDA
tensor goes through the hand-written flash-attention kernel
(``kernels/flash_attn``) at every length -- the kernel computes the
function both plain paths compute, masked or not, and its backward
kernel the gradient when autograd asks for one. A CPU tensor takes
the JAX package's own path (self-attention: full up to
``BLOCKWISE_THRESHOLD``, blockwise above; cross-attention: full), so the
parity tests compare like with like. Decode attention stays plain
torch: the JAX package has no kernel for it. All paths accumulate
softmax statistics in f32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.models.layers import (
    Params,
    apply_rope,
    dense_init,
    dtype_of,
    head_rmsnorm,
)

NEG_INF = -1e30

# Sequence length above which the CPU route takes the blockwise path.
BLOCKWISE_THRESHOLD = 4096
Q_BLOCK = 512
KV_BLOCK = 512


def set_blockwise_threshold(n: int) -> None:
    global BLOCKWISE_THRESHOLD
    BLOCKWISE_THRESHOLD = n


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def attention_init(gen: torch.Generator, cfg: ModelConfig,
                   cross: bool = False) -> Params:
    dt = dtype_of(cfg)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, d, cfg.n_heads * hd, dt),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, dt),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, dt),
        "wo": dense_init(gen, cfg.n_heads * hd, d, dt,
                         scale=1.0 / np.sqrt(2 * cfg.n_layers)),
    }
    if cfg.qk_norm and not cross:
        p["q_norm"] = torch.ones((hd,), dtype=dt, device=gen.device)
        p["k_norm"] = torch.ones((hd,), dtype=dt, device=gen.device)
    return p


def _project_qkv(params: Params, xq: torch.Tensor, xkv: torch.Tensor,
                 cfg: ModelConfig, q_positions: Optional[torch.Tensor],
                 kv_positions: Optional[torch.Tensor], use_rope: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project to (B, S, H, hd) / (B, Skv, K, hd) and apply qk-norm + RoPE."""
    hd = cfg.resolved_head_dim
    b, sq, _ = xq.shape
    skv = xkv.shape[1]
    q = (xq @ params["wq"]).reshape(b, sq, cfg.n_heads, hd)
    k = (xkv @ params["wk"]).reshape(b, skv, cfg.n_kv_heads, hd)
    v = (xkv @ params["wv"]).reshape(b, skv, cfg.n_kv_heads, hd)
    if "q_norm" in params:
        q = head_rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = head_rmsnorm(params["k_norm"], k, cfg.norm_eps)
    if use_rope:
        q = apply_rope(q, q_positions, cfg.rope_theta)
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    return q, k, v


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, K, hd) -> (B, S, H, hd) by repeating each KV head."""
    n_kv = k.shape[2]
    if n_kv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // n_kv, dim=2)


# ---------------------------------------------------------------------------
# Full (materialized scores) attention
# ---------------------------------------------------------------------------

def _full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool) -> torch.Tensor:
    b, sq, h, hd = q.shape
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    scale = 1.0 / np.sqrt(hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        skv = k.shape[1]
        qi = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        ki = torch.arange(skv, device=q.device)[None, :]
        scores = torch.where(ki <= qi, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# ---------------------------------------------------------------------------
# Blockwise exact-causal attention (static lower-triangle pair walk)
# ---------------------------------------------------------------------------

def _causal_pairs(nq: int, nk: int, q_block: int, kv_block: int,
                  offset: int, causal: bool):
    """The (q block, kv block) pairs that hold an allowed score, in the
    JAX package's order (the lower triangle when causal)."""
    pairs = []
    for i in range(nq):
        for j in range(nk):
            q_last = i * q_block + offset + q_block - 1
            if not causal or j * kv_block <= q_last:
                pairs.append((i, j))
    return pairs


def _blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, q_block: int = Q_BLOCK,
                         kv_block: int = KV_BLOCK) -> torch.Tensor:
    """Exact blocked online-softmax attention without materializing
    (S, S): a Python loop over the statically enumerated block pairs,
    carrying per-q-block accumulators (acc, m, l) in f32."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    nq = -(-sq // q_block)
    nk = -(-skv // kv_block)
    offset = skv - sq          # right-aligned causal (0 for self-attention)
    scale = 1.0 / np.sqrt(hd)
    dev = q.device
    acc = [torch.zeros((b, q_block, h, hd), dtype=torch.float32, device=dev)
           for _ in range(nq)]
    m = [torch.full((b, q_block, h), NEG_INF, dtype=torch.float32,
                    device=dev) for _ in range(nq)]
    l = [torch.zeros((b, q_block, h), dtype=torch.float32, device=dev)
         for _ in range(nq)]

    def block(t: torch.Tensor, i: int, size: int) -> torch.Tensor:
        blk = t[:, i * size:(i + 1) * size]
        pad = size - blk.shape[1]
        if pad:
            blk = torch.nn.functional.pad(blk, (0, 0, 0, 0, 0, pad))
        return blk

    for i, j in _causal_pairs(nq, nk, q_block, kv_block, offset, causal):
        qi, ki, vi = block(q, i, q_block), block(k, j, kv_block), \
            block(v, j, kv_block)
        s = torch.einsum("bqhd,bkhd->bhqk", qi, ki).float() * scale
        qp = torch.arange(i * q_block, (i + 1) * q_block, device=dev) + offset
        kp = torch.arange(j * kv_block, (j + 1) * kv_block, device=dev)
        valid = (kp < skv)[None, :]
        if causal:
            valid = valid & (kp[None, :] <= qp[:, None])
        s = torch.where(valid[None, None], s, NEG_INF)
        m_blk = s.amax(dim=-1).permute(0, 2, 1)               # (b, q, h)
        m_new = torch.maximum(m[i], m_blk)
        p = torch.exp(s - m_new.permute(0, 2, 1)[..., None])
        corr = torch.exp(m[i] - m_new)                        # (b, q, h)
        l[i] = l[i] * corr + p.sum(dim=-1).permute(0, 2, 1)
        pv = torch.einsum("bhqk,bkhd->bqhd", p.to(vi.dtype), vi)
        acc[i] = acc[i] * corr[..., None] + pv.float()
        m[i] = m_new
    out = torch.cat([a / torch.clamp(li[..., None], min=1e-30)
                     for a, li in zip(acc, l)], dim=1)[:, :sq]
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Decode attention (one new token vs. a KV cache)
# ---------------------------------------------------------------------------

def _decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor,
                      cache_len: Union[int, torch.Tensor]) -> torch.Tensor:
    """q: (B, 1, H, hd); caches: (B, S, K, hd); cache_len: int or (B,).

    GQA is a grouped einsum against the *unexpanded* cache: repeating
    the KV heads would multiply the decode step's memory traffic by H/K,
    and decode is memory-bound."""
    b, _, h, hd = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    qg = q.reshape(b, 1, kh, g, hd)
    scale = 1.0 / np.sqrt(hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache).float() * scale
    pos = torch.arange(s, device=q.device)
    if isinstance(cache_len, torch.Tensor):
        valid = pos[None, :] < cache_len.to(q.device).reshape(-1, 1)
    else:                       # a Python int: no host-to-device copy
        valid = (pos < cache_len)[None, :]                    # (B or 1, S)
    scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v_cache)
    return out.reshape(b, 1, h, hd)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def _on_card(t: torch.Tensor) -> bool:
    """Whether attention over ``t`` takes the kernel: a CUDA tensor."""
    return t.device.type == "cuda"


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, use_blockwise: bool) -> torch.Tensor:
    """Prefill attention, causal (right-aligned) or unmasked (``Sq`` may
    differ from ``Skv``): the kernel for a CUDA tensor; on the CPU the
    blockwise or the full path."""
    if _on_card(q):
        return flash_ops.flash_attention(q, k, v, causal=causal)
    if use_blockwise:
        return _blockwise_attention(q, k, v, causal=causal)
    return _full_attention(q, k, v, causal=causal)


def self_attention(params: Params, x: torch.Tensor, cfg: ModelConfig,
                   causal: bool = True,
                   positions: Optional[torch.Tensor] = None,
                   use_rope: bool = True,
                   force_blockwise: Optional[bool] = None) -> torch.Tensor:
    """Training / prefill self-attention over (B, S, d_model).
    ``force_blockwise`` pins the CPU route's path."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project_qkv(params, x, x, cfg, positions, positions, use_rope)
    use_blockwise = (s > BLOCKWISE_THRESHOLD if force_blockwise is None
                     else force_blockwise)
    o = _attend(q, k, v, causal, use_blockwise)
    return o.reshape(b, s, -1) @ params["wo"]


def cross_kv(params: Params, ctx: torch.Tensor, cfg: ModelConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K / V ``(B, F, K, hd)`` of the context (the
    encoder output): its projections, with no norm and no RoPE."""
    b, f, _ = ctx.shape
    hd = cfg.resolved_head_dim
    return ((ctx @ params["wk"]).reshape(b, f, cfg.n_kv_heads, hd),
            (ctx @ params["wv"]).reshape(b, f, cfg.n_kv_heads, hd))


def cross_attend(params: Params, x: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Cross-attention of ``x`` (B, S, d_model) to projected K / V (from
    :func:`cross_kv`): no mask, no RoPE; on the CPU the JAX package's
    full path at every length."""
    b, s, _ = x.shape
    q = (x @ params["wq"]).reshape(b, s, cfg.n_heads, cfg.resolved_head_dim)
    o = _attend(q, k, v, causal=False, use_blockwise=False)
    return o.reshape(b, s, -1) @ params["wo"]


def cross_attention(params: Params, x: torch.Tensor, ctx: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """Decoder -> encoder cross-attention (no mask, no RoPE)."""
    k, v = cross_kv(params, ctx, cfg)
    return cross_attend(params, x, k, v, cfg)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  n_layers: Optional[int] = None,
                  device: Optional[torch.device] = None
                  ) -> Dict[str, object]:
    dt = dtype_of(cfg)
    L = n_layers if n_layers is not None else cfg.n_layers
    shape = (L, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "length": 0,
    }


def decode_self_attention(params: Params, x: torch.Tensor, cfg: ModelConfig,
                          k_cache: torch.Tensor, v_cache: torch.Tensor,
                          cache_len: int
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """One-token decode. x: (B, 1, d). Returns (out, k_cache, v_cache).

    Unlike the JAX package, which returns updated copies, the new K/V
    row is written into ``k_cache`` / ``v_cache`` in place (at position
    ``cache_len``): a copy of the whole cache per step would move more
    bytes than the step itself reads."""
    b = x.shape[0]
    pos = torch.full((b, 1), cache_len, dtype=torch.long, device=x.device)
    q, k_new, v_new = _project_qkv(params, x, x, cfg, pos, pos,
                                   use_rope=True)
    k_cache[:, cache_len] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, cache_len] = v_new[:, 0].to(v_cache.dtype)
    o = _decode_attention(q, k_cache, v_cache, cache_len + 1)
    out = o.reshape(b, 1, -1) @ params["wo"]
    return out, k_cache, v_cache


def prefill_self_attention(params: Params, x: torch.Tensor, cfg: ModelConfig
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Prefill: causal attention returning output and the K/V to cache."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project_qkv(params, x, x, cfg, positions, positions, True)
    o = _attend(q, k, v, True, s > BLOCKWISE_THRESHOLD)
    out = o.reshape(b, s, -1) @ params["wo"]
    return out, k, v
