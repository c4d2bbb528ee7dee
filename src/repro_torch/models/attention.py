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
parity tests compare like with like. A meta tensor takes the plain
path too, or, inside ``kernels.on_meta()``, the kernel's shape-only
route (``launch/costing.py``). Decode attention stays plain
torch: the JAX package has no kernel for it. All paths accumulate
softmax statistics in f32.

Across ranks that split the ``model`` axis (``sharding.Shard`` leaves)
a rank computes its ``H / m`` query heads when ``wq`` splits them, its
``K / m`` KV heads when ``wk`` / ``wv`` split them, and otherwise every
KV head, sliced to the ones its query heads read (:func:`_local_kv`);
``wo``'s partial is summed over the ``model`` group. Where the heads do
not divide ``m`` (hymba's 25) every rank computes the whole attention
and nothing is summed. The KV cache holds the rank's KV heads, and
where the node blocks do not divide the batch, the rank's span of the
sequence (``sharding.cache_span``): a decode step writes its new row
only in the block that owns the position, and each block's partial
softmax statistics are merged over the blocks
(``collectives.attn_merge``). Cross-attention reads its leaves and
heads the same way.

Where the query heads are split, the attention is a region the
``model`` axis partitions, and its gradient needs these sums over the
``model`` group (what GSPMD derives from the same layout):

* the inputs entering it -- the self-attention's ``x``, the
  cross-attention's ``x`` and the encoder output its K / V read -- go
  through ``sharding.enter``;
* the leaves ``model`` does not split but a rank uses only in part go
  through ``sharding.part_weight``: the ``q_norm`` / ``k_norm`` scales
  (applied to the rank's heads only) and an unsplit ``wk`` / ``wv``
  (sliced or expanded to the group's heads by :func:`_local_kv`);
* ``wo``'s partial leaves it through ``collectives.model_sum``, whose
  backward is the identity.

Under the ``seq_model`` policy (``seq=True``, ``sharding.seq_split``)
the training inputs are this rank's span of the sequence (the
cross-attention's context its span of the frames, decided apart): each
entry is a sequence all-gather and ``wo``'s partial leaves by a
reduce-scatter (``sharding.enter`` / ``leave``); where the heads are not
split the attention computes whole on the gathered input and keeps the
span of its output, every leaf read through ``sharding.part_weight``.
Serving keeps the batch layout.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.config import ModelConfig
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding
from repro_torch.distributed.context import get_mesh_context
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
                 kv_positions: Optional[torch.Tensor], use_rope: bool,
                 seq: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project to (B, S, H, hd) / (B, Skv, K, hd) and apply qk-norm + RoPE;
    ``seq``: the inputs are this rank's span of the sequence, gathered
    on entry (``sharding.enter``)."""
    hd = cfg.resolved_head_dim
    w = sharding.weight
    if _partitioned(params) or seq:
        w = sharding.part_weight
        same = xkv is xq
        xq = sharding.enter(xq, seq)
        xkv = xq if same else sharding.enter(xkv, seq)
    b, sq, _ = xq.shape
    skv = xkv.shape[1]
    q = (xq @ w(params["wq"])).reshape(b, sq, -1, hd)
    k = (xkv @ w(params["wk"])).reshape(b, skv, -1, hd)
    v = (xkv @ w(params["wv"])).reshape(b, skv, -1, hd)
    if "q_norm" in params:
        q = head_rmsnorm(w(params["q_norm"]), q, cfg.norm_eps)
        k = head_rmsnorm(w(params["k_norm"]), k, cfg.norm_eps)
    if use_rope:
        q = apply_rope(q, q_positions, cfg.rope_theta)
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    k, v = _local_kv(params, k, v, cfg)
    return q, k, v


def _partitioned(params: Params) -> bool:
    """Whether the ``model`` axis splits this attention's query heads
    over the ranks (a region it partitions)."""
    return sharding.model_split(params["wq"], 1)


def _local_kv(params: Params, k: torch.Tensor, v: torch.Tensor,
              cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The KV heads this rank's query heads read, when ``wq`` splits the
    query heads over ``model`` and ``wk`` does not split the KV heads
    (computed whole): the group's KV head(s) when the rank's ``H / m``
    heads cover whole GQA groups or lie inside one, else each query
    head's own copy. Otherwise ``k`` / ``v`` as they are."""
    if not sharding.model_split(params["wq"], 1) or \
            sharding.model_split(params["wk"], 1):
        return k, v
    h0, nh = sharding.model_block(params["wq"], 1, cfg.n_heads)
    g = cfg.n_heads // cfg.n_kv_heads
    if nh % g == 0 or g % nh == 0:
        k0, nk = h0 // g, max(nh // g, 1)
        return k[:, :, k0:k0 + nk], v[:, :, k0:k0 + nk]
    return (sharding.constrain_heads(_expand_kv(k, cfg.n_heads)),
            sharding.constrain_heads(_expand_kv(v, cfg.n_heads)))


def _out_proj(params: Params, o: torch.Tensor, seq: bool = False
              ) -> torch.Tensor:
    """``o (B, S, heads, hd) @ wo``; ``wo``'s partial summed over the
    ``model`` group where it splits the heads. ``seq``: the residual
    stream lives as spans, so the partials are reduce-scattered to this
    rank's span, or, where the heads are not split, the span of the
    whole output is kept (``wo`` read through ``sharding.part_weight``:
    its gradient is the span's part)."""
    b, s = o.shape[:2]
    w = sharding.part_weight if seq else sharding.weight
    out = o.reshape(b, s, -1) @ w(params["wo"])
    if sharding.model_split(params["wo"], 0):
        return sharding.leave(out, seq)
    return sharding.to_span(out, seq)


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

def _valid(cache_len: Union[int, torch.Tensor], pos: torch.Tensor
           ) -> torch.Tensor:
    """(B or 1, S) mask of the cache positions ``pos`` below
    ``cache_len`` (an int or (B,))."""
    if isinstance(cache_len, torch.Tensor):
        return pos[None, :] < cache_len.to(pos.device).reshape(-1, 1)
    return (pos < cache_len)[None, :]     # a Python int: no host copy


def _decode_partials(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_len: Union[int, torch.Tensor], start: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One block's share of decode attention over its span of the cache,
    global positions ``[start, start + S)``: the row max ``m`` and row
    sum ``l`` ``(B, K, g, 1)`` and the unnormalised output ``o`` ``(B,
    K, g, 1, hd)``, f32. A block with no valid position gives ``m =
    -inf``, ``l = 0``, ``o = 0``: its exponentials are taken against 0,
    not against ``m``."""
    b, _, h, hd = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, 1, kh, h // kh, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache).float() \
        / np.sqrt(hd)
    valid = _valid(cache_len, start + torch.arange(s, device=q.device))
    scores = torch.where(valid[:, None, None, None, :], scores,
                         float("-inf"))
    m = scores.amax(dim=-1)
    p = torch.exp(scores - torch.where(torch.isfinite(m), m, 0.0)[..., None])
    o = torch.einsum("bkgqs,bskd->bkgqd", p.to(v_cache.dtype), v_cache)
    return m, p.sum(dim=-1), o.float()


def _decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor,
                      cache_len: Union[int, torch.Tensor],
                      start: Optional[int] = None) -> torch.Tensor:
    """q: (B, 1, H, hd); caches: (B, S, K, hd); cache_len: int or (B,).

    GQA is a grouped einsum against the *unexpanded* cache: repeating
    the KV heads would multiply the decode step's memory traffic by H/K,
    and decode is memory-bound. ``start`` given, the caches are this
    block's span of a sequence split over the node blocks, from global
    position ``start``: the block's partials (:func:`_decode_partials`)
    are merged over the blocks (``collectives.attn_merge``)."""
    b, _, h, hd = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    if start is not None:
        m, l, o = _decode_partials(q, k_cache, v_cache, cache_len, start)
        out = collectives.attn_merge(m, l, o, get_mesh_context())
        return out.permute(0, 3, 1, 2, 4).reshape(b, 1, h, hd).to(q.dtype)
    g = h // kh
    qg = q.reshape(b, 1, kh, g, hd)
    scale = 1.0 / np.sqrt(hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache).float() * scale
    valid = _valid(cache_len, torch.arange(s, device=q.device))
    scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v_cache)
    return out.reshape(b, 1, h, hd)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def n_pair_scan_lengths(cfg, shape) -> frozenset:
    """Trip counts of the blockwise-attention pair walks a given (arch,
    shape) cell runs on the plain path above ``BLOCKWISE_THRESHOLD``
    (the JAX package's scan lengths, which its cost pass marks
    VMEM-resident; here the lengths of the ``_causal_pairs`` loops):
    the causal self-attention's lower triangle and the non-causal
    (encoder) walk, for the sequence and, for an enc-dec config, the
    frames."""
    out = set()
    seqs = [shape.seq_len]
    if cfg.is_encdec:
        seqs.append(cfg.n_frames)
    for s in seqs:
        if s <= BLOCKWISE_THRESHOLD:
            continue
        nq = -(-s // Q_BLOCK)
        nk = -(-s // KV_BLOCK)
        # causal lower-triangle count (self-attn; offset 0)
        causal_pairs = sum(min(i + 1, nk) for i in range(nq))
        out.add(causal_pairs)
        out.add(nq * nk)        # non-causal (encoder) variant
    return frozenset(out)


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
    if kernels.ON_META and q.device.type == "meta":
        return flash_ops.flash_attention_meta(q, k, v, causal=causal)
    if use_blockwise:
        return _blockwise_attention(q, k, v, causal=causal)
    return _full_attention(q, k, v, causal=causal)


def self_attention(params: Params, x: torch.Tensor, cfg: ModelConfig,
                   causal: bool = True,
                   positions: Optional[torch.Tensor] = None,
                   use_rope: bool = True,
                   force_blockwise: Optional[bool] = None,
                   seq: bool = False) -> torch.Tensor:
    """Training / prefill self-attention over (B, S, d_model).
    ``force_blockwise`` pins the CPU route's path. ``seq``: ``x`` is this
    rank's span of the S positions, and so is the output."""
    b = x.shape[0]
    s = x.shape[1] * (get_mesh_context().model_size if seq else 1)
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project_qkv(params, x, x, cfg, positions, positions, use_rope,
                           seq)
    use_blockwise = (s > BLOCKWISE_THRESHOLD if force_blockwise is None
                     else force_blockwise)
    o = _attend(q, k, v, causal, use_blockwise)
    return _out_proj(params, o, seq=True) if seq else _out_proj(params, o)


def cross_kv(params: Params, ctx: torch.Tensor, cfg: ModelConfig,
             seq: bool = False, partial: Optional[bool] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K / V ``(B, F, K, hd)`` of the context (the
    encoder output): its projections, with no norm and no RoPE, at the
    KV heads this rank's query heads read (:func:`_local_kv`). ``seq``:
    the context is this rank's span of the frames, gathered whole;
    ``partial``: the attention's ranks each compute a part of its output
    (their heads, or their span of the queries; by default whether the
    heads are split), so the K / V leaves' and the context's gradients
    are parts, summed over ``model``."""
    hd = cfg.resolved_head_dim
    partial = _partitioned(params) if partial is None else partial
    w = sharding.weight
    if partial or seq:
        ctx = sharding.enter(ctx, seq, partial)
    if partial:
        w = sharding.part_weight
    b, f, _ = ctx.shape
    k = (ctx @ w(params["wk"])).reshape(b, f, -1, hd)
    v = (ctx @ w(params["wv"])).reshape(b, f, -1, hd)
    return _local_kv(params, k, v, cfg)


def _cross_q(params: Params, x: torch.Tensor, cfg: ModelConfig,
             seq: bool = False) -> torch.Tensor:
    w = sharding.weight
    if _partitioned(params) or seq:
        x = sharding.enter(x, seq)
        w = sharding.part_weight if seq else w
    b, s, _ = x.shape
    return (x @ w(params["wq"])).reshape(b, s, -1, cfg.resolved_head_dim)


def cross_attend(params: Params, x: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, cfg: ModelConfig, seq: bool = False
                 ) -> torch.Tensor:
    """Cross-attention of ``x`` (B, S, d_model) to projected K / V (from
    :func:`cross_kv`): no mask, no RoPE; on the CPU the JAX package's
    full path at every length. ``wo``'s partial is summed over
    ``model`` (:func:`_out_proj`). ``seq``: ``x`` is this rank's span of
    the decoder's positions, and so is the output."""
    o = _attend(_cross_q(params, x, cfg, seq), k, v, causal=False,
                use_blockwise=False)
    return _out_proj(params, o, seq=True) if seq else _out_proj(params, o)


def cross_attention(params: Params, x: torch.Tensor, ctx: torch.Tensor,
                    cfg: ModelConfig, seq: bool = False,
                    seq_ctx: bool = False) -> torch.Tensor:
    """Decoder -> encoder cross-attention (no mask, no RoPE); ``seq`` /
    ``seq_ctx``: ``x`` / ``ctx`` are this rank's spans of their
    sequences (``sharding.seq_split``, each its own length)."""
    k, v = cross_kv(params, ctx, cfg, seq_ctx,
                    partial=_partitioned(params) or seq)
    if seq:
        return cross_attend(params, x, k, v, cfg, seq=True)
    return cross_attend(params, x, k, v, cfg)


def decode_cross_attention(params: Params, x: torch.Tensor,
                           cfg: ModelConfig, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, frames: int
                           ) -> torch.Tensor:
    """One decode token ``x`` (B, 1, d) attending to the cached cross K
    / V of ``frames`` encoder positions, of which the caches hold this
    rank's span (``sharding.cache_span``), every one valid."""
    start, n = sharding.cache_span(frames)
    o = _decode_attention(_cross_q(params, x, cfg), k_cache, v_cache,
                          frames, start if n < frames else None)
    return _out_proj(params, o)


def local_kv_heads(cfg: ModelConfig, params: Optional[Params] = None
                   ) -> int:
    """The KV heads a rank caches: ``params`` (one layer's attention
    leaves) as :func:`_project_qkv` and :func:`_local_kv` leave them;
    every head without ``params`` or a split."""
    if params is None or not sharding.model_split(params["wq"], 1):
        return cfg.n_kv_heads
    if sharding.model_split(params["wk"], 1):
        return cfg.n_kv_heads // get_mesh_context().model_size
    _, nh = sharding.model_block(params["wq"], 1, cfg.n_heads)
    g = cfg.n_heads // cfg.n_kv_heads
    return max(nh // g, 1) if (nh % g == 0 or g % nh == 0) else nh


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  n_layers: Optional[int] = None,
                  device: Optional[torch.device] = None,
                  n_kv_heads: Optional[int] = None
                  ) -> Dict[str, object]:
    """Zero K / V caches ``(L, batch, max_len, n_kv_heads, hd)``
    (``n_kv_heads``: the config's, or a rank's :func:`local_kv_heads`)."""
    dt = dtype_of(cfg)
    L = n_layers if n_layers is not None else cfg.n_layers
    shape = (L, batch, max_len, n_kv_heads or cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "length": 0,
    }


def write_prompt(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor, positions: int) -> None:
    """A prompt's K / V ``(B, n_pos, K, hd)``, global positions ``[0,
    n_pos)``, into one layer's caches of ``positions`` global positions,
    of which they hold this rank's span (``sharding.cache_span``): the
    positions that fall in it."""
    start, n = sharding.cache_span(positions)
    hi = min(start + n, k.shape[1])
    if hi > start:
        k_cache[:, :hi - start] = k[:, start:hi]
        v_cache[:, :hi - start] = v[:, start:hi]


def _write_row(cache: torch.Tensor, new: torch.Tensor, pos: int,
               start: int) -> None:
    """The new token's row ``new`` (B, K, hd) into ``cache`` (B, S, K,
    hd), which holds global positions ``[start, start + S)``: at ``pos
    - start`` when this block owns ``pos``, else nowhere."""
    i = pos - start
    if 0 <= i < cache.shape[1]:
        cache[:, i] = new.to(cache.dtype)


def decode_self_attention(params: Params, x: torch.Tensor, cfg: ModelConfig,
                          k_cache: torch.Tensor, v_cache: torch.Tensor,
                          cache_len: int, positions: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """One-token decode. x: (B, 1, d). Returns (out, k_cache, v_cache).

    Unlike the JAX package, which returns updated copies, the new K/V
    row is written into ``k_cache`` / ``v_cache`` in place (at position
    ``cache_len``): a copy of the whole cache per step would move more
    bytes than the step itself reads. ``positions``, the global cache
    length, given, the caches are this rank's span of it
    (``sharding.cache_span``)."""
    b = x.shape[0]
    pos = torch.full((b, 1), cache_len, dtype=torch.long, device=x.device)
    q, k_new, v_new = _project_qkv(params, x, x, cfg, pos, pos,
                                   use_rope=True)
    total = k_cache.shape[1] if positions is None else positions
    start, n = sharding.cache_span(total) if positions is not None \
        else (0, total)
    _write_row(k_cache, k_new[:, 0], cache_len, start)
    _write_row(v_cache, v_new[:, 0], cache_len, start)
    o = _decode_attention(q, k_cache, v_cache, cache_len + 1,
                          start if n < total else None)
    return _out_proj(params, o), k_cache, v_cache


def prefill_self_attention(params: Params, x: torch.Tensor, cfg: ModelConfig
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Prefill: causal attention returning output and the K/V to cache."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project_qkv(params, x, x, cfg, positions, positions, True)
    o = _attend(q, k, v, True, s > BLOCKWISE_THRESHOLD)
    return _out_proj(params, o), k, v
