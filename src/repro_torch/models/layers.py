"""Shared layer primitives: norms, RoPE, MLPs, embeddings, initializers.

The JAX package's ``models/layers.py`` on torch tensors. Parameters are
nested dicts of tensors with the JAX package's keys, weights laid out
``(in, out)``. Initializers draw from an explicit ``torch.Generator``
(on the device the weights are made on); the numbers differ from
``jax.random`` for the same seed, so a parity test takes the JAX
package's weights through ``model_zoo.params_from_jax`` instead.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.config import ModelConfig

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# dtype helpers
# ---------------------------------------------------------------------------

def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype, scale: float = 1.0) -> torch.Tensor:
    """Truncated-normal fan-in init, on the generator's device."""
    std = scale / np.sqrt(in_dim)
    w = torch.empty((in_dim, out_dim), dtype=torch.float32,
                    device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * std).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype: torch.dtype) -> torch.Tensor:
    w = torch.empty((vocab, dim), dtype=torch.float32, device=gen.device)
    torch.nn.init.normal_(w, 0.0, 1.0, generator=gen)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm_init(dim: int, dtype: torch.dtype,
                 device: torch.device) -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def head_rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5
                 ) -> torch.Tensor:
    """qk-norm: RMS norm over the head dim of (..., n_heads, head_dim)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), computed in numpy f32
    exactly as the JAX package computes them."""
    exponent = np.arange(0, head_dim, 2, dtype=np.float32) / head_dim
    return torch.from_numpy(np.asarray(1.0 / (theta ** exponent),
                                       dtype=np.float32)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """Apply RoPE. x: (..., seq, n_heads, head_dim); positions: (..., seq)."""
    inv = rope_freqs(x.shape[-1], theta, x.device)           # (hd/2,)
    ang = positions[..., :, None].float() * inv              # (..., seq, hd/2)
    cos = torch.cos(ang)[..., :, None, :]                    # (..., seq, 1, hd/2)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None) -> Params:
    dt = dtype_of(cfg)
    d, ff = cfg.d_model, (d_ff or cfg.d_ff)
    down_scale = 1.0 / np.sqrt(2 * cfg.n_layers)
    if cfg.mlp == "swiglu":
        return {
            "w_gate": dense_init(gen, d, ff, dt),
            "w_up": dense_init(gen, d, ff, dt),
            "w_down": dense_init(gen, ff, d, dt, scale=down_scale),
        }
    return {
        "w_up": dense_init(gen, d, ff, dt),
        "w_down": dense_init(gen, ff, d, dt, scale=down_scale),
    }


def mlp_apply(params: Params, x: torch.Tensor, cfg: ModelConfig
              ) -> torch.Tensor:
    if cfg.mlp == "swiglu":
        g = F.silu(x @ params["w_gate"])
        return (g * (x @ params["w_up"])) @ params["w_down"]
    # jax.nn.gelu is the tanh approximation by default
    return F.gelu(x @ params["w_up"], approximate="tanh") @ params["w_down"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embedding_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dt = dtype_of(cfg)
    p = {"tok": embed_init(gen, cfg.vocab_size, cfg.d_model, dt)}
    if not cfg.tie_embeddings:
        p["out"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dt)
    return p


def embed_tokens(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["tok"][tokens]


def unembed(params: Params, x: torch.Tensor, cfg: ModelConfig
            ) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["tok"].T
    return x @ params["out"]


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean CE. logits (..., V) accumulated in f32; labels int (...)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# Rematerialization
# ---------------------------------------------------------------------------

#: The JAX package's ``remat`` modes of ``forward`` / ``loss_fn``.
REMAT_MODES = ("full", "selective", "none")
#: What "selective" saves: the products without batch dimensions (every
#: ``x @ w`` projection), as ``dots_with_no_batch_dims_saveable`` does.
_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_apply(fn: Callable, remat: str, *args: Any) -> Any:
    """``fn(*args)`` under the JAX package's ``remat`` mode: ``"full"``
    keeps only the inputs and recomputes the rest in the backward pass
    (``jax.checkpoint``); ``"selective"`` also keeps the matmul outputs;
    ``"none"`` keeps everything. No mode changes a value."""
    if remat == "none":
        return fn(*args)
    if remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    if remat == "selective":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _save_matmuls))
    raise ValueError(f"remat must be one of {REMAT_MODES}, got {remat!r}")
