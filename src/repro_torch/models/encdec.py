"""Whisper-style encoder-decoder backbone (audio frontend stubbed).

The JAX package's ``models/encdec.py`` on torch tensors. The batch
feeds precomputed frame embeddings ``frames`` (B, n_frames, d_model)
straight into the encoder; the strided-conv mel frontend of the real
model is a stub. The encoder is non-causal self-attention with RoPE
(positions ``0 .. F-1``) and an MLP per layer, then ``enc_norm``; the
decoder is a causal transformer with cross-attention into the encoder
output (no mask, no RoPE). Each layer ``lax.scan`` becomes a Python loop
over per-layer parameter dicts (``params["enc_layers"][i]``,
``params["layers"][i]``), as in the port's ``transformer.py``; the
``constrain_*`` sharding hints are identities on one card and are not
ported.

On a CUDA tensor every attention of ``encode``, ``forward`` and
``prefill`` -- the encoder's, the decoder's causal one and the
cross-attention -- goes through the hand-written ``flash_attn`` kernel
(``models/attention.py``); decode attends to its caches in plain torch,
as the JAX package does.

Caches hold the JAX package's keys: ``k``, ``v`` ``(L, B, max_len, K,
hd)``, ``cross_k``, ``cross_v`` ``(L, B, F, K, hd)`` (the encoder
output's projections, made once by ``prefill``) and ``length``, a
Python int. ``decode_step`` writes the new token's K/V into the cache it
is given, in place, and returns it with ``length`` advanced. There is
no cache before ``prefill``: the cross K/V need the encoder output.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    Params,
    cross_entropy_loss,
    dtype_of,
    embed_tokens,
    embedding_init,
    mlp_apply,
    mlp_init,
    REMAT_MODES,
    remat_apply,
    rmsnorm,
    rmsnorm_init,
    unembed,
)

Cache = Dict[str, Any]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_enc_layer(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dt, dev = dtype_of(cfg), gen.device
    return {
        "ln1": rmsnorm_init(cfg.d_model, dt, dev),
        "ln2": rmsnorm_init(cfg.d_model, dt, dev),
        "attn": attn.attention_init(gen, cfg),
        "mlp": mlp_init(gen, cfg),
    }


def _init_dec_layer(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dt, dev = dtype_of(cfg), gen.device
    return {
        "ln1": rmsnorm_init(cfg.d_model, dt, dev),
        "ln_cross": rmsnorm_init(cfg.d_model, dt, dev),
        "ln2": rmsnorm_init(cfg.d_model, dt, dev),
        "attn": attn.attention_init(gen, cfg),
        "cross": attn.attention_init(gen, cfg, cross=True),
        "mlp": mlp_init(gen, cfg),
    }


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random weights from ``gen``, made on the generator's device."""
    dt, dev = dtype_of(cfg), gen.device
    return {
        "embed": embedding_init(gen, cfg),
        "enc_layers": [_init_enc_layer(gen, cfg)
                       for _ in range(cfg.encoder_layers)],
        "layers": [_init_dec_layer(gen, cfg) for _ in range(cfg.n_layers)],
        "enc_norm": rmsnorm_init(cfg.d_model, dt, dev),
        "final_norm": rmsnorm_init(cfg.d_model, dt, dev),
    }


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _remat(remat: str) -> str:
    """The JAX package's enc-dec rematerializes its layers only under
    ``remat="full"``; "selective" runs as "none" there, and here."""
    if remat not in REMAT_MODES:
        raise ValueError(f"unknown remat {remat!r}")
    return "full" if remat == "full" else "none"


def _enc_layer(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    x = x + attn.self_attention(p["attn"], h, cfg, causal=False)
    return x + mlp_apply(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)


def _dec_layer(p: Params, x: torch.Tensor, enc_out: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    x = x + attn.self_attention(p["attn"], h, cfg, causal=True)
    hc = rmsnorm(p["ln_cross"], x, cfg.norm_eps)
    x = x + attn.cross_attention(p["cross"], hc, enc_out, cfg)
    return x + mlp_apply(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)


def encode(params: Params, frames: torch.Tensor, cfg: ModelConfig,
           remat: str = "full") -> torch.Tensor:
    """frames: (B, F, d_model) stub embeddings -> encoder output."""
    x = frames.to(dtype_of(cfg))
    for p in params["enc_layers"]:
        x = remat_apply(_enc_layer, _remat(remat), p, x, cfg)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Decoder: train forward
# ---------------------------------------------------------------------------

def forward(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            remat: str = "full") -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: {frames (B,F,d), tokens (B,S), labels (B,S)} -> (logits,
    aux), aux 0."""
    enc_out = encode(params, batch["frames"], cfg, remat)
    x = embed_tokens(params["embed"], batch["tokens"])
    for p in params["layers"]:
        x = remat_apply(_dec_layer, _remat(remat), p, x, enc_out, cfg)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return (unembed(params["embed"], x, cfg),
            torch.zeros((), dtype=torch.float32, device=x.device))


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            remat: str = "full"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits, aux = forward(params, batch, cfg, remat)
    loss = cross_entropy_loss(logits, batch["labels"], batch.get("mask"))
    return loss, {"ce_loss": loss, "aux_loss": aux}


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------

def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            max_len: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
    """Encode the frames and run the prompt through the decoder, filling
    the caches; returns (logits (B, S, V), cache)."""
    tokens = batch["tokens"]
    bsz, seq = tokens.shape
    max_len = max_len or seq
    enc_out = encode(params, batch["frames"], cfg)
    x = embed_tokens(params["embed"], tokens)
    dt, dev = x.dtype, x.device
    L, kh, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    frames = enc_out.shape[1]
    cache: Cache = {
        "k": torch.zeros((L, bsz, max_len, kh, hd), dtype=dt, device=dev),
        "v": torch.zeros((L, bsz, max_len, kh, hd), dtype=dt, device=dev),
        "cross_k": torch.empty((L, bsz, frames, kh, hd), dtype=dt,
                               device=dev),
        "cross_v": torch.empty((L, bsz, frames, kh, hd), dtype=dt,
                               device=dev),
    }
    for i, p in enumerate(params["layers"]):
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        a, k, v = attn.prefill_self_attention(p["attn"], h, cfg)
        cache["k"][i, :, :seq] = k
        cache["v"][i, :, :seq] = v
        x = x + a
        hc = rmsnorm(p["ln_cross"], x, cfg.norm_eps)
        # the cross K/V, made once from enc_out: cached, and attended to
        # here (the JAX package projects them a second time inside its
        # cross_attention; the product is the same)
        ck, cv = attn.cross_kv(p["cross"], enc_out, cfg)
        cache["cross_k"][i], cache["cross_v"][i] = ck, cv
        x = x + attn.cross_attend(p["cross"], hc, ck, cv, cfg)
        x = x + mlp_apply(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    cache["length"] = seq
    return unembed(params["embed"], x, cfg), cache


def decode_step(params: Params, cache: Cache, tokens: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Cache]:
    """tokens: (B,). Returns (logits (B, V), the cache advanced by one
    token -- updated in place)."""
    x = embed_tokens(params["embed"], tokens[:, None])
    length = cache["length"]
    bsz, hd = x.shape[0], cfg.resolved_head_dim
    for i, p in enumerate(params["layers"]):
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        a, _, _ = attn.decode_self_attention(
            p["attn"], h, cfg, cache["k"][i], cache["v"][i], length)
        x = x + a
        hc = rmsnorm(p["ln_cross"], x, cfg.norm_eps)
        q = (hc @ p["cross"]["wq"]).reshape(bsz, 1, cfg.n_heads, hd)
        ck = cache["cross_k"][i]
        o = attn._decode_attention(q, ck, cache["cross_v"][i], ck.shape[1])
        x = x + o.reshape(bsz, 1, -1) @ p["cross"]["wo"]
        x = x + mlp_apply(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    cache["length"] = length + 1
    return unembed(params["embed"], x[:, 0, :], cfg), cache
