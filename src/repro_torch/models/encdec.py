"""Whisper-style encoder-decoder backbone (audio frontend stubbed).

The JAX package's ``models/encdec.py`` on torch tensors. The batch
feeds precomputed frame embeddings ``frames`` (B, n_frames, d_model)
straight into the encoder; the strided-conv mel frontend of the real
model is a stub. The encoder is non-causal self-attention with RoPE
(positions ``0 .. F-1``) and an MLP per layer, then ``enc_norm``; the
decoder is a causal transformer with cross-attention into the encoder
output (no mask, no RoPE). Each layer ``lax.scan`` becomes a Python loop
over per-layer parameter dicts (``params["enc_layers"][i]``,
``params["layers"][i]``), as in the port's ``transformer.py``.

Across ranks that split the ``model`` axis every leaf is read through
``sharding.weight`` and every attention and MLP is the tensor-parallel
one of ``attention.py`` / ``layers.py``: the encoder's self-attention,
the decoder's causal one and the cross-attention compute the rank's
heads and sum ``wo``'s partial over ``model``. The reference's
``constrain_batch`` hints are where the serve fns of
``training/steps.py`` cut the rank's rows of ``frames`` and ``tokens``
(``sharding.constrain_batch``), and its ``constrain_logits`` is the
gather of ``sharding.constrain_logits`` there; on one card both are
identities. Under the ``seq_model`` policy the train forward keeps the
encoder's and the decoder's streams each as this rank's span of its
own length where ``sharding.seq_split`` says so; the cross-attention
gathers the encoder's span for its K / V.

On a CUDA tensor every attention of ``encode``, ``forward`` and
``prefill`` -- the encoder's, the decoder's causal one and the
cross-attention -- goes through the hand-written ``flash_attn`` kernel
(``models/attention.py``); decode attends to its caches in plain torch,
as the JAX package does.

Caches hold the JAX package's keys: ``k``, ``v`` ``(L, B, max_len, K,
hd)``, ``cross_k``, ``cross_v`` ``(L, B, F, K, hd)`` (the encoder
output's projections, made once by ``prefill``) and ``length``, a
Python int; and ``positions`` / ``frames``, the global ``max_len`` and
``F``. A rank holds its KV heads and, where the node blocks do not
divide the batch, its span of the positions and of the frames
(``sharding.cache_span``). ``decode_step`` writes the new token's K/V
into the cache it is given, in place, and returns it with ``length``
advanced. There is
no cache before ``prefill``: the cross K/V need the encoder output.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.distributed import sharding
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


def init_params(gen: torch.Generator, cfg: ModelConfig,
                place: Optional[Callable[[Params, str], Params]] = None
                ) -> Params:
    """Random weights from ``gen``, made on the generator's device.
    ``place(subtree, path)``, given, takes each part as it is drawn (the
    embedding, each encoder and decoder layer, the norms), as in
    ``transformer.init_params``."""
    dt, dev = dtype_of(cfg), gen.device
    place = place or (lambda tree, path: tree)
    return {
        "embed": place(embedding_init(gen, cfg), "embed"),
        "enc_layers": [place(_init_enc_layer(gen, cfg), "enc_layers")
                       for _ in range(cfg.encoder_layers)],
        "layers": [place(_init_dec_layer(gen, cfg), "layers")
                   for _ in range(cfg.n_layers)],
        "enc_norm": place(rmsnorm_init(cfg.d_model, dt, dev), "enc_norm"),
        "final_norm": place(rmsnorm_init(cfg.d_model, dt, dev),
                            "final_norm"),
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


def _enc_layer(p: Params, x: torch.Tensor, cfg: ModelConfig,
               seq: bool = False) -> torch.Tensor:
    h = rmsnorm(p["ln1"], x, cfg.norm_eps, seq)
    x = x + attn.self_attention(p["attn"], h, cfg, causal=False, seq=seq)
    return x + mlp_apply(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps, seq),
                         cfg, seq=seq)


def _dec_layer(p: Params, x: torch.Tensor, enc_out: torch.Tensor,
               cfg: ModelConfig, seq: bool = False,
               seq_enc: bool = False) -> torch.Tensor:
    h = rmsnorm(p["ln1"], x, cfg.norm_eps, seq)
    x = x + attn.self_attention(p["attn"], h, cfg, causal=True, seq=seq)
    hc = rmsnorm(p["ln_cross"], x, cfg.norm_eps, seq)
    x = x + attn.cross_attention(p["cross"], hc, enc_out, cfg, seq, seq_enc)
    return x + mlp_apply(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps, seq),
                         cfg, seq=seq)


def encode(params: Params, frames: torch.Tensor, cfg: ModelConfig,
           remat: str = "full", seq: bool = False) -> torch.Tensor:
    """frames: (B, F, d_model) stub embeddings -> encoder output;
    ``seq``: the encoder's stream, and its output, this rank's span of
    the F frames (``sharding.seq_split``)."""
    x = sharding.to_span(frames.to(dtype_of(cfg)), seq)
    for p in params["enc_layers"]:
        x = remat_apply(_enc_layer, _remat(remat), p, x, cfg, seq)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps, seq)


# ---------------------------------------------------------------------------
# Decoder: train forward
# ---------------------------------------------------------------------------

def forward(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            remat: str = "full") -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: {frames (B,F,d), tokens (B,S), labels (B,S)} -> (logits,
    aux), aux 0. Under the ``seq_model`` policy the encoder's and the
    decoder's streams each live as this rank's span where
    ``sharding.seq_split`` says so for their own length."""
    seq_enc = sharding.seq_split(batch["frames"].shape[1])
    seq = sharding.seq_split(batch["tokens"].shape[1])
    enc_out = encode(params, batch["frames"], cfg, remat, seq_enc)
    x = (embed_tokens(params["embed"], batch["tokens"], seq=True) if seq
         else embed_tokens(params["embed"], batch["tokens"]))
    for p in params["layers"]:
        x = remat_apply(_dec_layer, _remat(remat), p, x, enc_out, cfg, seq,
                        seq_enc)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps, seq)
    return (unembed(params["embed"], x, cfg, seq),
            torch.zeros((), dtype=torch.float32, device=x.device))


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            remat: str = "full"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits, aux = forward(params, batch, cfg, remat)
    # the vocab-split logits of a rank gathered over ``model``
    logits = sharding.constrain_logits(logits, params["embed"])
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
    L, hd = cfg.n_layers, cfg.resolved_head_dim
    frames = enc_out.shape[1]
    p0 = params["layers"][0]
    ns = sharding.cache_span(max_len)[1]
    f0, nf = sharding.cache_span(frames)
    kh = attn.local_kv_heads(cfg, p0["attn"])
    ch = attn.local_kv_heads(cfg, p0["cross"])
    cache: Cache = {
        "k": torch.zeros((L, bsz, ns, kh, hd), dtype=dt, device=dev),
        "v": torch.zeros((L, bsz, ns, kh, hd), dtype=dt, device=dev),
        "cross_k": torch.empty((L, bsz, nf, ch, hd), dtype=dt, device=dev),
        "cross_v": torch.empty((L, bsz, nf, ch, hd), dtype=dt, device=dev),
        "positions": max_len,
        "frames": frames,
    }
    for i, p in enumerate(params["layers"]):
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        a, k, v = attn.prefill_self_attention(p["attn"], h, cfg)
        attn.write_prompt(cache["k"][i], cache["v"][i], k, v, max_len)
        x = x + a
        hc = rmsnorm(p["ln_cross"], x, cfg.norm_eps)
        # the cross K/V, made once from enc_out: the rank's span of the
        # frames cached, and every frame attended to here (the JAX
        # package projects them a second time inside its
        # cross_attention; the product is the same)
        ck, cv = attn.cross_kv(p["cross"], enc_out, cfg)
        cache["cross_k"][i] = ck[:, f0:f0 + nf]
        cache["cross_v"][i] = cv[:, f0:f0 + nf]
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
    for i, p in enumerate(params["layers"]):
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        a, _, _ = attn.decode_self_attention(
            p["attn"], h, cfg, cache["k"][i], cache["v"][i], length,
            cache["positions"])
        x = x + a
        hc = rmsnorm(p["ln_cross"], x, cfg.norm_eps)
        x = x + attn.decode_cross_attention(
            p["cross"], hc, cfg, cache["cross_k"][i], cache["cross_v"][i],
            cache["frames"])
        x = x + mlp_apply(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    cache["length"] = length + 1
    return unembed(params["embed"], x[:, 0, :], cfg), cache
