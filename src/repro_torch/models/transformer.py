"""Decoder-only model assembly for the dense / moe / ssm / hybrid / vlm
families.

The JAX package's ``models/transformer.py`` on torch tensors. Its layer
``lax.scan`` over stacked parameters becomes a Python loop over a list
of per-layer parameter dicts (``params["layers"][i]`` holds the JAX
package's keys). A vlm batch's ``patch_embeds`` replace the leading
positions' token embeddings.

Across ranks that split the ``model`` axis the functions take this
rank's rows of the batch (``sharding.constrain_batch``; the serve fns of
``training/steps.py`` cut them) and its parameter blocks, give the
logits of its vocabulary block (``sharding.constrain_logits`` gathers
them), and keep a cache of its heads (``init_cache(..., layer=)``); the
layers below sum and gather where the JAX package's ``constrain_*``
hints make GSPMD do so. Where the node blocks do not divide the batch
every rank serves the whole batch, and its ``k`` / ``v`` hold its
block's span of the positions (``sharding.cache_span``). Under the
``seq_model`` policy the train forward keeps the residual stream as
this rank's span of the positions where ``sharding.seq_split`` says so
(each layer's ``seq``). Enc-dec configs run in ``models/encdec.py``;
``model_zoo.build_model`` picks the module.

Caches are dicts of tensors with the JAX package's keys (``k``, ``v``
``(L, B, max_len, K, hd)``, or the rank's span of ``max_len``; ``conv``,
``ssd``) plus ``length``, a Python int, and ``positions``, the global
``max_len``. ``prefill`` fills a fresh cache; ``decode_step`` writes the
new token's K/V and SSM state into the cache it is given, in place, and
returns it with ``length`` advanced: a copy of every layer's cache per
token would move more bytes than the step itself.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    Params,
    cross_entropy_loss,
    dtype_of,
    embed_tokens,
    embedding_init,
    mlp_apply,
    mlp_init,
    remat_apply,
    rmsnorm,
    rmsnorm_init,
    unembed,
)

Cache = Dict[str, Any]

MOE_AUX_COEF = 0.01
#: the families the port's models run; an enc-dec config (``encoder_layers
#: > 0``, the audio family's) runs in ``models/encdec.py``
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def check_family(cfg: ModelConfig) -> None:
    """Raise for a family the port's models do not know."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family has no model in the port, "
            f"which runs {FAMILIES}")


# ---------------------------------------------------------------------------
# Layer init / apply (family dispatch)
# ---------------------------------------------------------------------------

def init_layer(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dt, dev = dtype_of(cfg), gen.device
    p: Params = {}
    if cfg.family == "ssm":
        p["norm"] = rmsnorm_init(cfg.d_model, dt, dev)
        p["ssm"] = ssm_mod.ssm_init(gen, cfg)
        return p
    p["ln1"] = rmsnorm_init(cfg.d_model, dt, dev)
    p["ln2"] = rmsnorm_init(cfg.d_model, dt, dev)
    p["attn"] = attn.attention_init(gen, cfg)
    if cfg.family == "hybrid":
        p["ssm"] = ssm_mod.ssm_init(gen, cfg)
        p["norm_attn"] = rmsnorm_init(cfg.d_model, dt, dev)
        p["norm_ssm"] = rmsnorm_init(cfg.d_model, dt, dev)
    if cfg.is_moe:
        p["moe"] = moe_mod.moe_init(gen, cfg)
    else:
        p["mlp"] = mlp_init(gen, cfg)
    return p


def _ffn(p: Params, x: torch.Tensor, cfg: ModelConfig, seq: bool = False
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer's FFN: (out, aux_loss), the aux loss 0 for a dense one."""
    if cfg.is_moe:
        return moe_mod.moe_apply(p["moe"], x, cfg, seq)
    return (mlp_apply(p["mlp"], x, cfg, seq=seq),
            torch.zeros((), device=x.device))


def _mix(p: Params, a: torch.Tensor, s: torch.Tensor, cfg: ModelConfig,
         seq: bool = False) -> torch.Tensor:
    """Hybrid fusion: the mean of the per-branch-normalized outputs."""
    return 0.5 * (rmsnorm(p["norm_attn"], a, cfg.norm_eps, seq)
                  + rmsnorm(p["norm_ssm"], s, cfg.norm_eps, seq))


def layer_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
                seq: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence (train) layer. Returns (x, aux_loss). ``seq``: ``x``
    is this rank's span of the sequence (``sharding.seq_split``), and so
    is the output."""
    if cfg.family == "ssm":
        h = rmsnorm(p["norm"], x, cfg.norm_eps, seq)
        h, _ = ssm_mod.ssm_apply(p["ssm"], h, cfg, seq=seq)
        return x + h, torch.zeros((), device=x.device)
    h = rmsnorm(p["ln1"], x, cfg.norm_eps, seq)
    if cfg.family == "hybrid":
        a = attn.self_attention(p["attn"], h, cfg, seq=seq)
        s, _ = ssm_mod.ssm_apply(p["ssm"], h, cfg, seq=seq)
        x = x + _mix(p, a, s, cfg, seq)
    else:
        x = x + attn.self_attention(p["attn"], h, cfg, seq=seq)
    f, aux = _ffn(p, rmsnorm(p["ln2"], x, cfg.norm_eps, seq), cfg, seq)
    return x + f, aux


# ---------------------------------------------------------------------------
# Model init
# ---------------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg: ModelConfig,
                place: Optional[Callable[[Params, str], Params]] = None
                ) -> Params:
    """Random weights from ``gen``, made on the generator's device.
    ``place(subtree, path)``, given, takes each part as it is drawn (the
    embedding, each layer, the final norm), so a rank keeps its blocks
    and holds no more than one whole layer besides them."""
    check_family(cfg)
    place = place or (lambda tree, path: tree)
    return {
        "embed": place(embedding_init(gen, cfg), "embed"),
        "layers": [place(init_layer(gen, cfg), "layers")
                   for _ in range(cfg.n_layers)],
        "final_norm": place(rmsnorm_init(cfg.d_model, dtype_of(cfg),
                                         gen.device), "final_norm"),
    }


# ---------------------------------------------------------------------------
# Forward (train)
# ---------------------------------------------------------------------------

def _embed_inputs(params: Params, batch: Dict[str, torch.Tensor],
                  cfg: ModelConfig, seq: bool = False) -> torch.Tensor:
    """Token embeddings; for vlm, ``patch_embeds`` (B, P, d) in their
    place at the leading P positions, cast to the activation type. As in
    the JAX package, P > S gives P positions. ``seq``: this rank's span
    of the positions (never for a vlm batch)."""
    x = (embed_tokens(params["embed"], batch["tokens"], seq=True) if seq
         else embed_tokens(params["embed"], batch["tokens"]))
    if cfg.family == "vlm" and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(x.dtype)
        x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
    return x


def forward(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            remat: str = "full") -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V), aux_loss). ``remat`` ("full",
    "selective", "none") is applied to each layer, as the JAX package
    applies it to its scan body (``layers.remat_apply``). Under the
    ``seq_model`` policy the residual stream lives as this rank's span
    of the positions where ``sharding.seq_split`` says so; a vlm batch
    with patch embeddings keeps the batch layout (a layout, not a
    result, apart from the reference)."""
    seq = sharding.seq_split(batch["tokens"].shape[1]) and not (
        cfg.family == "vlm" and "patch_embeds" in batch)
    x = _embed_inputs(params, batch, cfg, seq)
    aux = torch.zeros((), device=x.device)
    for layer_params in params["layers"]:
        x, a = remat_apply(layer_apply, remat, layer_params, x, cfg, seq)
        aux = aux + a
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps, seq)
    return unembed(params["embed"], x, cfg, seq), aux


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            remat: str = "full"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits, aux = forward(params, batch, cfg, remat=remat)
    # the vocab-split logits of a rank gathered over ``model``
    logits = sharding.constrain_logits(logits, params["embed"])
    loss = cross_entropy_loss(logits, batch["labels"], batch.get("mask"))
    total = loss + MOE_AUX_COEF * aux
    return total, {"ce_loss": loss, "aux_loss": aux}


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Optional[torch.device] = None,
               layer: Optional[Params] = None) -> Cache:
    """A zero cache for ``batch`` rows; given a ``layer``'s parameters,
    with the KV heads and SSD heads that layer's leaves leave this rank
    (``attention.local_kv_heads``, ``ssm.local_heads``: fewer when the
    ranks split ``model``), and ``k`` / ``v`` over this rank's span of
    the ``max_len`` positions (``sharding.cache_span``). The SSM caches
    hold every row the rank serves."""
    check_family(cfg)
    cache: Cache = {"length": 0, "positions": max_len}
    if cfg.family != "ssm":
        kv = attn.init_kv_cache(
            cfg, batch, sharding.cache_span(max_len)[1], device=device,
            n_kv_heads=attn.local_kv_heads(
                cfg, None if layer is None else layer["attn"]))
        cache["k"], cache["v"] = kv["k"], kv["v"]
    if cfg.family in ("ssm", "hybrid"):
        s = ssm_mod.init_ssm_cache(
            cfg, batch, device=device,
            n_heads=ssm_mod.local_heads(
                cfg, None if layer is None else layer["ssm"]))
        cache["conv"], cache["ssd"] = s["conv"], s["ssd"]
    return cache


def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            max_len: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
    """Process the prompt; returns (logits (B, S, V), filled cache)."""
    tokens = batch["tokens"]
    bsz, seq = tokens.shape
    max_len = max_len or seq
    x = _embed_inputs(params, batch, cfg)
    # the JAX package pads the K/V of all x.shape[1] positions (more than
    # seq when a vlm batch has more patches than tokens) by max_len - seq
    n_pos = x.shape[1]
    cache = init_cache(cfg, bsz, max_len + n_pos - seq, device=x.device,
                       layer=params["layers"][0])
    for i, lp in enumerate(params["layers"]):
        if cfg.family == "ssm":
            h = rmsnorm(lp["norm"], x, cfg.norm_eps)
            out, (conv, ssd) = ssm_mod.ssm_apply(lp["ssm"], h, cfg,
                                                 return_cache=True)
            cache["conv"][i], cache["ssd"][i] = conv, ssd
            x = x + out
            continue
        h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
        a, k, v = attn.prefill_self_attention(lp["attn"], h, cfg)
        attn.write_prompt(cache["k"][i], cache["v"][i], k, v,
                          cache["positions"])
        if cfg.family == "hybrid":
            s, (conv, ssd) = ssm_mod.ssm_apply(lp["ssm"], h, cfg,
                                               return_cache=True)
            cache["conv"][i], cache["ssd"][i] = conv, ssd
            x = x + _mix(lp, a, s, cfg)
        else:
            x = x + a
        f, _ = _ffn(lp, rmsnorm(lp["ln2"], x, cfg.norm_eps), cfg)
        x = x + f
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    cache["length"] = seq
    return unembed(params["embed"], x, cfg), cache


# ---------------------------------------------------------------------------
# Decode (one token)
# ---------------------------------------------------------------------------

def decode_step(params: Params, cache: Cache, tokens: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Cache]:
    """tokens: (B,) int. Returns (logits (B, V), the cache advanced by
    one token -- updated in place)."""
    x = embed_tokens(params["embed"], tokens[:, None])
    length = cache["length"]
    for i, lp in enumerate(params["layers"]):
        if cfg.family == "ssm":
            h = rmsnorm(lp["norm"], x, cfg.norm_eps)
            out, conv, ssd = ssm_mod.ssm_decode_step(
                lp["ssm"], h, cfg, cache["conv"][i], cache["ssd"][i])
            cache["conv"][i], cache["ssd"][i] = conv, ssd
            x = x + out
            continue
        h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
        a, _, _ = attn.decode_self_attention(
            lp["attn"], h, cfg, cache["k"][i], cache["v"][i], length,
            cache["positions"])
        if cfg.family == "hybrid":
            s, conv, ssd = ssm_mod.ssm_decode_step(
                lp["ssm"], h, cfg, cache["conv"][i], cache["ssd"][i])
            cache["conv"][i], cache["ssd"][i] = conv, ssd
            x = x + _mix(lp, a, s, cfg)
        else:
            x = x + a
        f, _ = _ffn(lp, rmsnorm(lp["ln2"], x, cfg.norm_eps), cfg)
        x = x + f
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    cache["length"] = length + 1
    return unembed(params["embed"], x[:, 0, :], cfg), cache
