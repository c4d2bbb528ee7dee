"""Public model facade: one uniform interface over the ported families.

``build_model(cfg)`` returns a :class:`Model` with ``init`` /
``forward`` / ``loss_fn`` / ``prefill`` / ``decode_step`` /
``init_cache``, as the JAX package's ``models/model_zoo.py`` does.
``init`` and ``init_cache`` take a ``device``: ``None`` means the card,
and raises without one. ``batch_struct`` / ``make_batch`` give a shape
cell's inputs, and :func:`params_from_jax` turns the JAX package's
parameter tree into the port's parameters, so both packages can compute
from the same weights.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.layers import dtype_of


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., Any]
    forward: Callable[..., Tuple[torch.Tensor, torch.Tensor]]
    loss_fn: Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    prefill: Callable[..., Tuple[torch.Tensor, Dict[str, Any]]]
    decode_step: Callable[..., Tuple[torch.Tensor, Dict[str, Any]]]
    init_cache: Callable[..., Dict[str, Any]]


def build_model(cfg: ModelConfig) -> Model:
    """The model of ``cfg``. Raises ``NotImplementedError`` for the
    families the port does not run yet (enc-dec, vlm)."""
    transformer.check_family(cfg)

    def init(seed: int = 0, device=None) -> Dict[str, Any]:
        """Random weights from ``torch.Generator(device).manual_seed(seed)``,
        made on ``device`` (``None``: the card)."""
        dev = resolve_device(device)
        return transformer.init_params(
            torch.Generator(device=dev).manual_seed(seed), cfg)

    def init_cache(batch: int, max_len: int, device=None) -> Dict[str, Any]:
        return transformer.init_cache(cfg, batch, max_len,
                                      device=resolve_device(device))

    return Model(
        cfg=cfg,
        init=init,
        forward=lambda p, b: transformer.forward(p, b, cfg),
        loss_fn=lambda p, b: transformer.loss_fn(p, b, cfg),
        prefill=lambda p, b, **kw: transformer.prefill(p, b, cfg, **kw),
        decode_step=lambda p, c, t: transformer.decode_step(p, c, t, cfg),
        init_cache=init_cache,
    )


# ---------------------------------------------------------------------------
# Input specs / synthetic batches
# ---------------------------------------------------------------------------

class TensorSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def batch_struct(cfg: ModelConfig, shape: ShapeConfig
                 ) -> Dict[str, TensorSpec]:
    """Shapes and dtypes of the *batch* inputs of a shape cell: the
    full-sequence inputs for ``train`` / ``prefill``, the one-token
    inputs for ``decode`` (the cache is serve state, not batch)."""
    transformer.check_family(cfg)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": TensorSpec((b,), torch.int32)}
    specs = {"tokens": TensorSpec((b, s), torch.int32)}
    if shape.kind == "train":
        specs["labels"] = TensorSpec((b, s), torch.int32)
    return specs


def make_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
               device=None) -> Dict[str, torch.Tensor]:
    """A synthetic batch matching :func:`batch_struct`: tokens (and
    labels) uniform in ``[0, vocab)`` from ``torch.Generator().manual_seed
    (seed)`` on the CPU, so the same seed gives the same tokens on every
    device, then moved to ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return {name: torch.randint(0, cfg.vocab_size, spec.shape,
                                generator=gen, dtype=spec.dtype).to(dev)
            for name, spec in batch_struct(cfg, shape).items()}


# ---------------------------------------------------------------------------
# Weights from the JAX package
# ---------------------------------------------------------------------------

def _leaf(a, device: torch.device) -> torch.Tensor:
    """A numpy leaf as a tensor of the same type. A bf16 leaf
    (``ml_dtypes.bfloat16``) goes through f32, which holds it exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)   # a writable copy


def _tree(node, device: torch.device):
    if isinstance(node, dict):
        return {k: _tree(v, device) for k, v in node.items()}
    return _leaf(node, device)


def params_from_jax(cfg: ModelConfig, tree: Dict[str, Any], device=None
                    ) -> Dict[str, Any]:
    """The port's parameters from the JAX package's parameter tree of
    ``cfg`` (nested dicts of numpy arrays, the layer axis leading in
    ``tree["layers"]``), on ``device`` (``None``: the card). Every value
    keeps its type, so both packages compute from the same weights."""
    transformer.check_family(cfg)
    dev = resolve_device(device)

    def layer(node, i):
        if isinstance(node, dict):
            return {k: layer(v, i) for k, v in node.items()}
        return np.asarray(node)[i]

    layers = tree["layers"]
    out = {
        "embed": _tree(tree["embed"], dev),
        "layers": [_tree(layer(layers, i), dev) for i in range(cfg.n_layers)],
        "final_norm": _tree(tree["final_norm"], dev),
    }
    if out["embed"]["tok"].dtype != dtype_of(cfg):
        raise ValueError(f"the tree's embedding is {out['embed']['tok'].dtype}"
                         f", the config says {cfg.dtype}")
    return out
