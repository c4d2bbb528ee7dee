"""Public model facade: one uniform interface over the ported families.

``build_model(cfg)`` returns a :class:`Model` with ``init`` /
``forward`` / ``loss_fn`` / ``prefill`` / ``decode_step`` /
``init_cache``, as the JAX package's ``models/model_zoo.py`` does.
``init`` and ``init_cache`` take a ``device``: ``None`` means the card,
and raises without one. ``batch_struct`` / ``make_batch`` give a shape
cell's inputs. :func:`params_from_jax` turns the JAX package's
parameter tree into the port's parameters and :func:`opt_state_from_jax`
its optimizer state into the port's, so both packages can compute from
the same weights and state; :func:`params_to_numpy` goes back, to the
JAX package's stacked layout, so trees compare leaf by leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.models.layers import dtype_of


class _MetaGenerator(torch.Generator):
    """A CPU generator that places what the initializers make on the
    ``meta`` device: torch has no meta generator, and the random fills
    of a meta tensor draw nothing."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


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
    """The model of ``cfg``: ``models/encdec.py`` for an enc-dec config,
    ``models/transformer.py`` otherwise. Raises ``NotImplementedError``
    for a family the port's models do not know."""
    transformer.check_family(cfg)
    mod = encdec if cfg.is_encdec else transformer

    def init(seed: int = 0, device=None, ctx=None) -> Dict[str, Any]:
        """Random weights from ``torch.Generator(device).manual_seed(seed)``,
        made on ``device`` (``None``: ``ctx.device``, else the card). On
        ``"meta"`` only their shapes and dtypes (``launch/dryrun.py``).
        With a context whose ranks split ``model`` each rank keeps its
        :class:`~repro_torch.distributed.sharding.Shard` of every leaf:
        the same draws as the one-card init, block for block ``==``,
        placed layer by layer (encoder and decoder) as they are
        drawn."""
        dev = resolve_device(device if device is not None or ctx is None
                             else ctx.device)
        gen = (_MetaGenerator() if dev.type == "meta"
               else torch.Generator(device=dev))
        place = None
        if ctx is not None and ctx.split_model:
            from repro_torch.distributed.sharding import named_shardings

            def place(tree, path):
                return named_shardings(tree, cfg, ctx, path)
        return mod.init_params(gen.manual_seed(seed), cfg, place)

    def init_cache(batch: int, max_len: int, device=None) -> Dict[str, Any]:
        if cfg.is_encdec:
            raise NotImplementedError(
                "enc-dec caches are created by prefill (the cross K/V need "
                "the encoder output)")
        return transformer.init_cache(cfg, batch, max_len,
                                      device=resolve_device(device))

    return Model(
        cfg=cfg,
        init=init,
        forward=lambda p, b, **kw: mod.forward(p, b, cfg, **kw),
        loss_fn=lambda p, b, **kw: mod.loss_fn(p, b, cfg, **kw),
        prefill=lambda p, b, **kw: mod.prefill(p, b, cfg, **kw),
        decode_step=lambda p, c, t: mod.decode_step(p, c, t, cfg),
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
    if cfg.family == "vlm":
        specs["patch_embeds"] = TensorSpec((b, cfg.n_patches, cfg.d_model),
                                           dtype_of(cfg))
    if cfg.is_encdec:
        specs["frames"] = TensorSpec((b, cfg.n_frames, cfg.d_model),
                                     dtype_of(cfg))
    return specs


def make_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
               device=None) -> Dict[str, torch.Tensor]:
    """A synthetic batch matching :func:`batch_struct`, drawn in its
    order from one ``torch.Generator().manual_seed(seed)`` on the CPU, so
    the same seed gives the same batch on every device, then moved to
    ``device`` (``None``: the card): tokens (and labels) uniform in ``[0,
    vocab)``; the stub embeddings (``patch_embeds``, ``frames``) normal x
    0.02 in f32, then cast to the config's dtype."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, spec in batch_struct(cfg, shape).items():
        if spec.dtype == torch.int32:
            t = torch.randint(0, cfg.vocab_size, spec.shape, generator=gen,
                              dtype=spec.dtype)
        else:
            t = (torch.randn(spec.shape, generator=gen) * 0.02).to(spec.dtype)
        out[name] = t.to(dev)
    return out


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


def _from_stacked(cfg: ModelConfig, tree: Dict[str, Any],
                  device: torch.device) -> Dict[str, Any]:
    """A parameter-shaped tree of the JAX package (the layer axis leading
    under ``layers`` / ``enc_layers``) as the port's (lists of per-layer
    dicts), on ``device``."""
    def layer(node, i):
        if isinstance(node, dict):
            return {k: layer(v, i) for k, v in node.items()}
        return np.asarray(node)[i]

    n = {"layers": cfg.n_layers, "enc_layers": cfg.encoder_layers}
    return {k: ([_tree(layer(v, i), device) for i in range(n[k])]
                if k in n else _tree(v, device))
            for k, v in tree.items()}


def params_from_jax(cfg: ModelConfig, tree: Dict[str, Any], device=None
                    ) -> Dict[str, Any]:
    """The port's parameters from the JAX package's parameter tree of
    ``cfg`` (nested dicts of numpy arrays, the layer axis leading in
    ``tree["layers"]`` and, enc-dec, ``tree["enc_layers"]``), on
    ``device`` (``None``: the card). Every value keeps its type, so both
    packages compute from the same weights."""
    transformer.check_family(cfg)
    out = _from_stacked(cfg, tree, resolve_device(device))
    if out["embed"]["tok"].dtype != dtype_of(cfg):
        raise ValueError(f"the tree's embedding is {out['embed']['tok'].dtype}"
                         f", the config says {cfg.dtype}")
    return out


def opt_state_from_jax(cfg: ModelConfig, state: Dict[str, Any],
                       device=None) -> Dict[str, Any]:
    """The port's optimizer state (``optim/optimizers.py``) from the JAX
    package's state of ``cfg``'s parameters, on ``device`` (``None``: the
    card): AdamW's ``m``, ``v`` and ``master``, SGD's ``mom`` unstacked
    by layer like the parameters; Adafactor's ``vs`` (``vr`` / ``vc`` or
    ``v`` per leaf) kept in the stacked layout, which the port's
    Adafactor keeps too; ``count`` a Python int."""
    dev = resolve_device(device)
    out: Dict[str, Any] = {}
    for k, v in state.items():
        if k == "count":
            out[k] = int(np.asarray(v))
        elif k == "vs":
            out[k] = _tree(v, dev)
        else:
            out[k] = _from_stacked(cfg, v, dev)
    return out


def params_to_numpy(tree: Any) -> Any:
    """The port's tree as the JAX package lays it out: nested dicts of
    host numpy arrays, each list of per-layer dicts stacked on a leading
    axis. bf16 comes back as f32, which holds it exactly (numpy has no
    bf16)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        parts = [params_to_numpy(x) for x in tree]

        def stack(*xs):
            if isinstance(xs[0], dict):
                return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
            return np.stack(xs)

        return stack(*parts)
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
