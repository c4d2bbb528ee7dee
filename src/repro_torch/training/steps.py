"""Serving step functions: prefill and greedy decode.

The serving half of the JAX package's ``training/steps.py``. The train
and eval steps wait for the training stack (ROADMAP A7), and with
them ``RunConfig``, which the JAX package's ``make_serve_fns`` takes and
does not read.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.model_zoo import Model


class ServeState(NamedTuple):
    cache: Dict[str, Any]
    tokens: torch.Tensor               # last emitted token per sequence (B,)


def make_serve_fns(model: Model):
    """(prefill_fn, decode_fn) for the serving path.

    ``prefill_fn(params, batch, max_len)`` consumes the prompt and returns
    (first_tokens, ServeState): the greedy argmax over the last
    position's logits. ``decode_fn(params, state)`` emits one token per
    sequence against the cache, which it advances in place.
    """
    def prefill_fn(params: Any, batch: Dict[str, torch.Tensor],
                   max_len: Optional[int] = None
                   ) -> Tuple[torch.Tensor, ServeState]:
        logits, cache = model.prefill(params, batch, max_len=max_len)
        toks = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return toks, ServeState(cache=cache, tokens=toks)

    def decode_fn(params: Any, state: ServeState
                  ) -> Tuple[torch.Tensor, ServeState]:
        logits, cache = model.decode_step(params, state.cache, state.tokens)
        toks = torch.argmax(logits, dim=-1).to(torch.int32)
        return toks, ServeState(cache=cache, tokens=toks)

    return prefill_fn, decode_fn
