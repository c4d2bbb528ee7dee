"""Learning-rate schedules: the JAX package's ``optim/schedules.py``,
computed in f32 as it computes them."""

from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.config import TrainConfig


def make_schedule(cfg: TrainConfig) -> Callable[[int], torch.Tensor]:
    """``schedule(step)``: linear warmup to ``learning_rate`` over
    ``warmup_steps``, then cosine / linear decay to 0 at ``total_steps``
    (or constant); a 0-d f32 tensor on the CPU."""
    base = cfg.learning_rate
    warmup = max(cfg.warmup_steps, 1)
    total = max(cfg.total_steps, warmup + 1)

    def schedule(step) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32).cpu()
        warm = base * torch.clamp(step / warmup, max=1.0)
        if cfg.schedule == "constant":
            return warm
        frac = torch.clamp((step - warmup) / (total - warmup), 0.0, 1.0)
        if cfg.schedule == "linear":
            decay = 1.0 - frac
        else:  # cosine
            decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, base * decay)

    return schedule
