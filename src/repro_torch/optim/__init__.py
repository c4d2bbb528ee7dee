"""Optimizers + LR schedules over the port's parameter trees."""

from repro_torch.optim.optimizers import (  # noqa: F401
    OptState,
    adafactor_init,
    adafactor_update,
    adamw_init,
    adamw_update,
    make_optimizer,
)
from repro_torch.optim.schedules import make_schedule  # noqa: F401
