"""ReCXL core of the port: the protocol simulator and its engine tiers,
the scenario service, and the replication / recovery mechanism.

* :mod:`repro_torch.core.simulator`  -- host trace synthesis, the
  columnar trace bank, the serial oracle and the per-step, stacked and
  banked engines on a torch device.
* :mod:`repro_torch.core.engine`     -- the tier selector and the
  streaming tier, with logical shards on one card and in-place recovery.
* :mod:`repro_torch.core.serving`    -- :class:`ScenarioServer`, the
  long-lived scenario-query daemon over the banked engine.
* :mod:`repro_torch.core.chaos` / :mod:`~repro_torch.core.retry` --
  fault injection, row digests, shard rebuild, bounded retry.
* :mod:`repro_torch.core.scenarios`  -- the paper's sweep grids, the
  SS VII-E recovery sweeps and the Fig. 9 fault scenarios.
* :mod:`repro_torch.core.replication` / :mod:`~repro_torch.core.recovery`
  -- REPL replication into per-node log rings, Algorithms 1-2 and the
  downtime model.
* :mod:`repro_torch.core.logging_unit` -- the Logging Unit state machine.
* :mod:`repro_torch.core.contention` / :mod:`~repro_torch.core.directory`
  -- the contention and queueing-coupled directory axes.

The names below are exported lazily: importing this package imports
none of its modules, and ``from repro_torch.core import ScenarioServer``
imports only what that name needs.
"""

import importlib

_EXPORTS = {
    "ScenarioServer": "serving",
    "ChaosConfig": "chaos",
    "ChaosState": "chaos",
    "ChaosError": "chaos",
    "ShardLossError": "chaos",
    "UploadError": "chaos",
    "ThreadDeathError": "chaos",
    "IntegrityError": "chaos",
    "inject": "chaos",
    "RetryPolicy": "retry",
    "RetryExhausted": "retry",
    "retry_call": "retry",
    "EngineWorkerError": "engine",
    "run_grid": "engine",
    "simulate_grid": "engine",
    "worker_heartbeats": "engine",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
