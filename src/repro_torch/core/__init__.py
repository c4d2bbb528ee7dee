"""ReCXL core of the port: the protocol simulator and its engine tiers,
and the replication / recovery mechanism.

* :mod:`repro_torch.core.simulator`  -- host trace synthesis, the
  columnar trace bank, the serial oracle and the per-step, stacked and
  banked engines on a torch device.
* :mod:`repro_torch.core.engine`     -- the tier selector and the
  one-device streaming tier.
* :mod:`repro_torch.core.scenarios`  -- the paper's sweep grids, the
  SS VII-E recovery sweeps and the Fig. 9 fault scenarios.
* :mod:`repro_torch.core.replication` / :mod:`~repro_torch.core.recovery`
  -- REPL replication into per-node log rings, Algorithms 1-2 and the
  downtime model.
* :mod:`repro_torch.core.logging_unit` -- the Logging Unit state machine.
* :mod:`repro_torch.core.contention` / :mod:`~repro_torch.core.directory`
  -- the contention and queueing-coupled directory axes.

Importing this package imports none of its modules.
"""
