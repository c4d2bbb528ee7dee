"""ReCXL core of the port: the protocol simulator and its engine tiers.

* :mod:`repro_torch.core.simulator`  -- host trace synthesis, the
  columnar trace bank, and the banked scan on a torch device.
* :mod:`repro_torch.core.engine`     -- the one-device streaming tier.
* :mod:`repro_torch.core.scenarios`  -- the paper's sweep grids.
* :mod:`repro_torch.core.contention` / :mod:`~repro_torch.core.directory`
  -- the contention and queueing-coupled directory axes.

Importing this package imports none of its modules.
"""
