"""Configuration of the port: the ReCXL replication-engine knobs.

A copy of the replication part of the JAX package's ``config.py``
(``VARIANTS`` and :class:`ReplicationConfig`). The model, shape, mesh
and training configs come with the training stack (ROADMAP slice 4).
Configs are plain frozen dataclasses, so they hash, print and compare
cleanly.
"""

from __future__ import annotations

from dataclasses import dataclass

# ---------------------------------------------------------------------------
# Replication (ReCXL) configuration
# ---------------------------------------------------------------------------

VARIANTS = ("none", "writethrough", "baseline", "parallel", "proactive")


@dataclass(frozen=True)
class ReplicationConfig:
    """ReCXL fault-tolerance engine knobs (paper SS III-IV).

    ``variant``:
      * ``none``        -- WB in the paper: fast, no fault tolerance.
      * ``writethrough``-- WT: persist every update synchronously to the MN
                            tier (the paper's 7.6x strawman).
      * ``baseline``    -- replication strictly after the coherence
                            transaction (serialized dependency chain).
      * ``parallel``    -- replication overlapped with the coherence
                            transaction; commit waits on both.
      * ``proactive``   -- per-bucket replication issued as each bucket's
                            update becomes available (SB-overlap analogue).
    """

    variant: str = "proactive"
    n_replicas: int = 3              # N_r (paper default 3)
    n_buckets: int = 8               # update coalescing granularity
    coalescing: bool = True
    log_capacity: int = 8            # ring-buffer entries (steps) per node
    dump_interval: int = 50          # steps between MN dumps (2.5ms analogue)
    compression: str = "int8"        # raw | int8 | int4 (MN dump wire format)
    cross_pod_replicas: bool = False
    log_dtype: str = "bfloat16"      # in-HBM log precision (raw = exact)
    # beyond-paper: "copy" = the paper's N_r full copies; "parity" =
    # erasure-coded logs (one parity shard per group of ``parity_group``
    # nodes, stored outside the group): G x N_r less log memory,
    # tolerating one failure per group instead of N_r - 1 anywhere.
    mode: str = "copy"               # copy | parity
    parity_group: int = 4

    def __post_init__(self) -> None:
        if self.variant not in VARIANTS:
            raise ValueError(f"unknown variant {self.variant}")
        if self.compression not in ("raw", "int8", "int4"):
            raise ValueError(f"unknown compression {self.compression}")
        if self.n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        if self.mode not in ("copy", "parity"):
            raise ValueError(f"unknown mode {self.mode}")
        if self.mode == "parity" and self.parity_group < 2:
            raise ValueError("parity_group must be >= 2")

    @property
    def is_replicating(self) -> bool:
        return self.variant in ("baseline", "parallel", "proactive")
