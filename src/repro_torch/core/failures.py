"""Failure detection + injection (paper SS V.A adapted).

The paper's switch keeps one Viral_Status bit per CN, never answers on a
failed CN's behalf, and MSIs a live core to start recovery. The trainer's
control plane mirrors that:

* :class:`FailureDetector` -- lease-based heartbeats; a node whose lease
  expires gets its viral bit set and is never "answered for" (its device
  state is treated as gone, not as zeros);
* :class:`FailureInjector` -- deterministic fault schedule for tests,
  examples and benchmarks (fail node f at step s; also straggler
  injection: delay node f by d seconds for straggler-mitigation tests).

On this single-process container, "nodes" are data-axis ranks of the
simulated mesh; injection marks ranks failed and recovery must not read
their shards.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple


@dataclasses.dataclass(frozen=True)
class FailureEvent:
    step: int
    node: int
    kind: str = "fail-stop"          # fail-stop | straggler
    delay_s: float = 0.0             # straggler delay


class FailureInjector:
    """Deterministic failure schedule."""

    def __init__(self, events: Sequence[FailureEvent] = ()):  # noqa: D401
        self.events = sorted(events, key=lambda e: e.step)
        self.fired: List[FailureEvent] = []

    def poll(self, step: int) -> List[FailureEvent]:
        out = []
        while self.events and self.events[0].step <= step:
            ev = self.events.pop(0)
            self.fired.append(ev)
            out.append(ev)
        return out


class FailureDetector:
    """Lease-based detector with per-node Viral_Status bits.

    ``heartbeat(node)`` renews a lease; ``check(now)`` expires leases and
    returns newly-failed nodes. The trainer heartbeats every live rank
    each step; injected failures simply stop heartbeating (fail-stop).
    """

    def __init__(self, n_nodes: int, lease_s: float = 5.0):
        self.n_nodes = n_nodes
        self.lease_s = lease_s
        now = time.monotonic()
        self.last_seen: Dict[int, float] = {n: now for n in range(n_nodes)}
        self.viral_status: List[bool] = [False] * n_nodes
        self.stragglers: Dict[int, float] = {}

    # ------------------------------------------------------------------
    def heartbeat(self, node: int, now: Optional[float] = None) -> None:
        if self.viral_status[node]:
            return                    # failed nodes never come back (fail-stop)
        self.last_seen[node] = time.monotonic() if now is None else now

    def mark_failed(self, node: int) -> None:
        """Immediate viral-bit set (switch-detected failure)."""
        self.viral_status[node] = True

    def mark_straggler(self, node: int, delay_s: float) -> None:
        self.stragglers[node] = delay_s

    def check(self, now: Optional[float] = None) -> List[int]:
        """Expire leases; returns newly failed nodes."""
        now = time.monotonic() if now is None else now
        newly = []
        for n in range(self.n_nodes):
            if self.viral_status[n]:
                continue
            if now - self.last_seen[n] > self.lease_s:
                self.viral_status[n] = True
                newly.append(n)
        return newly

    # ------------------------------------------------------------------
    @property
    def live_nodes(self) -> List[int]:
        return [n for n in range(self.n_nodes) if not self.viral_status[n]]

    @property
    def failed_nodes(self) -> List[int]:
        return [n for n in range(self.n_nodes) if self.viral_status[n]]

    def configuration_manager(self) -> int:
        """The live core the MSI lands on: lowest live rank (SS V.A)."""
        live = self.live_nodes
        if not live:
            raise RuntimeError("no live nodes: cluster lost")
        return live[0]
