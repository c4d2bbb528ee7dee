"""Fault injection, detection and recovery for the banked engines.

The paper's thesis is that losing a CPU node must not corrupt shared
CXL state: replicas hold a second copy of every cache line, Logging
Units journal un-committed stores, and recovery replays them onto a
spare (SS VI-VII). The engine's own platform has the same weakness once
its bank is partitioned: under ``bank_partition="sub"`` each wv row of
the trace bank has ONE primary copy, in the block of the logical shard
that owns it. This module makes the simulator resilient to the failures
it simulates, with the same three ingredients:

* **Injection** (:class:`ChaosConfig` + :func:`inject`): shard loss
  mid-grid or mid-query-stream, prefetch / compile-warm / daemon thread
  death, a corrupted device bank row, and slow or failed host->device
  uploads. Every fault fires **once** per injected scope and every hook
  is a no-op when no scope is active, so production paths pay one
  ``None`` check.
* **Detection**: per-row CRC digests (:func:`row_digest`,
  :func:`verify_rows`) checked by gather-path sampling before a tile
  launches against the resident bank, heartbeats on the engine worker
  threads (``engine.worker_heartbeats``), and bounded retry-with-backoff
  (:mod:`repro_torch.core.retry`) around placement and dispatch.
* **Recovery**: rebuild a lost shard's rows from the surviving replica
  block (:func:`replica_rebuild` -- the paper's Replica set, placed by
  ``TraceBank.sub_bank_host(k_replicas=2)``: row ``r`` is resident in
  the blocks of shards ``r % n`` AND ``(r + 1) % n``) or from the host
  journal (:func:`journal_rebuild` -- the Logging Unit: the bank keeps
  un-dumped ``extend()`` diffs until the device dump is acknowledged),
  digest-verify the rebuilt rows (:func:`verify_rebuild`), then re-place
  at the same shapes (spare replacement: tile programs stay valid, zero
  new ones) or finish on one shard fewer with a replicated bank
  (``distributed.elastic.cells_degraded_shards``).

On one card the shards are logical: the ``(n_shards, k * rows,
n_stores)`` stacks lie contiguous on the device, and a "lost" shard is
a block whose contents are no longer trusted. The recovered results are
``==`` to the fault-free run and to the JAX package's: rebuilt rows
carry the same bits and the scan is IEEE add and max only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import telemetry as _tm

# ---------------------------------------------------------------------------
# Fault taxonomy
# ---------------------------------------------------------------------------


class ChaosError(RuntimeError):
    """Base class of every injected / detected fault."""


class ShardLossError(ChaosError):
    """A (logical) shard of the bank was lost mid-run."""

    def __init__(self, shard: int, where: str = ""):
        super().__init__(f"shard {shard} lost"
                         + (f" during {where}" if where else ""))
        self.shard = shard


class UploadError(ChaosError):
    """A host->device placement failed (transient: retryable)."""


class ThreadDeathError(ChaosError):
    """An engine/daemon worker thread was killed."""

    def __init__(self, thread: str):
        super().__init__(f"worker thread {thread!r} died")
        self.thread = thread


class IntegrityError(ChaosError):
    """Device-resident rows failed their CRC digests."""

    def __init__(self, rows: Sequence[int], where: str = ""):
        super().__init__(f"integrity digest mismatch on wv rows "
                         f"{sorted(rows)}"
                         + (f" ({where})" if where else ""))
        self.rows = tuple(sorted(rows))


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """One injected failure scenario (all faults default-off; a default
    config is inert).  Faults fire at most once per :func:`inject`
    scope:

    * ``lose_shard`` -- shard index to lose on the
      ``lose_at_dispatch``-th tile/flush dispatch (1-based, counted
      across engine tiles and serve flushes alike);
    * ``corrupt_wv_row`` -- global wv row whose resident device copy is
      bit-flipped after placement (detected by gather-path digest
      sampling);
    * ``upload_failures`` -- the first N host->device placements raise
      :class:`UploadError` (absorbed by ``retry.retry_call``);
      ``upload_delay_s`` additionally sleeps every placement (slow-h2d
      injection);
    * ``kill_thread`` -- ``"prefetch"`` | ``"warm"`` | ``"daemon"``:
      the named worker thread dies at its next unit of work (engines
      respawn/inline the work; the daemon's watchdog restarts the
      serve loop);
    * ``recovery`` -- ``"spare"`` (re-place at the unchanged shard
      count -- tile programs stay valid, zero new ones) or
      ``"degraded"`` (finish on one shard fewer with
      ``bank_partition="replicated"``: one new program per SB group);
    * ``verify_rows`` -- force gather-path digest sampling on/off
      (``None``: auto -- on iff ``corrupt_wv_row`` is set).
    """
    lose_shard: Optional[int] = None
    lose_at_dispatch: int = 1
    corrupt_wv_row: Optional[int] = None
    upload_failures: int = 0
    upload_delay_s: float = 0.0
    kill_thread: Optional[str] = None
    recovery: str = "spare"
    verify_rows: Optional[bool] = None

    def __post_init__(self) -> None:
        if self.recovery not in ("spare", "degraded"):
            raise ValueError(f"unknown recovery {self.recovery!r}")
        if self.kill_thread not in (None, "prefetch", "warm", "daemon"):
            raise ValueError(f"unknown kill_thread {self.kill_thread!r}")
        if self.lose_at_dispatch < 1:
            raise ValueError("lose_at_dispatch is 1-based")
        if self.upload_failures < 0 or self.upload_delay_s < 0:
            raise ValueError("upload_failures / upload_delay_s must be >= 0")


class ChaosState:
    """Mutable runtime of one injected scenario: fire-once bookkeeping,
    the event log, and the detection/recovery metrics benches report
    (:meth:`report`).  Thread-safe -- the hooks are called from the
    caller thread, the prefetch/compile pools and the serve daemon."""

    def __init__(self, cfg: ChaosConfig):
        self.cfg = cfg
        self._lock = threading.Lock()
        self.dispatches = 0
        self.uploads = 0
        self.upload_retries = 0
        self.lost: set = set()
        self._uploads_to_fail = cfg.upload_failures
        self._loss_fired = False
        self._corrupted = False
        self._threads_killed: set = set()
        self._corrupt_at: Optional[Tuple[int, float]] = None
        self._detect_at: Optional[Tuple[int, float]] = None
        self.recoveries: List[Dict[str, object]] = []
        self.events: List[Tuple[float, str, object]] = []

    # -- event log ---------------------------------------------------------

    def _note(self, kind: str, detail: object = None) -> None:
        self.events.append((time.monotonic(), kind, detail))
        _tm.count(f"chaos/{kind}")

    # -- re-arming ---------------------------------------------------------

    def arm_after(self, n_dispatches: int) -> None:
        """Re-arm the shard-loss trigger ``n_dispatches`` dispatches from
        *now*.  An absolute ``lose_at_dispatch`` is only meaningful when
        the caller can predict the dispatch count of everything that
        runs before the phase it wants to disrupt; a launcher that warms
        an arbitrary grid first cannot, so it re-arms relative to the
        live counter once the warm phase is done (the trigger still
        fires at most once)."""
        if n_dispatches < 1:
            raise ValueError("n_dispatches is 1-based")
        with self._lock:
            self.cfg = dataclasses.replace(
                self.cfg, lose_at_dispatch=self.dispatches + n_dispatches)

    # -- injection hooks (called by engine/serving) ------------------------

    def on_dispatch(self, where: str = "") -> None:
        """One tile/flush dispatch is about to run.  Raises
        :class:`ShardLossError` once when the configured dispatch count
        is reached."""
        with self._lock:
            self.dispatches += 1
            fire = (self.cfg.lose_shard is not None
                    and not self._loss_fired
                    and self.dispatches >= self.cfg.lose_at_dispatch)
            if fire:
                self._loss_fired = True
                self.lost.add(self.cfg.lose_shard)
                self._note("shard_loss", self.cfg.lose_shard)
        if fire:
            raise ShardLossError(self.cfg.lose_shard, where)

    def on_upload(self, nbytes: int = 0) -> None:
        """One host->device placement is about to run.  Sleeps
        ``upload_delay_s`` and fails the first ``upload_failures``
        placements."""
        if self.cfg.upload_delay_s:
            time.sleep(self.cfg.upload_delay_s)
        with self._lock:
            self.uploads += 1
            fail = self._uploads_to_fail > 0
            if fail:
                self._uploads_to_fail -= 1
                self._note("upload_failure", nbytes)
        if fail:
            raise UploadError(f"injected h2d failure ({nbytes} B)")

    def on_thread(self, name: str) -> None:
        """A worker thread starts a unit of work.  Kills the configured
        thread once."""
        with self._lock:
            fire = (self.cfg.kill_thread == name
                    and name not in self._threads_killed)
            if fire:
                self._threads_killed.add(name)
                self._note("thread_death", name)
        if fire:
            raise ThreadDeathError(name)

    def note_retry(self, attempt: int, err: BaseException,
                   delay: float) -> None:
        """`retry.retry_call` ``on_retry`` callback."""
        with self._lock:
            self.upload_retries += 1
            self._note("upload_retry", (attempt, repr(err)))

    def wants_verify(self) -> bool:
        if self.cfg.verify_rows is not None:
            return self.cfg.verify_rows
        return self.cfg.corrupt_wv_row is not None

    # -- corruption + detection bookkeeping --------------------------------

    def tamper_bank(self, dev: tuple, *, n_shards: int, k_replicas: int = 1,
                    local_cap: int = 0, wv_rows: int = 0) -> tuple:
        """Bit-flip the configured wv row's resident device copy (the
        PRIMARY block only -- the replica block keeps the true bits,
        exactly the partial-corruption case row digests exist for).
        Fires once; returns ``dev`` untouched otherwise.

        The ``w`` plane is cloned on its own device and the one row is
        changed in the clone, so a memoized clean placement (the
        simulated durable dump) is never poisoned and nothing crosses
        to the host."""
        r = self.cfg.corrupt_wv_row
        with self._lock:
            fire = (r is not None and not self._corrupted
                    and 0 <= r < max(wv_rows, 1))
            if fire:
                self._corrupted = True
                self._corrupt_at = (self.dispatches, time.monotonic())
                self._note("corrupt_row", r)
        if not fire:
            return dev
        a, w, v, p = dev
        w = w.clone()
        if w.dim() == 3:            # sub stack (n_shards, k*local, S)
            w[r % n_shards, r // n_shards] += 1.0
        else:                       # replicated (rows, S)
            w[r] += 1.0
        return (a, w, v, p)

    def note_detection(self, rows: Sequence[int]) -> None:
        with self._lock:
            if self._detect_at is None:
                self._detect_at = (self.dispatches, time.monotonic())
            self._note("integrity_detected", tuple(rows))

    def note_recovery(self, source: str, ms: float, shard: Optional[int],
                      mode: str = "spare") -> None:
        with self._lock:
            rec = {"source": source, "ms": ms, "shard": shard, "mode": mode}
            self.recoveries.append(rec)
            self._note("recovered", rec)

    # -- observability -----------------------------------------------------

    def report(self) -> Dict[str, object]:
        """Detection / recovery metrics of this scenario so far."""
        with self._lock:
            det_disp = det_ms = None
            if self._corrupt_at is not None and self._detect_at is not None:
                det_disp = self._detect_at[0] - self._corrupt_at[0]
                det_ms = (self._detect_at[1] - self._corrupt_at[1]) * 1e3
            return {
                "dispatches": self.dispatches,
                "uploads": self.uploads,
                "upload_retries": self.upload_retries,
                "lost_shards": sorted(self.lost),
                "threads_killed": sorted(self._threads_killed),
                "detection_dispatches": det_disp,
                "detection_ms": det_ms,
                "recoveries": list(self.recoveries),
                "recovery_ms": sum(r["ms"] for r in self.recoveries),
                "events": len(self.events),
            }


_ACTIVE: Optional[ChaosState] = None
_ACTIVE_LOCK = threading.Lock()


def active() -> Optional[ChaosState]:
    """The currently injected chaos scope, or ``None`` (the production
    fast path: every hook site is one call + ``None`` check)."""
    return _ACTIVE


@contextlib.contextmanager
def inject(cfg: ChaosConfig):
    """Activate one failure scenario for the dynamic extent of the
    ``with`` block (process-global: the engine worker threads and the
    serving daemon observe it too). Yields the :class:`ChaosState`
    whose :meth:`~ChaosState.report` carries the detection/recovery
    metrics. Scopes do not nest."""
    global _ACTIVE
    state = ChaosState(cfg)
    with _ACTIVE_LOCK:
        if _ACTIVE is not None:
            raise RuntimeError("a chaos scope is already active")
        _ACTIVE = state
    try:
        yield state
    finally:
        with _ACTIVE_LOCK:
            _ACTIVE = None


def resolve_k_replicas(k_replicas: Optional[int], n_shards: int) -> int:
    """The effective sub-bank replication factor: the caller's explicit
    ``k_replicas`` if given, else 2 under an active chaos scope and 1
    otherwise (the Replica set costs bytes, so it is on by default ONLY
    when resilience is requested; ``k=1`` is the plain layout).
    Clamped to ``[1, n_shards]``: a replica in the owner's own block
    protects nothing, so at one shard the journal is the only rebuild
    source."""
    k = k_replicas if k_replicas is not None \
        else (2 if active() is not None else 1)
    return max(1, min(int(k), n_shards))


# ---------------------------------------------------------------------------
# Integrity digests (detection)
# ---------------------------------------------------------------------------


def row_digest(row: np.ndarray) -> int:
    """CRC32 of one bank row's raw bytes (exact: the planes are
    deterministic f32/bool bits, so host and device copies of the same
    row digest identically, and equal the JAX package's digests)."""
    return zlib.crc32(np.ascontiguousarray(row).tobytes())


def _flat_rows(plane: torch.Tensor, rows: Sequence[int], n_shards: int,
               local_cap: int, block: int) -> List[int]:
    """Row indices into ``plane`` viewed as ``(-1, n_stores)`` of the
    copies of global wv ``rows`` in replica ``block``: row ``r`` itself
    on the 2-D replicated layout; on the sub stack, shard ``(r %
    n_shards + block) % n_shards`` at local index ``block * local_cap +
    r // n_shards``."""
    if plane.dim() == 2:
        return list(rows)
    width = plane.shape[1]
    return [((r % n_shards + block) % n_shards) * width
            + block * local_cap + r // n_shards for r in rows]


def _read_rows(dev: tuple, rows: Sequence[int], n_shards: int,
               local_cap: int, block: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(w, v, pr_nc)`` host copies of ``rows``' copies in ``block``:
    one gather and one device->host copy per plane."""
    _, w, v, p = dev
    idx = torch.tensor(_flat_rows(w, rows, n_shards, local_cap, block),
                       dtype=torch.long, device=w.device)
    return tuple(x.reshape(-1, x.shape[-1]).index_select(0, idx).cpu()
                 .numpy() for x in (w, v, p))


def fetch_wv_row(dev: tuple, r: int, *, n_shards: int,
                 local_cap: int = 0, block: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read global wv row ``r``'s ``(w, v, pr_nc)`` bytes back from a
    placed bank ``(arrivals, w, v, pr_nc)``. On the sub-bank layout
    replica ``block`` ``j`` of owner ``r % n_shards`` lives in shard
    ``(r % n_shards + j) % n_shards``'s block at local index ``j *
    local_cap + r // n_shards``; the replicated 2-D layout indexes row
    ``r`` directly."""
    return tuple(x[0] for x in _read_rows(dev, [r], n_shards, local_cap,
                                          block))


def verify_rows(bank, dev: tuple, rows: Sequence[int], *, n_shards: int,
                local_cap: int = 0, where: str = "") -> None:
    """Gather-path integrity check: CRC-compare the device-resident
    primary copy of each global wv row in ``rows`` against the host
    bank's columns. Raises :class:`IntegrityError` listing every bad
    row. Reads the checked rows back in one copy per plane -- callers
    sample (the rows the next tile will gather, capped)."""
    rows = [r for r in rows if 0 <= r < bank.wv_rows]
    if not rows:
        return
    got = _read_rows(dev, rows, n_shards, local_cap, 0)
    bad = [r for i, r in enumerate(rows)
           if any(row_digest(g[i]) != row_digest(h[r])
                  for g, h in zip(got, (bank.w, bank.v, bank.pr_nc)))]
    if bad:
        st = active()
        if st is not None:
            st.note_detection(bad)
        raise IntegrityError(bad, where)


# ---------------------------------------------------------------------------
# Shard rebuild (recovery)
# ---------------------------------------------------------------------------


def owned_rows(lost: int, n_shards: int, wv_rows: int) -> List[int]:
    """Global wv rows whose primary copy lived on shard ``lost``."""
    return list(range(lost, wv_rows, n_shards))


def replica_rebuild(dev: tuple, lost: int, *, n_shards: int,
                    k_replicas: int, local_cap: int, wv_rows: int
                    ) -> Dict[str, np.ndarray]:
    """Rebuild the lost shard's wv rows from the SURVIVING replica
    block: with ``k_replicas >= 2`` row ``r``'s second copy lives in
    shard ``(r % n + 1) % n``'s replica block 1, a different shard by
    construction, so losing one shard never loses a row. The lost
    shard's rows sit there in global-row order at local indices
    ``[local_cap, local_cap + len(rows))``, so each plane is read back
    as ONE ``(rows, n_stores)`` slice of the survivor -- nothing of the
    lost shard's own blocks is read. Returns ``{"w", "v", "pr_nc"}``
    host arrays, the exact bits :func:`verify_rebuild` then digests
    against the host truth."""
    if k_replicas < 2:
        raise ValueError("replica rebuild needs k_replicas >= 2")
    if n_shards < 2:
        raise ValueError("replica rebuild needs n_shards >= 2")
    with _tm.span("chaos/replica_rebuild", shard=lost):
        m = len(owned_rows(lost, n_shards, wv_rows))
        if not m:
            return {k: np.zeros((0,), np.float32)
                    for k in ("w", "v", "pr_nc")}
        survivor = (lost + 1) % n_shards
        _, w, v, p = dev
        return {name: x[survivor, local_cap:local_cap + m].cpu().numpy()
                for name, x in (("w", w), ("v", v), ("pr_nc", p))}


def journal_rebuild(bank, lost: int, n_shards: int) -> Dict[str, np.ndarray]:
    """Rebuild the lost shard's wv rows from the host side: the
    acknowledged dump (the bank's own columns -- in a real deployment
    the durable CXL-memory copy) plus the Logging-Unit journal of
    un-dumped ``extend()`` diffs. When a journal is enabled, its replay
    is first digest-checked against the bank's tail rows (a divergent
    journal would replay corruption), then the owned rows are sliced
    out in global-row order -- byte-identical to what
    :func:`replica_rebuild` reads off the surviving block."""
    with _tm.span("chaos/journal_rebuild", shard=lost):
        return _journal_rebuild(bank, lost, n_shards)


def _journal_rebuild(bank, lost: int, n_shards: int) -> Dict[str, np.ndarray]:
    entries = bank.replay_journal() if getattr(bank, "journal_enabled",
                                               False) else None
    if entries is not None and entries["w"].shape[0]:
        p0 = bank.wv_rows - entries["w"].shape[0]
        for name in ("w", "v", "pr_nc"):
            tail = getattr(bank, name)[p0:]
            if row_digest(entries[name]) != row_digest(tail):
                raise IntegrityError(
                    list(range(p0, bank.wv_rows)),
                    "journal replay diverges from the host bank")
    rows = owned_rows(lost, n_shards, bank.wv_rows)
    return {"w": bank.w[rows].copy(), "v": bank.v[rows].copy(),
            "pr_nc": bank.pr_nc[rows].copy()}


def verify_rebuild(bank, rebuilt: Dict[str, np.ndarray], lost: int,
                   n_shards: int) -> None:
    """Digest-check rebuilt rows against the host truth before they are
    re-placed (recovery must never install corrupt rows)."""
    with _tm.span("chaos/verify_rebuild", shard=lost):
        _verify_rebuild(bank, rebuilt, lost, n_shards)


def _verify_rebuild(bank, rebuilt: Dict[str, np.ndarray], lost: int,
                    n_shards: int) -> None:
    rows = owned_rows(lost, n_shards, bank.wv_rows)
    bad = [r for i, r in enumerate(rows)
           if any(row_digest(rebuilt[name][i]) !=
                  row_digest(getattr(bank, name)[r])
                  for name in ("w", "v", "pr_nc"))]
    if bad:
        raise IntegrityError(bad, "rebuilt rows fail digests")
