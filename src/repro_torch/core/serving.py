"""Scenario-serving daemon: the engine as a long-lived service.

Every batch tier (``simulate_batch``, ``run_grid``) is call-oriented:
one grid in, results out, state dropped. The paper's SS VIII evaluation
has the opposite shape -- many small "what if" queries against ONE
cluster model, amortized across workload x config x failure-time
points. :class:`ScenarioServer` is that layer: a stateful,
latency-oriented daemon over the banked engine that keeps everything
expensive resident on its device and makes the marginal query cost
proportional to what is genuinely new about it.

How a query is served:

1. **Lane cache.** A query resolves to its scan lane -- ``(SB depth,
   trace row, max-plus row)``, via ``simulator._plane_keys``, the same
   dedup key the streaming engine scans by. If the lane was ever
   scanned before (by any earlier query or the warm grid), the answer
   is pure host math over the cached lane outputs: no device work, no
   upload, ``==`` to a cold run because ``_finish_result`` is the same
   code every other tier ends with.

2. **Incremental bank diffs.** A miss extends the server's
   :class:`~repro_torch.core.simulator.TraceBank` in place
   (:meth:`TraceBank.extend` -- append-only, first-seen order, so the
   grown bank stays byte-identical to a from-scratch build of the
   merged grid) and ships ONLY the appended rows host->device: the
   device bank is **capacity-padded** (rows rounded up to
   :data:`SERVE_ROW_PAD`), so in-capacity appends are ``copy_``s of the
   new rows into the server's own capacity tensors, whose shapes never
   change. The resident bank uses the engine's per-shard sub-bank
   layout: arrivals as one plane, the three max-plus planes stacked
   ``(n_shards, k * local_capacity, n_stores)`` contiguous on the card
   -- row ``r`` owned by logical shard ``r % n_shards`` at local index
   ``r // n_shards``. Capacity is therefore PER SHARD: an in-capacity wv
   append splices one rectangular local-row window (at most ``n_shards
   - 1`` old rows re-ship).

3. **Canonical batching.** Miss lanes are grouped and padded by
   ``engine.plan_tiles(small_pad=False)`` into the SAME canonical
   SB-uniform tile shapes the streaming engine uses, and executed
   through ``engine.tile_fn`` -- one bank-scan kernel launch per tile.
   The program cache, the ``trace_count()`` accounting and the
   capacity-shape trick together give **zero new tile programs and zero
   kernel builds in steady state**: once :meth:`warm` has built the
   (SB x capacity-shape) programs, novel queries reuse them verbatim.

4. **Async batching window.** :meth:`submit` enqueues a query and
   returns a ``Future``; a daemon thread coalesces everything arriving
   within ``batch_window_ms`` (or up to ``batch_cells``) into one
   flush, so concurrent callers share tiles instead of paying one
   launch each.

5. **Bounded uptime state.** Both the lane-answer cache and the bank
   grow monotonically with the query universe by default;
   ``max_lanes`` LRU-bounds the lane cache (least recently *asked*
   lane evicted first) and ``max_bank_rows`` triggers a bank
   **compaction** -- rebuild from the live cached lanes' specs, drop
   the device bank for a fresh capacity placement. Evicted lanes
   re-asked later take the ordinary miss path and stay ``==``;
   ``stats()`` counts ``lane_evictions`` / ``bank_compactions``.

Recovery questions ("what's my downtime if CN 3 dies mid-interval?")
bypass the store-level scan entirely: :meth:`query_downtime` delegates
to the closed-form SS VII-E model via
:func:`repro_torch.core.scenarios.downtime_query`.

Thread safety: all serve state is guarded by one re-entrant lock, and
the shared host memos the flush path touches (``_trace_cached``,
``_cell_arrays``, ``_wv_row``) are thread-safe caches. A racing
``clear_sim_caches()`` may drop tile programs (the next flush rebuilds
them) and host memos (rebuilt on demand), but never the server's bank
handle or lane cache -- answers stay ``==`` throughout. The daemon and
watchdog threads place on the server's own device explicitly: a new
thread does not inherit its caller's current CUDA device.

The shards lie on one placement (the default: the stacks contiguous on
one device, one launch a tile) or on one placement each (``devices``,
the JAX package's layout, ``src/repro/core/serving.py:203-206`` and
``:354-372``): placement ``s`` holds shard ``s``'s capacity stacks and a
copy of the arrivals, a tile's index vectors split into the shards'
slot blocks, and a flush launches its tile once per placement before
draining any.
"""

from __future__ import annotations

import copy
import dataclasses
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from typing import Deque, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.configs.recxl_paper import ClusterConfig, PAPER_CLUSTER
from repro_torch.core import chaos as _chaos
from repro_torch.core import engine as _engine
from repro_torch.core import telemetry as _tm
from repro_torch.core.chaos import (IntegrityError, ShardLossError,
                                    ThreadDeathError)
from repro_torch.core.recovery import RecoveryEstimate
from repro_torch.core.scenarios import downtime_query, sweep_grid
from repro_torch.core.simulator import (
    ScenarioSpec,
    SimResult,
    _commit_cost_ns,
    _finish_result,
    _plane_keys,
    _prepare_cell,
    _trace_cached,
    fill_sub_shard,
    get_trace_bank,
)
from repro_torch.distributed.context import cells_devices

#: Device-bank rows are padded up to the next multiple of this (with at
#: least one full spare block of headroom), so appending a novel
#: query's rows keeps the resident tensors' SHAPES -- and therefore the
#: tile signatures and programs -- unchanged. 256 rows of headroom
#: absorb thousands of single-row queries between the (rare) capacity
#: growths, which build new programs.
SERVE_ROW_PAD = 256

#: Default cells per serve tile: small enough that a single query's
#: flush stays cheap (the other ``b_pad - 1`` lanes are padding), large
#: enough that a burst amortizes one launch across many lanes.
SERVE_BATCH_CELLS = 64


def _row_capacity(rows: int, pad: int) -> int:
    """Smallest multiple of ``pad`` that is STRICTLY greater than
    ``rows`` -- the strict inequality guarantees spare rows, so a
    freshly-grown bank can always absorb at least one more append
    before the next capacity step."""
    return (rows // pad + 1) * pad


def _pad_rows(col: np.ndarray, cap: int) -> np.ndarray:
    """``col`` zero-padded along axis 0 to ``cap`` rows."""
    out = np.zeros((cap,) + col.shape[1:], col.dtype)
    out[:col.shape[0]] = col
    return out


class ScenarioServer:
    """Persistent in-process scenario-query daemon over the banked engine.

    Synchronous entry points (:meth:`query`, :meth:`query_batch`,
    :meth:`query_grid`, :meth:`query_downtime`) serve in the caller's
    thread; :meth:`submit` returns a ``concurrent.futures.Future`` and
    lets the daemon thread batch concurrent queries within
    ``batch_window_ms``. Every protocol answer is ``==`` on every
    ``SimResult`` field but ``meta`` to the cold
    ``simulate_grid``/``simulate_spec`` oracle for the same spec and to
    the JAX package's server at the same ``n_shards`` -- the server only
    ever reorganizes *which tile program computes which lane when*,
    never the arithmetic.

    ``device=None`` means CUDA (raises without one; ``device="cpu"``
    runs the plain versions). ``devices`` places the shards
    (:func:`~repro_torch.distributed.context.cells_devices`): ``None``
    (the default) or one device keeps them all on one placement,
    ``device``; ``n_shards`` devices put shard ``s`` on ``devices[s]``
    (entries may repeat). The placements are kept in
    :attr:`placements`, the first in :attr:`device`, and every placement
    and thread uses them.
    ``batch_cells`` is the canonical serve-tile size (every flush pads
    to it -- one program per store-buffer depth); ``row_pad`` the
    device-bank capacity quantum (:data:`SERVE_ROW_PAD`; the wv capacity
    is PER-SHARD local rows, so the global headroom is ``~n_shards x
    row_pad``); ``n_shards`` > 1 lays the bank out in logical shards
    exactly like the streaming engine's sub-bank layout (max-plus stacks
    per shard, every miss lane scheduled into the slot block of the
    shard owning its wv row).
    ``max_lanes`` / ``max_bank_rows`` (both unbounded by default)
    LRU-bound the lane-answer cache and trigger bank compaction for
    long uptimes -- see the module docstring. Use as a context manager
    or call :meth:`close` to stop the daemon thread; a closed server
    still answers synchronous queries.

    **Resilience.** ``k_replicas`` widens every wv capacity block with
    the paper's Replica set (default: 2 under an active
    ``chaos.inject`` scope, else 1 -- the plain layout),
    and turns on the bank's Logging-Unit journal (un-dumped ``extend``
    diffs retained until the device dump is acknowledged at the end of
    each flush). A detected shard loss / corrupt row mid-flush is
    recovered IN PLACE: the lost rows are rebuilt from the surviving
    replica block or the journal, digest-verified, and the device bank
    re-placed at the SAME capacity -- same signatures, zero new
    programs, answers stay ``==``; pending ``submit`` futures fail only
    if recovery itself fails. ``submit_timeout_ms`` bounds
    how long a queued future may wait (per-call override on
    :meth:`submit`), ``watchdog_ms`` bounds one flush: a watchdog
    thread expires timed-out futures with a diagnostic, respawns a
    dead daemon thread, and fails a wedged flush's futures instead of
    blocking callers forever. The server always recovers on the
    spare-replacement path (its shard count never shrinks); the
    degraded fallback is the batch engine's.
    """

    def __init__(self, cluster: ClusterConfig = PAPER_CLUSTER,
                 n_stores: int = 50_000,
                 batch_cells: int = SERVE_BATCH_CELLS,
                 batch_window_ms: float = 2.0,
                 chunk_size: Optional[int] = None,
                 n_shards: int = 1,
                 row_pad: int = SERVE_ROW_PAD,
                 max_lanes: Optional[int] = None,
                 max_bank_rows: Optional[int] = None,
                 k_replicas: Optional[int] = None,
                 submit_timeout_ms: Optional[float] = None,
                 watchdog_ms: Optional[float] = None,
                 device=None, devices=None):
        self.placements = cells_devices(n_shards, devices, device)
        self.device = self.placements[0]
        self._multi = len(self.placements) > 1
        if batch_cells < 1:
            raise ValueError(f"batch_cells must be >= 1, got {batch_cells}")
        if row_pad < 1:
            raise ValueError(f"row_pad must be >= 1, got {row_pad}")
        if max_lanes is not None and max_lanes < 1:
            raise ValueError(f"max_lanes must be >= 1, got {max_lanes}")
        if max_bank_rows is not None and max_bank_rows < 2:
            raise ValueError("max_bank_rows must be >= 2 (one lane needs "
                             f"a trace and a wv row), got {max_bank_rows}")
        if submit_timeout_ms is not None and submit_timeout_ms <= 0:
            raise ValueError("submit_timeout_ms must be > 0, got "
                             f"{submit_timeout_ms}")
        if watchdog_ms is not None and watchdog_ms <= 0:
            raise ValueError(f"watchdog_ms must be > 0, got {watchdog_ms}")
        self.cluster = cluster
        self.n_stores = int(n_stores)
        self.batch_cells = int(batch_cells)
        self.batch_window_ms = float(batch_window_ms)
        self.chunk_size = chunk_size
        self.n_shards = int(n_shards)
        self.row_pad = int(row_pad)
        self.max_lanes = max_lanes
        self.max_bank_rows = max_bank_rows
        # resolved at construction: explicit k wins, else 2 under an
        # active chaos scope, else 1 (byte- and signature-identical to
        # the pre-resilience layout)
        self.k_replicas = _chaos.resolve_k_replicas(k_replicas,
                                                    self.n_shards)
        self.submit_timeout_ms = submit_timeout_ms
        self.watchdog_ms = watchdog_ms

        # serve state (all guarded by _lock)
        self._lock = threading.RLock()
        self._bank = None                               # TraceBank handle
        # capacity tensors: one (arrivals, w, v, pr_nc), or one such
        # tuple per placement
        self._dev: Optional[tuple] = None
        self._cap: Tuple[int, int] = (0, 0)             # (trace, LOCAL wv)
        self._dev_rows: Tuple[int, int] = (0, 0)        # real rows resident
        # lane key -> (exec_ns, at_head, sb_full, representative spec);
        # insertion order IS recency order (move_to_end on every hit),
        # so eviction pops the least recently asked lane first and
        # compaction rebuilds the bank from exactly the live specs
        self._lanes: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._sigs: Set[_engine.TileSignature] = set()
        self._compact_floor = 0        # rows after the last compaction
        self._stats: Dict[str, int] = {
            "queries": 0, "lane_hits": 0, "lane_misses": 0,
            "scanned_lanes": 0, "flushes": 0, "batches": 0,
            "h2d_bytes": 0, "bank_uploads": 0, "bank_builds": 0,
            "appended_trace_rows": 0, "appended_wv_rows": 0,
            "compiled_programs": 0, "downtime_queries": 0,
            "lane_evictions": 0, "bank_compactions": 0,
            "recoveries": 0, "recovery_ms": 0,
        }

        # async queue (guarded by _cond; the worker serves via the
        # synchronous path, so _cond is never held across device work).
        # Queue entries are (spec, future, deadline-or-None, enqueued); the
        # watchdog thread expires deadlines, respawns a dead worker and
        # fails a wedged flush -- its counters live in _wd_stats, also
        # guarded by _cond (the watchdog never takes _lock, so there is
        # no _cond/_lock ordering between the two threads)
        self._cond = threading.Condition()
        self._queue: Deque[Tuple[ScenarioSpec, Future,
                                 Optional[float]]] = deque()
        self._worker: Optional[threading.Thread] = None
        self._watchdog: Optional[threading.Thread] = None
        self._flush_started: Optional[float] = None
        self._flush_batch: List[tuple] = []
        # set when the watchdog fails a wedged flush, cleared when that
        # flush returns: the daemon serves nothing queued meanwhile
        self._wedged = False
        self._wd_stats: Dict[str, int] = {
            "submit_timeouts": 0, "worker_restarts": 0,
            "watchdog_flush_failures": 0,
        }
        self._worker_spawned = False
        self._closed = False

    # -- context manager ---------------------------------------------------

    def __enter__(self) -> "ScenarioServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Stop the daemon thread after draining pending submissions.
        Synchronous queries still work on a closed server; further
        :meth:`submit` calls raise.

        Deterministic under concurrent submitters and worker death:
        racing ``submit`` calls either enqueued before the close (their
        futures are served or failed below, never left hanging) or
        raise. After the worker and watchdog exit, anything still
        queued (e.g. the worker died and no watchdog was there to
        respawn it) is failed with a diagnostic."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
            worker = self._worker
            watchdog = self._watchdog
        if worker is not None:
            worker.join()
        if watchdog is not None:
            watchdog.join()
        with self._cond:
            leftovers = list(self._queue)
            self._queue.clear()
        for e in leftovers:
            if not e[1].done():
                e[1].set_exception(RuntimeError(
                    "ScenarioServer closed with the query still pending "
                    "(daemon thread dead or never scheduled)"))

    # -- query -> lane plumbing -------------------------------------------

    def _lane_key(self, spec: ScenarioSpec) -> tuple:
        sb = spec.sb_size if spec.sb_size is not None \
            else self.cluster.store_buffer
        return (sb,) + _plane_keys(spec, self.cluster)

    def _journal_wanted(self) -> bool:
        """Logging-Unit journaling is on whenever resilience is: with a
        replica set placed, or under an active chaos scope (so a 1-shard
        server still has a rebuild source)."""
        return self.k_replicas > 1 or _chaos.active() is not None

    def _ensure_bank(self, specs: Sequence[ScenarioSpec]) -> None:
        """First call adopts the digest-memoized grid bank (shared with
        any engine sweeping the same grid); later calls append-extend
        it. The server keeps its own handle, so a racing
        ``clear_sim_caches()`` never forces a rebuild. Under a
        resilience config the bank journals its ``extend`` diffs (the
        Logging Unit) -- enabled BEFORE the extend so the diff itself
        is retained until :meth:`TraceBank.ack_journal`."""
        if self._bank is None:
            self._bank = get_trace_bank(specs, self.n_stores, self.cluster)
            if self._journal_wanted():
                self._bank.enable_journal()
            self._stats["bank_builds"] += 1
            return
        if self._journal_wanted():
            self._bank.enable_journal()
        nt, nw = self._bank.extend(specs)
        self._stats["appended_trace_rows"] += nt
        self._stats["appended_wv_rows"] += nw

    def _place(self, host: tuple, device=None) -> tuple:
        """Host arrays as tensors of the server's own on ``device`` (its
        first placement by default) -- always a copy, even on the CPU,
        so a later in-place splice never writes into a host array or a
        ``TraceBank`` placement."""
        _engine._h2d_hook(sum(int(x.nbytes) for x in host))
        return tuple(torch.from_numpy(np.ascontiguousarray(x))
                     .to(device or self.device, copy=True) for x in host)

    def _place_parts(self, a_host: np.ndarray, subs: tuple) -> tuple:
        """The capacity bank over placements: the arrivals cross to the
        first placement once and are copied device to device to the
        others, and placement ``s`` receives only shard ``s``'s ``(1,
        ...)`` slice of each stack from the host (the JAX package's
        ``_place_rows`` / ``_place_sub``,
        ``src/repro/core/serving.py:354-372``)."""
        a0 = self._place((a_host,))[0]
        _engine._h2d_hook(sum(int(x.nbytes) for x in subs))
        return tuple(
            (a0 if s == 0 else a0.to(d, copy=True),)
            + tuple(torch.from_numpy(np.ascontiguousarray(x[s:s + 1]))
                    .to(d, copy=True) for x in subs)
            for s, d in enumerate(self.placements))

    def _sub_stack(self, col: np.ndarray, cap: int) -> np.ndarray:
        """Host sub-bank stack of ``col`` at local capacity ``cap``:
        ``out[s, q] = col[q * n_shards + s]`` (owner ``r % n_shards``,
        local index ``r // n_shards``), zero-padded per shard.

        With a replica set (``k_replicas > 1``) the local axis carries
        ``k`` capacity blocks: block ``j`` of shard ``s`` holds the
        rows owned by shard ``(s - j) % n_shards`` (the
        ``TraceBank.sub_bank_host`` layout at capacity), so global row
        ``r`` is resident on shards ``r % n`` AND ``(r % n + 1) % n``
        and one lost shard never loses a row. Gathers (and the programs'
        shapes at ``k=1``) only ever touch block 0."""
        n = self.n_shards
        out = np.zeros((n, self.k_replicas * cap) + col.shape[1:],
                       col.dtype)
        for s in range(n):
            fill_sub_shard(out[s], col, s, n, self.k_replicas, cap)
        return out

    def _sub_window(self, col: np.ndarray, lo: int, hi: int,
                    p: int) -> np.ndarray:
        """The ``(n_shards, hi - lo, ...)`` sub-stack window covering
        global rows ``[lo * n_shards, p)`` of ``col`` -- the local-row
        span ``[lo, hi)`` every shard splices in one rectangular block.
        Global row ``r = (q - lo) * n_shards + s + lo * n_shards`` lands
        at ``[s, q - lo]``; slots past ``p`` stay zero (unowned tail of
        the ragged last local row)."""
        n = self.n_shards
        span = np.zeros(((hi - lo) * n,) + col.shape[1:], col.dtype)
        span[:p - lo * n] = col[lo * n:p]
        return np.ascontiguousarray(
            span.reshape((hi - lo, n) + col.shape[1:]).swapaxes(0, 1))

    def _sync_device(self) -> int:
        """Bring the capacity-padded device sub-bank up to date with
        the host bank. Returns the bytes that crossed host->device: the
        whole padded bank on first placement or a capacity growth;
        otherwise just the appended arrivals rows plus the spliced
        local-row window (at most ``n_shards - 1`` old wv rows re-ship
        -- the rectangle is the price of one shard-uniform splice).
        In-capacity splices are ``copy_``s into the server's capacity
        tensors, so their shapes (and the tile signatures) never
        change."""
        bank = self._bank
        n = self.n_shards
        k = self.k_replicas
        t, p = bank.trace_rows, bank.wv_rows
        t_cap = _row_capacity(t, self.row_pad)
        p_cap = _row_capacity(-(-p // n), self.row_pad)   # per-shard local
        if self._dev is None or t_cap > self._cap[0] or p_cap > self._cap[1]:
            cap = (max(t_cap, self._cap[0]), max(p_cap, self._cap[1]))
            a_host = _pad_rows(bank.arrivals, cap[0])
            subs = (self._sub_stack(bank.w, cap[1]),
                    self._sub_stack(bank.v, cap[1]),
                    self._sub_stack(bank.pr_nc, cap[1]))
            self._dev = (self._place_parts(a_host, subs) if self._multi
                         else self._place((a_host,)) + self._place(subs))
            self._cap = cap
            self._dev_rows = (t, p)
            self._stats["bank_uploads"] += 1
            self._tamper()
            return int(a_host.nbytes) + sum(int(x.nbytes) for x in subs)
        h2d = 0
        parts = self._parts()
        t0, p0 = self._dev_rows
        if t > t0:
            # one host crossing to the first placement, copied device to
            # device to the others
            rows = self._place((bank.arrivals[t0:t],))[0]
            for part in parts:
                part[0][t0:t].copy_(rows)
            h2d += int(bank.arrivals[t0:t].nbytes)
        if p > p0:
            # local rows touched by global rows [p0, p): splice the
            # rectangular window [lo, hi) of every shard at once (axis 1
            # of the stacks). With a replica set, block j's window is
            # the block-0 window rolled j shards along axis 0 (block j
            # of shard s holds the rows block 0 of shard (s - j) % n
            # holds), spliced at its own axis-1 offset -- every replica
            # of an appended row ships in the same flush, so a loss
            # right after the splice still rebuilds from the survivor
            lo, hi = p0 // n, -(-p // n)
            win0 = tuple(self._sub_window(c, lo, hi, p)
                         for c in (bank.w, bank.v, bank.pr_nc))
            for j in range(k):
                deltas = win0 if j == 0 else tuple(
                    np.ascontiguousarray(np.roll(d, j, axis=0))
                    for d in win0)
                o = j * self._cap[1]
                # over placements each receives its own shard's window
                _engine._h2d_hook(sum(int(d.nbytes) for d in deltas))
                for s, part in enumerate(parts):
                    for dst, d in zip(part[1:], deltas):
                        d = d[s:s + 1] if self._multi else d
                        dst[:, o + lo:o + hi].copy_(torch.from_numpy(
                            np.ascontiguousarray(d)).to(dst.device))
                h2d += sum(int(d.nbytes) for d in deltas)
        if h2d:
            self._dev_rows = (t, p)
            self._tamper()
        return h2d

    def _tamper(self) -> None:
        """Chaos corruption point: bit-flip the configured wv row's
        resident device copy (fires once per scope; no-op otherwise)."""
        st = _chaos.active()
        if st is not None and self._dev is not None:
            self._dev = st.tamper_bank(self._dev, n_shards=self.n_shards,
                                       k_replicas=self.k_replicas,
                                       local_cap=self._cap[1],
                                       wv_rows=self._bank.wv_rows)

    def _serve_sigs(self, lane_specs: Sequence[ScenarioSpec]
                    ) -> List[Tuple[_engine.Tile, _engine.TileSignature]]:
        """Plan miss lanes into canonical serve tiles: the streaming
        engine's own scheduler at the serve-tile size, retargeted at
        the banked SUB layout with the CAPACITY shape (the signature
        the programs are keyed on, stable across in-capacity appends).
        At more than one shard each lane is scheduled into the slot
        block of the shard owning its wv row, as the streaming engine
        schedules it."""
        owners = None
        if self.n_shards > 1:
            owners = [self._bank.rows_for(s)[1] % self.n_shards
                      for s in lane_specs]
        tiles = _engine.plan_tiles(lane_specs, cluster=self.cluster,
                                   n_stores=self.n_stores,
                                   chunk_size=self.chunk_size,
                                   tile_cells=self.batch_cells,
                                   n_shards=self.n_shards, small_pad=False,
                                   owners=owners)
        # the signature sees one shard's local axis: k_replicas capacity
        # blocks (identical to self._cap at k=1 -- the resilient and
        # plain layouts share programs only with themselves)
        shape = (self._cap[0], self.k_replicas * self._cap[1])
        return [(t, dataclasses.replace(t.sig, data_plane="bank",
                                        bank_shape=shape,
                                        bank_sub=True))
                for t in tiles]

    def _scan_lanes(self, miss: Dict[tuple, ScenarioSpec]) -> int:
        """Scan every miss lane once through ``engine.tile_fn`` (one
        kernel launch per tile and placement, every placement launched
        before any is drained) and cache its raw outputs. A lane's wv
        entry is its flat row ``owner * k * capacity + local`` in the
        contiguous stacks of one placement, its local row ``wv_row //
        n_shards`` in its shard's own (the JAX package's
        ``_scan_lanes``, ``src/repro/core/serving.py:519``). Returns the
        index-vector h2d bytes."""
        lane_keys = list(miss)
        bank = self._bank
        n = self.n_shards
        stride = 0 if self._multi else self.k_replicas * self._cap[1]
        st = _chaos.active()
        h2d = 0
        for tile, sig in self._serve_sigs([miss[k] for k in lane_keys]):
            trace_idx = np.zeros(sig.b_pad, np.int32)
            wv_idx = np.zeros(sig.b_pad, np.int32)
            slots = list(tile.slots) if tile.slots is not None \
                else list(range(len(tile.specs)))
            for s, pos in zip(tile.specs, slots):
                tr, wr = bank.rows_for(s)
                trace_idx[pos] = tr
                wv_idx[pos] = (wr % n) * stride + wr // n
            idx = (trace_idx, wv_idx)
            h2d += idx[0].nbytes + idx[1].nbytes
            if st is not None:
                if st.wants_verify():
                    # gather-path integrity sampling against the host
                    # truth, before this tile's rows are served
                    rows = sorted({bank.rows_for(s)[1]
                                   for s in tile.specs})
                    _chaos.verify_rows(
                        bank, self._dev,
                        rows[:_engine.VERIFY_ROWS_PER_TILE],
                        n_shards=self.n_shards, local_cap=self._cap[1],
                        where="serve gather sample")
                st.on_dispatch("serve flush")

            def place(args=idx):
                _engine._h2d_hook(args[0].nbytes + args[1].nbytes)
                return _engine._place_blocks(args, self.placements)

            outs = _engine.launch_tile(
                sig, _engine._retried(place, "serve tile placement"),
                self.placements, bank_parts=self._parts())
            exec_ns, at_head, sb_full = _engine.drain_tile(outs)
            for i, pos in zip(tile.indices, slots):
                key = lane_keys[i]
                self._lanes[key] = (exec_ns[pos], int(at_head[pos]),
                                    int(sb_full[pos]), miss[key])
            self._sigs.add(sig)
        return h2d

    def _parts(self) -> tuple:
        """The capacity bank's per-placement tuples."""
        return self._dev if self._multi else (self._dev,)

    def _evict(self) -> None:
        """LRU-bound the serve state (end of every flush, under _lock):
        pop least-recently-asked lanes past ``max_lanes``, and when the
        append-only bank has outgrown ``max_bank_rows``, COMPACT it --
        rebuild from the live cached lanes' specs and drop the device
        bank so the next flush re-places at the compacted capacity (new
        programs if the capacity shape shrank). ``_compact_floor``
        stops back-to-back rebuilds when the live lanes alone exceed
        the bound: another compaction only fires after real growth."""
        st = self._stats
        if self.max_lanes is not None:
            while len(self._lanes) > self.max_lanes:
                self._lanes.popitem(last=False)
                st["lane_evictions"] += 1
        if (self.max_bank_rows is not None and self._bank is not None
                and self._bank.n_rows > max(self.max_bank_rows,
                                            self._compact_floor)
                and self._lanes):
            live = [entry[3] for entry in self._lanes.values()]
            self._bank = get_trace_bank(live, self.n_stores, self.cluster)
            self._dev = None
            self._cap = (0, 0)
            self._dev_rows = (0, 0)
            self._compact_floor = self._bank.n_rows
            st["bank_compactions"] += 1

    def _recover(self, err: Exception) -> None:
        """Spare-replacement recovery of the serve bank (under _lock):
        rebuild the lost shard's rows from the surviving replica block
        (or the Logging-Unit journal at ``k_replicas=1``),
        digest-verify them against the host truth, then drop ONLY the
        device placement -- capacity is KEPT, so the next
        :meth:`_sync_device` re-places identical shapes and signatures
        and post-recovery serving builds zero new programs. Over
        placements the lost placement's tensors are freed first, the
        rebuild reads only the survivor's placement, and only the lost
        placement is placed again, at the same capacity (a spare:
        :meth:`_respare`). The JAX package's ``_recover`` is
        ``src/repro/core/serving.py:591``."""
        t0 = time.monotonic()
        lost = err.shard if isinstance(err, ShardLossError) else None
        spare = self._multi and lost is not None and self._dev is not None
        source = "replace"
        rebuilt = None
        with _tm.span("recover", error=type(err).__name__):
            with _tm.span("recover/detect", error=type(err).__name__):
                _tm.count("chaos/faults_detected")
            if lost is not None:
                # the serve shard count never shrinks: validate the
                # spare takeover through the elastic-scaling policy
                # shared with run_grid
                from repro_torch.distributed.elastic import \
                    cells_spare_replacement
                cells_spare_replacement(self.n_shards, lost,
                                        self.placements)
                if spare:
                    # a lost card's memory is gone
                    self._dev = self._dev[:lost] + (None,) \
                        + self._dev[lost + 1:]
                with _tm.span("recover/rebuild", shard=lost):
                    if self.k_replicas >= 2 and self._dev is not None:
                        rebuilt = _chaos.replica_rebuild(
                            self._dev, lost, n_shards=self.n_shards,
                            k_replicas=self.k_replicas,
                            local_cap=self._cap[1],
                            wv_rows=self._bank.wv_rows)
                        source = "replica"
                    elif self._bank.journal_enabled:
                        rebuilt = _chaos.journal_rebuild(
                            self._bank, lost, self.n_shards)
                        source = "journal"
                    else:
                        rebuilt = None
                        source = "host"
                    if rebuilt is not None:
                        _chaos.verify_rebuild(self._bank, rebuilt, lost,
                                              self.n_shards)
            with _tm.span("recover/replace", source=source):
                if spare:
                    self._respare(lost, rebuilt)
                else:
                    # drop only the placement; the next _sync_device
                    # re-places identical shapes (the re-place leg)
                    self._dev = None
                    self._dev_rows = (0, 0)
        ms = (time.monotonic() - t0) * 1e3
        self._stats["recoveries"] += 1
        self._stats["recovery_ms"] += ms
        st = _chaos.active()
        if st is not None:
            st.note_recovery(source, ms, lost, "spare")

    def _respare(self, lost: int, rebuilt) -> None:
        """Place shard ``lost`` again on its own placement at the
        resident capacity: block 0 from ``rebuilt`` (its verified rows;
        ``None`` takes the host bank's), the replica blocks from the host
        bank, the arrivals copied device to device from the survivor's
        placement. The other placements are not touched (the JAX
        package places the whole bank again at its next sync,
        ``src/repro/core/serving.py:591``)."""
        bank, n, cap = self._bank, self.n_shards, self._cap[1]
        p = self._dev_rows[1]
        stacks = tuple(
            fill_sub_shard(np.zeros((self.k_replicas * cap,)
                                    + col.shape[1:], col.dtype),
                           col[:p], lost, n, self.k_replicas, cap,
                           None if rebuilt is None else rebuilt[name])[None]
            for name, col in (("w", bank.w), ("v", bank.v),
                              ("pr_nc", bank.pr_nc)))
        dev = self.placements[lost]
        src = self._dev[_chaos.replica_source(lost, n)][0]
        spare = (src.to(dev, copy=True),) + self._place(stacks, dev)
        self._dev = self._dev[:lost] + (spare,) + self._dev[lost + 1:]
        self._stats["h2d_bytes"] += sum(int(x.nbytes) for x in stacks)
        self._tamper()

    # -- synchronous serving ----------------------------------------------

    def query(self, spec: ScenarioSpec) -> SimResult:
        """Serve one scenario cell (``==`` to the cold oracle)."""
        return self.query_batch([spec])[0]

    def query_batch(self, specs: Sequence[ScenarioSpec]) -> List[SimResult]:
        """Serve a batch of cells in one flush, in ``specs`` order.

        Hits are answered from the lane cache; the distinct miss lanes
        are scanned once through the canonical serve tiles after the
        bank diff (new rows only) is spliced into the resident device
        bank. ``SimResult.meta`` records the serve provenance per cell:
        ``cache`` (``"hit"``/``"miss"``), the flush's marginal
        ``h2d_bytes``, and the bank geometry that answered it."""
        specs = list(specs)
        if not specs:
            return []
        t_flush0 = time.perf_counter()
        for s in specs:
            s.validate(self.cluster)
        with self._lock, _tm.span("serve/flush", queries=len(specs)):
            self._ensure_bank(specs)
            compiled0 = _engine.trace_count()
            attempts = 0
            while True:
                # one serve attempt: bank dump (diff splice), miss
                # resolution, lane scan. A detected fault recovers the
                # device bank in place and re-enters -- lanes scanned
                # before the fault are cache hits on the retry, so no
                # lane is ever served from a suspect placement twice
                try:
                    with _tm.span("serve/bank_sync"):
                        h2d = _engine._retried(self._sync_device,
                                               "serve bank sync")
                    keys = [self._lane_key(s) for s in specs]
                    miss: Dict[tuple, ScenarioSpec] = {}
                    for s, k in zip(specs, keys):
                        if k in self._lanes:
                            self._lanes.move_to_end(k)      # LRU touch
                        else:
                            miss.setdefault(k, s)
                    if miss:
                        with _tm.span("serve/scan", lanes=len(miss)):
                            h2d += self._scan_lanes(miss)
                    break
                except (ShardLossError, IntegrityError) as e:
                    attempts += 1
                    if (_chaos.active() is None
                            or attempts > _engine.MAX_RECOVERIES):
                        raise
                    self._recover(e)
            if self._bank.journal_enabled:
                # the device dump (capacity bank + this flush's diffs)
                # is resident: the Logging Unit's retained copies are
                # acknowledged away
                self._bank.ack_journal()
            st = self._stats
            st["queries"] += len(specs)
            st["lane_misses"] += sum(k in miss for k in keys)
            st["lane_hits"] += sum(k not in miss for k in keys)
            st["scanned_lanes"] += len(miss)
            st["h2d_bytes"] += h2d
            st["compiled_programs"] += _engine.trace_count() - compiled0
            st["flushes"] += 1
            results = []
            for s, k in zip(specs, keys):
                exec_ns, at_head, sb_full, _ = self._lanes[k]
                cell = _prepare_cell(
                    s, _trace_cached(s.workload, self.n_stores, s.seed,
                                     self.cluster),
                    self.n_stores, self.cluster)
                meta = {"engine": "serving", "data_plane": "bank",
                        "bank_partition": "sub",
                        "cache": "miss" if k in miss else "hit",
                        "h2d_bytes": h2d,
                        "bank_rows": self._bank.n_rows,
                        "bank_capacity": self._cap,
                        "n_shards": self.n_shards}
                results.append(_finish_result(cell, exec_ns, at_head,
                                              sb_full, meta=meta))
            self._evict()       # after results: this flush's lanes live
            rec = _tm.active()
            if rec is not None:
                # each query's serve-side latency is its flush's wall
                # time (sync callers see exactly this); hits and misses
                # feed separate histograms so the lane-cache fast path
                # stays attributable
                dt_ms = (time.perf_counter() - t_flush0) * 1e3
                rec.count("serve/lane_hits",
                          sum(k not in miss for k in keys))
                rec.count("serve/lane_misses",
                          sum(k in miss for k in keys))
                for k in keys:
                    rec.observe("serve/query_ms", dt_ms)
                    rec.observe("serve/query_miss_ms" if k in miss
                                else "serve/query_hit_ms", dt_ms)
            return results

    def query_grid(self, **axes) -> List[SimResult]:
        """Serve a whole :func:`~repro_torch.core.scenarios.sweep_grid`
        cross-product (the *grid delta* query shape: cells already
        served are lane-cache hits, genuinely new cells ride the
        diff-upload path; :func:`repro_torch.core.scenarios.grid_delta`
        computes just the novel cells if the caller wants them alone).
        """
        return self.query_batch(sweep_grid(**axes))

    def query_downtime(self, workload: str, fail_time_ms: float,
                       **knobs) -> RecoveryEstimate:
        """Answer a "what's my downtime if ..." request through the
        closed-form SS VII-E model (no store-level scan involved);
        ``knobs`` are :func:`repro_torch.core.scenarios.downtime_query`
        keywords (``n_cns``, ``n_replicas``, ``link_bw_gbps``, the
        contention axes, ``directory_load``)."""
        with self._lock:
            self._stats["downtime_queries"] += 1
        return downtime_query(workload, fail_time_ms,
                              cluster=self.cluster, **knobs)

    # -- warm pool ---------------------------------------------------------

    def warm(self, specs: Sequence[ScenarioSpec],
             populate: bool = True) -> None:
        """Make the server hot for a grid: build/extend the bank, place
        the capacity device bank, and build every serve-tile program the
        grid's store-buffer depths need. With ``populate=True`` (default)
        the whole grid is served once, so every program is built and
        launched and every lane of the grid is a cache hit afterwards;
        ``populate=False`` builds the programs and launches each once
        against the resident capacity bank (``engine.warm_signatures``),
        so the kernel library is loaded, without scanning the grid."""
        specs = list(specs)
        if not specs:
            return
        if populate:
            self.query_batch(specs)
            return
        for s in specs:
            s.validate(self.cluster)
        with self._lock:
            self._ensure_bank(specs)
            self._sync_device()
            lanes: Dict[tuple, ScenarioSpec] = {}
            for s in specs:
                lanes.setdefault(self._lane_key(s), s)
            sigs = list(dict.fromkeys(
                sig for _, sig in self._serve_sigs(list(lanes.values()))))
            costs = _commit_cost_ns("proactive", self.cluster)
            compiled0 = _engine.trace_count()
            _engine.warm_signatures(sigs, costs["t_l1"], costs["t_wt"],
                                    bank_dev=self._dev, device=self.device,
                                    devices=self.placements)
            self._sigs.update(sigs)
            self._stats["compiled_programs"] += \
                _engine.trace_count() - compiled0

    # -- async batching ----------------------------------------------------

    def submit(self, spec: ScenarioSpec,
               timeout_ms: Optional[float] = None) -> "Future[SimResult]":
        """Enqueue one query; the daemon thread coalesces everything
        arriving within ``batch_window_ms`` (or up to ``batch_cells``
        entries) into one flush and resolves each Future with its
        :class:`SimResult`.

        ``timeout_ms`` (default: the server's ``submit_timeout_ms``)
        bounds the future: if it is still pending past the deadline --
        queued behind a dead daemon, or inside a wedged flush -- the
        watchdog fails it with a :class:`TimeoutError` carrying the
        queue diagnostics instead of blocking the caller forever."""
        spec.validate(self.cluster)
        if timeout_ms is None:
            timeout_ms = self.submit_timeout_ms
        elif timeout_ms <= 0:
            raise ValueError(f"timeout_ms must be > 0, got {timeout_ms}")
        deadline = (time.monotonic() + timeout_ms / 1e3
                    if timeout_ms is not None else None)
        fut: Future = Future()
        with self._cond:
            if self._closed:
                raise RuntimeError("ScenarioServer is closed")
            # 4th slot: enqueue time, so the daemon can attribute queue
            # wait vs batching-window wait per entry (telemetry)
            self._queue.append((spec, fut, deadline, time.monotonic()))
            if self._worker is None or not self._worker.is_alive():
                self._start_worker_locked()
            self._cond.notify_all()
        return fut

    def _start_worker_locked(self) -> None:
        """Spawn the daemon (and its watchdog) -- caller holds _cond.
        Any spawn after the first replaces a dead worker, so it counts
        as a ``worker_restarts`` no matter which path noticed the body
        (the watchdog sweep or a racing ``submit``)."""
        if self._worker_spawned:
            self._wd_stats["worker_restarts"] += 1
        self._worker_spawned = True
        self._worker = threading.Thread(
            target=self._serve_loop, name="scenario-server", daemon=True)
        self._worker.start()
        if self._watchdog is None or not self._watchdog.is_alive():
            self._watchdog = threading.Thread(
                target=self._watchdog_loop, name="scenario-server-watchdog",
                daemon=True)
            self._watchdog.start()

    def _on_device(self):
        """Make the server's first placement current in this thread (a
        thread starts on CUDA device 0 whatever its creator's device
        was); each placement's launches make their own card current
        around them (``engine.launch_tile``)."""
        return _engine._on_card(self.device)

    def _serve_loop(self) -> None:
        with self._on_device():
            self._serve_loop_body()

    def _serve_loop_body(self) -> None:
        try:
            while True:
                with self._cond:
                    while not self._queue and not self._closed:
                        self._cond.wait()
                    if not self._queue:          # closed and drained
                        return
                    # chaos kill point BEFORE the queue is popped: a
                    # killed daemon leaves every pending entry intact
                    # for the respawned worker (or close()) to serve
                    st = _chaos.active()
                    if st is not None:
                        st.on_thread("daemon")
                    # batching window: linger for stragglers so
                    # concurrent submitters share one flush instead of
                    # paying one each
                    t_win0 = time.monotonic()
                    deadline = t_win0 + self.batch_window_ms / 1e3
                    while (not self._closed
                           and len(self._queue) < self.batch_cells):
                        left = deadline - time.monotonic()
                        if left <= 0:
                            break
                        self._cond.wait(left)
                    # expired/cancelled futures never reach a flush
                    batch = [e for e in self._queue if not e[1].done()]
                    self._queue.clear()
                    now = time.monotonic()
                    self._flush_started = now
                    self._flush_batch = batch
                    rec = _tm.active()
                    if rec is not None and batch:
                        # batching-window linger, plus each entry's time
                        # spent queued before this flush picked it up
                        rec.observe("serve/window_wait_ms",
                                    (now - t_win0) * 1e3)
                        for e in batch:
                            if len(e) > 3:
                                rec.observe("serve/queue_wait_ms",
                                            (now - e[3]) * 1e3)
                if not batch:
                    continue
                with self._lock:
                    self._stats["batches"] += 1
                try:
                    results = self.query_batch([e[0] for e in batch])
                except BaseException as e:   # surface to every waiter
                    for entry in batch:
                        if not entry[1].done():
                            entry[1].set_exception(e)
                    continue
                finally:
                    with self._cond:
                        self._flush_started = None
                        self._flush_batch = []
                        self._wedged = False
                for entry, res in zip(batch, results):
                    if not entry[1].done():
                        entry[1].set_result(res)
        except ThreadDeathError:
            pass          # injected death: the watchdog/submit respawns
        finally:
            with self._cond:
                if self._worker is threading.current_thread():
                    self._worker = None
                self._flush_started = None
                self._flush_batch = []
                self._wedged = False
                self._cond.notify_all()

    def _watchdog_loop(self) -> None:
        """Liveness sidecar of the serve loop (runs whenever a worker
        does; only ever takes _cond). Three duties: fail futures past
        their ``submit`` deadline with a diagnostic; respawn a daemon
        thread that died with work queued; fail a wedged flush's
        futures after ``watchdog_ms`` so callers never block on a hung
        device instead of an answer."""
        while True:
            with self._cond:
                if self._closed and not self._queue \
                        and self._flush_started is None:
                    self._watchdog = None
                    return
                now = time.monotonic()
                expired = [e for e in self._queue
                           if e[2] is not None and now > e[2]]
                for e in expired:
                    self._queue.remove(e)
                    self._wd_stats["submit_timeouts"] += 1
                    if not e[1].done():
                        e[1].set_exception(TimeoutError(
                            f"submit({e[0].workload!r}, {e[0].config!r}) "
                            f"timed out awaiting flush (queue depth "
                            f"{len(self._queue)}, daemon "
                            f"{'alive' if self._worker is not None else 'dead'})"))
                # a deadline can also expire mid-flush (entry already
                # popped into the in-flight batch but the flush is stuck
                # behind a wedged device/lock) -- fail the future in
                # place; the serve loop's set_result is done()-guarded
                for e in self._flush_batch:
                    if e[2] is not None and now > e[2] and not e[1].done():
                        self._wd_stats["submit_timeouts"] += 1
                        e[1].set_exception(TimeoutError(
                            f"submit({e[0].workload!r}, {e[0].config!r}) "
                            f"timed out mid-flush (flush running "
                            f"{(now - (self._flush_started or now)) * 1e3:.0f}"
                            f" ms, batch of {len(self._flush_batch)})"))
                if self._queue and (self._worker is None
                                    or not self._worker.is_alive()):
                    self._start_worker_locked()
                if (self.watchdog_ms is not None
                        and self._flush_started is not None
                        and (now - self._flush_started) * 1e3
                        > self.watchdog_ms):
                    stuck = self._flush_batch
                    self._flush_started = None
                    self._flush_batch = []
                    self._wedged = True
                    self._wd_stats["watchdog_flush_failures"] += 1
                    for e in stuck:
                        if not e[1].done():
                            e[1].set_exception(TimeoutError(
                                f"serve flush exceeded watchdog_ms="
                                f"{self.watchdog_ms} (daemon wedged; "
                                f"{len(stuck)} queries failed)"))
                if self._wedged:
                    # queued behind the wedged flush: nothing serves
                    # them until it returns, so each fails once it has
                    # waited watchdog_ms, as the flush's own did
                    late = [e for e in self._queue
                            if (now - e[3]) * 1e3 > self.watchdog_ms]
                    for e in late:
                        self._queue.remove(e)
                        if not e[1].done():
                            e[1].set_exception(TimeoutError(
                                f"submit({e[0].workload!r}, "
                                f"{e[0].config!r}) queued behind a flush "
                                f"that exceeded watchdog_ms="
                                f"{self.watchdog_ms} (daemon wedged)"))
                self._cond.wait(0.02)

    # -- observability -----------------------------------------------------

    def stats(self) -> Dict[str, object]:
        """Serve counters plus derived state: ``hit_ratio`` (lane-cache
        hits over queries), ``lanes_cached``, bank geometry
        (``bank_rows`` real rows, ``bank_bytes`` -- the cost of one
        COLD full-bank upload, the baseline the marginal ``h2d_bytes``
        is measured against -- ``bank_capacity`` as ``(trace rows,
        per-shard local wv rows)``, and MEASURED resident device bytes
        ``bank_dev_bytes`` / ``bank_dev_bytes_per_shard`` summed from
        the live capacity tensors, in all and the most on one placement
        -- on one placement the two agree), the
        LRU counters
        (``lane_evictions`` / ``bank_compactions``), and ``pending``
        queue depth.

        The returned dict is a DEEP-COPIED snapshot taken under the
        server lock: callers can hold it across later queries (or
        mutate it) without ever observing -- or perturbing -- the live
        counters mid-update. When telemetry is on
        (:mod:`repro_torch.core.telemetry`), a
        ``"telemetry"`` sub-dict carries the flight-recorder summary
        (per-stage span histograms incl. ``serve/query_ms`` p50/p99,
        queue/window waits, protocol counters)."""
        with self._lock:
            st: Dict[str, object] = copy.deepcopy(self._stats)
            q = self._stats["queries"]
            st["hit_ratio"] = self._stats["lane_hits"] / q if q else 0.0
            st["lanes_cached"] = len(self._lanes)
            st["bank_rows"] = self._bank.n_rows if self._bank else 0
            st["bank_bytes"] = self._bank.nbytes if self._bank else 0
            st["bank_capacity"] = self._cap
            st["dev_rows"] = self._dev_rows
            st["bank_partition"] = "sub"
            st["k_replicas"] = self.k_replicas
            st["journal_entries"] = (self._bank.journal_entries
                                     if self._bank is not None else 0)
            total, per = _engine._placement_bytes(
                self._parts() if self._dev is not None else ())
            st["bank_dev_bytes"] = total
            st["bank_dev_bytes_per_shard"] = per
        with self._cond:
            st["pending"] = len(self._queue)
            st.update(copy.deepcopy(self._wd_stats))
        rec = _tm.active()
        if rec is not None:
            st["telemetry"] = rec.summary()
        return st

    def reset_stats(self) -> None:
        """Zero the counters (bank, lane cache and tile programs
        stay hot) -- benchmarks call this after :meth:`warm` so the
        reported ratios describe live traffic only."""
        with self._lock:
            for k in self._stats:
                self._stats[k] = 0
