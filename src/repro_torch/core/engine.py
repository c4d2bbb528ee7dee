"""Streaming mega-grid engine (the tier above ``simulate_batch``), one device.

``simulate_batch`` runs a whole grid as ONE banked scan: right up to a
few thousand cells. A mega-grid (>10^4 cells -- the full (workload x
config x N_r x bw x CN x SB) sensitivity space of Figs. 10/16-18, times
seeds) is streamed through this tier instead:

1. **Scan-lane dedup.** A timeline consumes exactly (arrivals row,
   max-plus row, SB depth), so cells sharing that triple are one scan
   lane; the 12 960-cell mega-grid scans 2 700 lanes and scatters each
   lane's outputs to its member cells.
2. **Tile scheduler** (:func:`plan_tiles`). Lanes are grouped by
   store-buffer depth, so every tile is SB-uniform, and cut into tiles
   of ``tile_cells`` lanes padded to canonical sizes. The geometry is
   the JAX package's exactly: at 50 000 stores a tile holds 160 lanes,
   and the mega-grid runs as 18 tiles.
3. **The columnar bank** (:class:`~repro_torch.core.simulator.TraceBank`)
   is placed on the device ONCE per grid; tiles ship two ``int32`` index
   vectors, and each tile program is one launch of the CUDA bank-scan
   kernel (:func:`repro_torch.kernels.bank_scan.bank_scan`), which
   gathers the rows itself. ``bank_partition="sub"`` places the
   per-shard sub-bank layout of the JAX package at one shard -- a
   ``(1, local_rows, n_stores)`` stack viewed as ``[0]`` --
   ``"replicated"`` the plain columns; both gather the same rows.
4. **Double-buffered streaming.** A prefetch thread prepares tile k+1's
   host payload while tile k is launched; launches run ahead of the
   device by at most :data:`MAX_IN_FLIGHT_TILES` tiles before the oldest
   is drained (the ``.cpu()`` of its outputs).

:func:`simulate_grid` is the tier selector: grids below
:data:`STREAM_THRESHOLD` cells go to the one-shot banked batch, larger
grids stream. Results are ``==`` to the JAX package's on every
``SimResult`` field but ``meta``. Not in this port yet (ROADMAP.md):
more than one shard, the stacked plane, the serial and per-step tiers,
and the chaos / retry hooks -- they raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.recxl_paper import ClusterConfig, PAPER_CLUSTER
from repro_torch.core import telemetry as _tm
from repro_torch.core.simulator import (
    ScenarioSpec,
    SimResult,
    _finish_result,
    _pad_len,
    _plane_keys,
    _prepare_cell,
    _trace_cached,
    auto_chunk,
    bank_row_maps,
    get_trace_bank,
    register_cache_clearer,
    simulate_batch,
    sub_bank_rows,
)
from repro_torch.device import resolve_device
from repro_torch.kernels.bank_scan import bank_scan

#: Cells per tile (before canonical padding) at the default byte budget.
DEFAULT_TILE_CELLS = 1024

#: Byte budget for one tile's per-store inputs (~17 bytes per
#: cell-store in the JAX package's stacked plane). Long traces shrink the
#: tile cell count: at 50 000 stores a tile holds 157 cells, aligned to
#: 160. Kept so the tile geometry matches the JAX package's.
DEFAULT_TILE_BYTES = 128 << 20


def _default_tile_cells(n_stores: int) -> int:
    per_cell = max(1, 17 * n_stores)
    return int(min(DEFAULT_TILE_CELLS,
                   max(64, DEFAULT_TILE_BYTES // per_cell)))


#: Grid size at which ``simulate_grid(engine="auto")`` switches from the
#: one-shot banked batch to the streaming tier.
STREAM_THRESHOLD = 2048

#: Launched-but-undrained tile bound: past it the loop drains the oldest
#: tile, which caps live device memory at the bank plus a few tiles.
MAX_IN_FLIGHT_TILES = 3

#: Where each unported part of the JAX package's engine is queued.
_NOT_PORTED = "not ported yet (see the port queue in ROADMAP.md)"


@dataclasses.dataclass(frozen=True)
class TileSignature:
    """Everything that selects a tile program.

    ``b_pad`` is the canonical padded lane count, ``chunk`` the
    blocked-scan block length (reported, no result depends on it),
    ``sb_uniform`` the tile's SB depth, ``sb_max`` its padded ring width,
    ``n_shards`` the shard count (1 in this port), ``data_plane`` the
    input plane, ``bank_shape`` the ``(trace_rows, wv_rows)`` of the
    grid's bank (local rows under ``bank_sub``), and ``bank_sub`` the
    per-shard sub-bank layout. Equal to the JAX package's signature for
    the same tile.
    """
    b_pad: int
    n_stores: int
    chunk: int
    sb_max: int
    sb_uniform: int
    n_shards: int
    data_plane: str = "stacked"
    bank_shape: Tuple[int, int] = (0, 0)
    bank_sub: bool = False


@dataclasses.dataclass(frozen=True)
class Tile:
    """One scheduled slice of a grid: original positions + specs + sig.

    ``slots`` (sub-bank scheduling over several shards only) maps entry
    ``j`` of ``indices``/``specs`` to its padded position in the tile's
    index vectors and outputs; ``None`` means entry ``j`` at position
    ``j``."""
    indices: Tuple[int, ...]
    specs: Tuple[ScenarioSpec, ...]
    sig: TileSignature
    slots: Optional[Tuple[int, ...]] = None


def _align(n_shards: int) -> int:
    """Cell-count alignment: a multiple of 8 and of the shard count."""
    return 8 * n_shards // math.gcd(8, n_shards)


def _canonical_sizes(tile_cells: int, align: int) -> List[int]:
    """The canonical padded cell counts: the full tile and a 1/8 tile
    (rounded up to ``align``). Ragged last tiles pad UP to the smallest
    canonical size that fits."""
    small = -(-max(1, tile_cells // 8) // align) * align
    return sorted({small, tile_cells})


def plan_tiles(specs: Sequence[ScenarioSpec],
               cluster: ClusterConfig = PAPER_CLUSTER,
               n_stores: int = 50_000,
               chunk_size: Optional[int] = None,
               tile_cells: int = DEFAULT_TILE_CELLS,
               n_shards: int = 1,
               small_pad: bool = True,
               owners: Optional[Sequence[int]] = None) -> List[Tile]:
    """Schedule a grid into canonically-shaped, SB-uniform tiles.

    Cells are grouped by resolved store-buffer depth (preserving order
    within a group -- results are scattered back to original positions
    by :func:`run_grid`), and each group is cut into ``tile_cells``-sized
    tiles padded to canonical sizes. ``small_pad=False`` drops the
    1/8-tile canonical size, so every tile pads to the full tile (the
    banked plane's choice).

    ``owners`` (sub-bank scheduling) gives each cell's owning shard
    (``wv_row % n_shards``): with ``n_shards > 1`` each tile's index
    vector is laid out as ``n_shards`` blocks of ``b_pad // n_shards``
    slots and every lane lands in its owner's block, recorded in
    :attr:`Tile.slots`. Same tiles, indices and signatures as the JAX
    package's ``plan_tiles`` on the same arguments.
    """
    align = _align(n_shards)
    tile_cells = max(align, -(-tile_cells // align) * align)
    sizes = _canonical_sizes(tile_cells, align) if small_pad \
        else [tile_cells]

    groups: Dict[int, List[Tuple[int, ScenarioSpec]]] = {}
    for i, s in enumerate(specs):
        sb = s.sb_size if s.sb_size is not None else cluster.store_buffer
        groups.setdefault(sb, []).append((i, s))

    tiles: List[Tile] = []
    for sb, members in groups.items():
        chunk = auto_chunk(n_stores, sb, tile_cells) if chunk_size is None \
            else max(1, min(chunk_size, n_stores, sb))

        def sig_for(b_pad: int) -> TileSignature:
            return TileSignature(b_pad=b_pad, n_stores=n_stores, chunk=chunk,
                                 sb_max=_pad_len(sb), sb_uniform=sb,
                                 n_shards=n_shards)

        if owners is not None and n_shards > 1:
            by_shard: List[List[Tuple[int, ScenarioSpec]]] = \
                [[] for _ in range(n_shards)]
            for i, s in members:
                by_shard[owners[i]].append((i, s))
            block = tile_cells // n_shards
            n_tiles = max(1, -(-max(len(b) for b in by_shard) // block))
            for t in range(n_tiles):
                part: List[Tuple[int, ScenarioSpec]] = []
                blocks = [b[t * block:(t + 1) * block] for b in by_shard]
                widest = max(len(b) for b in blocks)
                b_pad = next(c for c in sizes if c // n_shards >= widest)
                per = b_pad // n_shards
                slots: List[int] = []
                for sh, blk in enumerate(blocks):
                    for q, (i, s) in enumerate(blk):
                        part.append((i, s))
                        slots.append(sh * per + q)
                tiles.append(Tile(indices=tuple(i for i, _ in part),
                                  specs=tuple(s for _, s in part),
                                  sig=sig_for(b_pad), slots=tuple(slots)))
            continue
        for off in range(0, len(members), tile_cells):
            part = members[off:off + tile_cells]
            b_pad = next(c for c in sizes if c >= len(part))
            tiles.append(Tile(indices=tuple(i for i, _ in part),
                              specs=tuple(s for _, s in part),
                              sig=sig_for(b_pad)))
    return tiles


# ---------------------------------------------------------------------------
# Signature-keyed tile programs
# ---------------------------------------------------------------------------

_TILE_FNS: Dict[TileSignature, Callable] = {}
_TRACE_COUNT = 0


def trace_count() -> int:
    """Tile-program builds since import (monotone; one per distinct
    :class:`TileSignature` until ``clear_sim_caches()``)."""
    return _TRACE_COUNT


_BANK_STATS: Dict[str, object] = {}


def bank_stats() -> Dict[str, object]:
    """Data-plane accounting of the most recent :func:`run_grid` call.

    Keys: ``data_plane``, ``cells``, ``n_shards``, ``bank_partition``,
    ``scan_lanes`` (unique timelines scanned), ``tiles``, ``trace_rows``
    / ``wv_rows`` / ``bank_rows`` (deduplicated bank columns),
    ``bank_bytes`` (host bytes of one bank copy),
    ``bank_dev_bytes`` / ``bank_dev_bytes_per_shard`` (**measured**
    bytes of the placed tensors), ``h2d_bytes`` (bytes that crossed
    host->device this run: the bank iff it was not already resident,
    plus every tile's index vectors), ``stacked_h2d_bytes`` (what a
    stacked per-cell plane would ship), ``dedup_ratio`` (their ratio),
    ``dev_mem_hwm_bytes`` (resident bank plus the in-flight tiles'
    index vectors at their peak), ``k_replicas`` (1). Empty until the
    first ``run_grid`` of the process."""
    return dict(_BANK_STATS)


def _build_bank_tile_fn(sig: TileSignature) -> Callable:
    """Banked tile program: one bank-scan launch over the
    device-resident bank for the tile's two index vectors.

    ``sig.bank_sub`` selects the per-shard sub-bank layout: the three
    max-plus planes arrive stacked ``(n_shards, local_rows, n_stores)``
    and ``[0]`` is the (only) shard's local sub-bank, with wv indices
    already local. Gathering a local row moves the identical bits the
    global gather would, so both layouts are ``==``."""
    global _TRACE_COUNT
    _TRACE_COUNT += 1

    def run(a_bank, w_bank, v_bank, p_bank, trace_idx, wv_idx):
        if sig.bank_sub:
            w_bank, v_bank, p_bank = w_bank[0], v_bank[0], p_bank[0]
        return bank_scan(a_bank, w_bank, v_bank, p_bank, trace_idx, wv_idx,
                         chunk=sig.chunk, sb=sig.sb_uniform)

    return run


def _tile_fn(sig: TileSignature) -> Callable:
    fn = _TILE_FNS.get(sig)
    if fn is None:
        fn = _TILE_FNS.setdefault(sig, _build_bank_tile_fn(sig))
    return fn


@register_cache_clearer
def _clear_engine_caches() -> None:
    _TILE_FNS.clear()


def _stacked_plane_h2d(specs: Sequence[ScenarioSpec],
                       cluster: ClusterConfig, n_stores: int,
                       tile_cells: int, n_shards: int) -> int:
    """Bytes a stacked per-cell plane would ship for this grid (~17 B
    per cell-store plus two per-cell i32, tiled like :func:`plan_tiles`)
    -- the banked plane's ``dedup_ratio`` baseline, as in the JAX
    package."""
    align = _align(n_shards)
    tile_cells = max(align, -(-tile_cells // align) * align)
    sizes = _canonical_sizes(tile_cells, align)
    groups: Dict[int, int] = {}
    for s in specs:
        sb = s.sb_size if s.sb_size is not None else cluster.store_buffer
        groups[sb] = groups.get(sb, 0) + 1
    per_cell = 17 * n_stores + 8
    total = 0
    for m in groups.values():
        full, rem = divmod(m, tile_cells)
        total += full * tile_cells * per_cell
        if rem:
            total += next(c for c in sizes if c >= rem) * per_cell
    return total


# ---------------------------------------------------------------------------
# Double-buffered streaming executor
# ---------------------------------------------------------------------------

def run_grid(specs: Sequence[ScenarioSpec],
             cluster: ClusterConfig = PAPER_CLUSTER,
             n_stores: int = 50_000,
             chunk_size: Optional[int] = None,
             tile_cells: Optional[int] = None,
             n_shards: Optional[int] = None,
             data_plane: Optional[str] = None,
             bank_partition: Optional[str] = None,
             k_replicas: Optional[int] = None,
             worker_timeout_s: Optional[float] = None,
             device=None) -> List[SimResult]:
    """Stream a (mega-)grid through the banked tile engine on ``device``.

    ``device=None`` means CUDA (raises without one). Results come back
    in ``specs`` order, ``==`` to ``simulate_batch`` and to the JAX
    package on every field but ``meta``. ``chunk_size=None`` uses the
    :func:`~repro_torch.core.simulator.auto_chunk` pick per SB group;
    ``tile_cells`` defaults to the :data:`DEFAULT_TILE_BYTES` budget.
    ``bank_partition`` is ``"sub"`` (default: the per-shard sub-bank
    layout at one shard) or ``"replicated"``. ``n_shards`` other than 1,
    ``data_plane="stacked"``, ``k_replicas`` other than 1 and
    ``worker_timeout_s`` raise ``NotImplementedError``.

    The prefetch thread derives tile k+1's index vectors and prepared
    cells while tile k is launched; launches run ahead of the device by
    at most :data:`MAX_IN_FLIGHT_TILES` tiles, past which the oldest is
    drained. :func:`bank_stats` reports the run's accounting. With
    telemetry on, the spans ``bank/build``, ``bank/place``,
    ``tile/prep``, ``tile/h2d``, ``tile/dispatch`` and ``tile/drain``
    split the run.
    """
    dev = resolve_device(device)
    if not specs:
        return []
    if chunk_size is not None and chunk_size < 1:
        raise ValueError(
            f"chunk_size must be >= 1 (or None for auto), got {chunk_size}")
    plane = data_plane or "bank"
    if plane not in ("bank", "stacked"):
        raise ValueError(f"unknown data_plane {data_plane!r}")
    partition = bank_partition or "sub"
    if partition not in ("sub", "replicated"):
        raise ValueError(f"unknown bank_partition {bank_partition!r}")
    if plane == "stacked":
        raise NotImplementedError(f"data_plane='stacked': {_NOT_PORTED}")
    if n_shards not in (None, 1):
        raise NotImplementedError(f"n_shards={n_shards}: one device only; "
                                  f"logical shards are {_NOT_PORTED}")
    if k_replicas not in (None, 1) or worker_timeout_s is not None:
        raise NotImplementedError(
            f"k_replicas / worker_timeout_s (chaos and recovery): "
            f"{_NOT_PORTED}")
    n_shards = 1
    for s in specs:
        s.validate(cluster)

    tile_cells = tile_cells or _default_tile_cells(n_stores)
    # --- scan-lane dedup: a timeline consumes exactly (arrivals row,
    # max-plus row, SB depth), so cells sharing that triple are one lane
    lane_of: Dict[tuple, int] = {}
    lane_specs: List[ScenarioSpec] = []
    lane_members: List[List[int]] = []
    for i, s in enumerate(specs):
        sb = s.sb_size if s.sb_size is not None else cluster.store_buffer
        key = (sb,) + _plane_keys(s, cluster)
        j = lane_of.setdefault(key, len(lane_specs))
        if j == len(lane_specs):
            lane_specs.append(s)
            lane_members.append([i])
        else:
            lane_members[j].append(i)
    trace_map, wv_map = bank_row_maps(specs, cluster)
    sub = partition == "sub"
    shape = (len(trace_map),
             sub_bank_rows(len(wv_map), n_shards) if sub else len(wv_map))
    tiles = [dataclasses.replace(
        t, sig=dataclasses.replace(t.sig, data_plane="bank",
                                   bank_shape=shape, bank_sub=sub))
        for t in plan_tiles(lane_specs, cluster=cluster, n_stores=n_stores,
                            chunk_size=chunk_size, tile_cells=tile_cells,
                            n_shards=n_shards, small_pad=False)]

    results: List[Optional[SimResult]] = [None] * len(specs)
    stacked_h2d = _stacked_plane_h2d(specs, cluster, n_stores, tile_cells,
                                     n_shards)
    h2d_bytes = sum(8 * t.sig.b_pad for t in tiles)

    with _tm.span("bank/build", cells=len(specs)):
        bank = get_trace_bank(specs, n_stores, cluster)
    with _tm.span("bank/place", rows=bank.n_rows):
        if sub:
            fresh, bank_dev = bank.sub_device_args(n_shards, device=dev)
        else:
            fresh, bank_dev = bank.device_args(device=dev)
    h2d_bytes += fresh
    bank_dev_bytes = sum(t.numel() * t.element_size() for t in bank_dev)
    live_bytes = hwm_bytes = bank_dev_bytes

    def prep(tile: Tile):
        """Prefetch-thread work for one tile: the two padded int32
        row-index vectors, plus the prepared member cells of each lane
        (the scatter targets). Padding slots stay 0 -- row 0 is a valid
        gather target and padding outputs are discarded."""
        trace_idx = np.zeros(tile.sig.b_pad, np.int32)
        wv_idx = np.zeros(tile.sig.b_pad, np.int32)
        # at one shard a sub-bank's local rows are the global rows
        for pos, s in enumerate(tile.specs):
            trace_idx[pos], wv_idx[pos] = bank.rows_for(s)
        groups = [[(i, _prepare_cell(
            specs[i], _trace_cached(specs[i].workload, n_stores,
                                    specs[i].seed, cluster),
            n_stores, cluster)) for i in lane_members[lane]]
            for lane in tile.indices]
        return groups, (trace_idx, wv_idx)

    def prep_spanned(tile: Tile, no: int):
        with _tm.span("tile/prep", tile=no):
            return prep(tile)

    def finish(entry) -> None:
        """Drain one launched tile: wait for its outputs (``.cpu()``)
        and scatter each lane's outputs to its member cells."""
        nonlocal live_bytes
        kt, tile, groups, outs = entry
        with _tm.span("tile/drain", tile=kt):
            exec_ns, at_head, sb_full = (o.cpu().numpy() for o in outs)
        live_bytes -= 8 * tile.sig.b_pad
        for pos, group in enumerate(groups):
            for i, cell in group:
                meta = {"engine": "streamed",
                        "chunk": tile.sig.chunk,
                        "auto_chunk": chunk_size is None,
                        "tile_cells": tile.sig.b_pad,
                        "n_shards": n_shards,
                        "data_plane": plane,
                        "bank_partition": partition,
                        "bank_rows": bank.n_rows,
                        "h2d_bytes": h2d_bytes,
                        "bank_fabric_bytes": 0}
                results[i] = _finish_result(cell, exec_ns[pos],
                                            int(at_head[pos]),
                                            int(sb_full[pos]), meta=meta)

    in_flight: List[tuple] = []
    with ThreadPoolExecutor(max_workers=1) as prep_pool:
        fut = prep_pool.submit(prep_spanned, tiles[0], 0)
        for kt, tile in enumerate(tiles):
            groups, np_idx = fut.result()
            if kt + 1 < len(tiles):
                fut = prep_pool.submit(prep_spanned, tiles[kt + 1], kt + 1)
            with _tm.span("tile/h2d", tile=kt):
                idx = tuple(torch.from_numpy(x).to(dev) for x in np_idx)
            with _tm.span("tile/dispatch", tile=kt):
                outs = _tile_fn(tile.sig)(*bank_dev, *idx)
            in_flight.append((kt, tile, groups, outs))
            _tm.gauge("engine/in_flight_tiles", len(in_flight))
            _tm.gauge("engine/prefetch_queue_depth", len(tiles) - kt - 1)
            live_bytes += 8 * tile.sig.b_pad
            hwm_bytes = max(hwm_bytes, live_bytes)
            # backpressure: launches run ahead of the device, so drain
            # the oldest tile once MAX_IN_FLIGHT_TILES are outstanding
            if len(in_flight) >= MAX_IN_FLIGHT_TILES:
                finish(in_flight.pop(0))
        while in_flight:
            finish(in_flight.pop(0))

    _BANK_STATS.clear()
    _BANK_STATS.update({
        "data_plane": plane, "cells": len(specs), "n_shards": n_shards,
        "bank_partition": partition, "scan_lanes": len(lane_members),
        "tiles": len(tiles),
        "trace_rows": bank.trace_rows, "wv_rows": bank.wv_rows,
        "bank_rows": bank.n_rows, "bank_bytes": bank.nbytes,
        "bank_dev_bytes_per_shard": bank_dev_bytes,
        "bank_dev_bytes": bank_dev_bytes,
        "h2d_bytes": h2d_bytes,
        "bank_fabric_bytes": 0,
        "stacked_h2d_bytes": stacked_h2d,
        "dedup_ratio": stacked_h2d / max(h2d_bytes, 1),
        "dev_mem_hwm_bytes": hwm_bytes,
        "k_replicas": 1,
    })
    rec = _tm.active()
    if rec is not None:
        # one merged per-run summary, shared between bank_stats() and
        # every cell's meta
        summ = rec.summary()
        _BANK_STATS["telemetry"] = summ
        for r in results:
            if r is not None and r.meta is not None:
                r.meta.setdefault("telemetry", summ)
    return results


# ---------------------------------------------------------------------------
# Tier selection
# ---------------------------------------------------------------------------

def simulate_grid(specs: Sequence[ScenarioSpec],
                  cluster: ClusterConfig = PAPER_CLUSTER,
                  n_stores: int = 50_000,
                  engine: str = "auto",
                  chunk_size: Optional[int] = None,
                  tile_cells: Optional[int] = None,
                  n_shards: Optional[int] = None,
                  data_plane: Optional[str] = None,
                  bank_partition: Optional[str] = None,
                  k_replicas: Optional[int] = None,
                  worker_timeout_s: Optional[float] = None,
                  device=None) -> List[SimResult]:
    """Run a scenario grid on the right engine tier, on ``device``.

    ``engine``: ``"auto"`` (default) -- the one-shot banked batch below
    :data:`STREAM_THRESHOLD` cells, the streaming tier at or above it;
    ``"blocked"`` -- ``simulate_batch``; ``"stream"`` --
    :func:`run_grid`. ``"serial"`` and ``"perstep"`` raise
    ``NotImplementedError``. ``device=None`` means CUDA (raises
    without one). All tiers return ``==`` results in ``specs`` order;
    ``SimResult.meta`` records what actually ran.
    """
    dev = resolve_device(device)
    if engine == "auto":
        engine = "stream" if len(specs) >= STREAM_THRESHOLD else "blocked"
    if bank_partition is not None and engine != "stream":
        raise ValueError(
            f"bank_partition applies to the stream tier only, not {engine!r}")
    if (k_replicas is not None or worker_timeout_s is not None) \
            and engine != "stream":
        raise ValueError("k_replicas / worker_timeout_s apply to the "
                         f"stream tier only, not {engine!r}")
    if engine in ("serial", "perstep"):
        raise NotImplementedError(f"engine={engine!r}: {_NOT_PORTED}")
    if engine == "blocked":
        return simulate_batch(specs, cluster=cluster, n_stores=n_stores,
                              chunk_size=chunk_size, data_plane=data_plane,
                              device=dev)
    if engine == "stream":
        return run_grid(specs, cluster=cluster, n_stores=n_stores,
                        chunk_size=chunk_size, tile_cells=tile_cells,
                        n_shards=n_shards, data_plane=data_plane,
                        bank_partition=bank_partition,
                        k_replicas=k_replicas,
                        worker_timeout_s=worker_timeout_s, device=dev)
    raise ValueError(f"unknown engine {engine!r}")
