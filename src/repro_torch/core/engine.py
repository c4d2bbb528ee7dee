"""Streaming mega-grid engine (the tier above ``simulate_batch``).

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
   and the mega-grid runs as 18 tiles at one shard.
3. **Two data planes.** The columnar bank
   (:class:`~repro_torch.core.simulator.TraceBank`, the default) is
   placed on the device ONCE per grid; tiles ship two ``int32`` index
   vectors, and each tile program is one launch of the CUDA bank-scan
   kernel (:func:`repro_torch.kernels.bank_scan.bank_scan`), which
   gathers the rows itself. The stacked plane (``data_plane="stacked"``,
   the measured baseline) ships every cell's five per-store arrays,
   stacked cell-major on the host; its tile program collapses them on
   the device and scans them with the same kernel, one launch per tile.
4. **Shards on one placement or one placement each.** ``n_shards``
   partitions the banked plane the way the JAX package partitions it
   over a ``cells`` mesh, and ``devices``
   (:func:`~repro_torch.distributed.context.cells_devices`) says where
   the shards lie. ``bank_partition="sub"`` (the default) gives wv row
   ``r`` to shard ``r % n_shards`` at local row ``r // n_shards`` and
   schedules every lane into its owner's slot block
   (``plan_tiles(owners=...)``). On ONE placement (the default) the
   per-shard stacks ``(n_shards, k * local_rows, n_stores)`` lie
   contiguous on the device, the host writes each slot's flat row
   ``owner * k * local_rows + local`` into the index vector, and a tile
   is one kernel launch at any shard count. On ``n_shards`` placements
   -- the JAX layout, ``devices[s]`` holding shard ``s``'s ``(1, k *
   local_rows, n_stores)`` stacks and a copy of the arrivals -- a tile's
   index vectors split into the shards' slot blocks, each with its local
   rows, and the tile is one launch per placement, all launched before
   any is drained. ``"replicated"`` keeps one copy of the plain columns
   per placement and lanes in cell blocks. Every layout gathers the
   same bits.
5. **Double-buffered streaming.** A prefetch thread prepares tile k+1's
   host payload while tile k is launched; launches run ahead of the
   device by at most :data:`MAX_IN_FLIGHT_TILES` tiles before the oldest
   is drained (the ``.cpu()`` of its outputs). A compile-warm thread
   builds every tile program and loads the kernel library meanwhile.
6. **Resilience.** Under an active :func:`repro_torch.core.chaos.inject`
   scope the loop detects injected shard loss, corrupt rows, failed
   uploads and dead worker threads, and recovers in place: in-flight
   tiles are cancelled, the lost shard's rows are rebuilt from the
   surviving replica block (``k_replicas=2``) or the bank's Logging-Unit
   journal, digest-verified, and re-placed at the same shapes -- zero
   new tile programs -- or, with ``recovery="degraded"``, the unfinished
   cells finish on one shard fewer with a replicated bank.

:func:`simulate_grid` is the tier selector: grids below
:data:`STREAM_THRESHOLD` cells go to the one-shot banked batch, larger
grids stream; ``engine="serial"`` and ``"perstep"`` run the serial
oracle and the per-step engine. Results are ``==`` to the JAX package's
on every ``SimResult`` field but ``meta``, at every shard count.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import wait as _futures_wait
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.recxl_paper import ClusterConfig, PAPER_CLUSTER
from repro_torch.core import chaos as _chaos
from repro_torch.core import telemetry as _tm
from repro_torch.core.chaos import (
    ChaosError,
    IntegrityError,
    ShardLossError,
    ThreadDeathError,
    UploadError,
)
from repro_torch.core.retry import PLACEMENT_RETRY, retry_call
from repro_torch.core.simulator import (
    ScenarioSpec,
    SimResult,
    TraceBank,
    _CellInputs,
    _blocked_precompute,
    _commit_cost_ns,
    _finish_result,
    _pad_len,
    _plane_keys,
    _prepare_cell,
    _trace_cached,
    auto_chunk,
    bank_row_maps,
    columns_key,
    get_trace_bank,
    register_cache_clearer,
    simulate_batch,
    simulate_spec,
    sub_bank_rows,
    sub_key,
)
from repro_torch.device import resolve_device
from repro_torch.distributed.context import cells_devices
from repro_torch.kernels.bank_scan import bank_scan
from repro_torch.kernels.bank_scan import kernel as _bank_scan_kernel

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

#: Spare-replacement recovery attempts per :func:`run_grid` call before
#: the fault propagates (a second independent failure mid-recovery is
#: out of the modeled scope).
MAX_RECOVERIES = 3

#: Gather-path integrity sampling cap: at most this many of a tile's wv
#: rows are CRC-checked against the host bank before its launch (only
#: under an active chaos scope that wants verification -- see
#: ``chaos.ChaosConfig.verify_rows``; the production path never reads
#: rows back).
VERIFY_ROWS_PER_TILE = 16


class EngineWorkerError(RuntimeError):
    """A streaming-engine worker thread (prefetch / compile-warm)
    failed or stalled. Carries the tile / signature context so the
    caller sees *which* unit of work died instead of a bare exception
    surfacing tiles later (or, for a stalled worker, never)."""

    def __init__(self, stage: str, tile_no: Optional[int],
                 sig: Optional["TileSignature"] = None, note: str = ""):
        msg = f"{stage} worker failed"
        if tile_no is not None:
            msg += f" on tile {tile_no}"
        if sig is not None:
            msg += (f" (sig: b_pad={sig.b_pad} sb={sig.sb_uniform}"
                    f" chunk={sig.chunk} plane={sig.data_plane})")
        if note:
            msg += f": {note}"
        super().__init__(msg)
        self.stage = stage
        self.tile_no = tile_no
        self.sig = sig


_HEARTBEATS: Dict[str, float] = {}


def worker_heartbeats() -> Dict[str, float]:
    """``time.monotonic()`` of each engine worker thread's last unit of
    work (``"prefetch"`` / ``"compile-warm"``) -- the liveness signal
    ``run_grid(worker_timeout_s=...)`` and external watchdogs check a
    stalled worker against."""
    return dict(_HEARTBEATS)


def _h2d_hook(nbytes: int = 0) -> None:
    """Chaos injection point for one host->device placement (no-op
    without an active scope)."""
    st = _chaos.active()
    if st is not None:
        st.on_upload(nbytes)


def _retried(fn: Callable[[], object], describe: str):
    """Bounded jittered retry around a placement/dispatch callable:
    only a transient :class:`~repro_torch.core.chaos.UploadError` is
    retried -- shard loss and integrity faults must reach the recovery
    path."""
    st = _chaos.active()
    return retry_call(fn, policy=PLACEMENT_RETRY, retryable=(UploadError,),
                      describe=describe,
                      on_retry=st.note_retry if st is not None else None)


@dataclasses.dataclass(frozen=True)
class TileSignature:
    """Everything that selects a tile program.

    ``b_pad`` is the canonical padded lane count, ``chunk`` the
    blocked-scan block length (reported, no result depends on it),
    ``sb_uniform`` the tile's SB depth, ``sb_max`` its padded ring width,
    ``n_shards`` the shard count, ``data_plane`` the input plane,
    ``bank_shape`` the ``(trace_rows, wv_rows)`` of the grid's bank --
    under ``bank_sub`` the second entry is the local axis of one shard's
    stack, ``k_replicas * local_rows`` -- and ``bank_sub`` the per-shard
    sub-bank layout. Equal to the JAX package's signature for the same
    tile.
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
    index vectors and outputs: ``n_shards`` contiguous blocks of ``b_pad
    // n_shards`` slots, lane ``j`` inside the block of the shard owning
    its wv row. ``None`` means entry ``j`` at position ``j``."""
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
    :class:`TileSignature` until ``clear_sim_caches()``). The port's
    count of "compiles": tests pin that it does not grow across
    same-signature tiles, a spare-path recovery or steady-state
    serving."""
    return _TRACE_COUNT


_BANK_STATS: Dict[str, object] = {}


def bank_stats() -> Dict[str, object]:
    """Data-plane accounting of the most recent :func:`run_grid` call.

    Keys: ``data_plane``, ``cells``, ``n_shards``, ``bank_partition``,
    ``scan_lanes`` (unique timelines scanned), ``tiles``, ``trace_rows``
    / ``wv_rows`` / ``bank_rows`` (deduplicated bank columns),
    ``bank_bytes`` (host bytes of one bank copy), ``bank_dev_bytes``
    (**measured** bytes of the placed tensors, summed over placements)
    and ``bank_dev_bytes_per_shard`` (the most on one placement: on one
    placement, the same number), ``h2d_bytes`` (bytes that crossed
    host->device this run: the bank iff it was not already resident,
    plus every tile's index vectors), ``bank_fabric_bytes``
    (device-to-device copies between placements: 0 on one placement),
    ``placements`` (1, or ``n_shards``), ``stacked_h2d_bytes`` (what a stacked
    per-cell plane would ship), ``dedup_ratio`` (their ratio),
    ``dev_mem_hwm_bytes`` (resident bank plus the in-flight tiles'
    payloads at their peak), ``k_replicas`` (replica blocks of the sub
    stacks), ``degraded`` (the run finished on one shard fewer) and
    ``chaos`` (the active chaos scope's report, or ``None``). Empty until
    the first ``run_grid`` of the process."""
    return dict(_BANK_STATS)


def _build_bank_tile_fn(sig: TileSignature) -> Callable:
    """Banked tile program: one bank-scan launch over one placement's
    device-resident bank for its two index vectors. The engine calls it
    once per placement of a tile: once on one placement, once per shard
    over ``n_shards`` placements (the JAX package's ``shard_map`` over
    the ``cells`` mesh, ``src/repro/core/engine.py:527``; the axis
    runs no collectives, so neither does the port).

    ``sig.bank_sub`` selects the per-shard sub-bank layout: the three
    max-plus planes arrive stacked ``(shards, k * local_rows,
    n_stores)`` -- every shard's on one placement, a shard's own ``(1,
    ...)`` on its placement -- and the program gathers from their flat
    view ``(shards * k * local_rows, n_stores)``; the host has written
    each wv index as a row of that view (``owner * k * local_rows +
    local`` on one placement, ``local`` on a shard's own). Gathering a
    flat row moves the identical bits the global gather would, so every
    layout is ``==`` at any shard count."""
    global _TRACE_COUNT
    _TRACE_COUNT += 1

    def run(a_bank, w_bank, v_bank, p_bank, trace_idx, wv_idx):
        if sig.bank_sub:
            n = a_bank.shape[1]
            w_bank, v_bank, p_bank = (x.view(-1, n)
                                      for x in (w_bank, v_bank, p_bank))
        return bank_scan(a_bank, w_bank, v_bank, p_bank, trace_idx, wv_idx,
                         chunk=sig.chunk, sb=sig.sb_uniform)

    return run


def _build_tile_fn(sig: TileSignature) -> Callable:
    """The tile program of ``sig``: the banked one, or the stacked one --
    one placement's block of the tile's cell-major arrays collapsed into
    max-plus rows on its device
    (:func:`~repro_torch.core.simulator._blocked_precompute`), then one
    bank-scan launch with lane ``b`` reading row ``b``. The tile is
    SB-uniform, so ``sb_size`` is not read. Shards partition the lanes
    only (cell blocks, as the JAX package's ``tile_shardings`` do), so
    the stacked program does not depend on ``n_shards``."""
    if sig.data_plane == "bank":
        return _build_bank_tile_fn(sig)
    global _TRACE_COUNT
    _TRACE_COUNT += 1

    def run(arrivals, coalesce, exposed, t_repl_i, svc_i, config_idx,
            sb_size, t_l1, t_wt):
        w, v, pr_nc = _blocked_precompute(coalesce, exposed, t_repl_i,
                                          svc_i, config_idx, t_l1, t_wt)
        lanes = torch.arange(arrivals.shape[0], dtype=torch.int32,
                             device=arrivals.device)
        return bank_scan(arrivals, w, v, pr_nc, lanes, lanes,
                         chunk=sig.chunk, sb=sig.sb_uniform)

    return run


def _tile_fn(sig: TileSignature) -> Callable:
    fn = _TILE_FNS.get(sig)
    if fn is None:
        fn = _TILE_FNS.setdefault(sig, _build_tile_fn(sig))
    return fn


#: Public alias of the signature-keyed tile-program lookup. The
#: scenario-serving daemon (:mod:`repro_torch.core.serving`) batches
#: queries into the SAME canonical tile shapes as the streaming engine
#: and calls the programs through this entry, so steady-state serving
#: builds no program beyond those :meth:`ScenarioServer.warm` built
#: (``trace_count()`` counts serve-path builds too -- tests pin it).
tile_fn = _tile_fn


@register_cache_clearer
def _clear_engine_caches() -> None:
    _TILE_FNS.clear()


# ---------------------------------------------------------------------------
# Stacked-plane tiles
# ---------------------------------------------------------------------------

def _stack_tile(cells: List[_CellInputs], b_pad: int) -> tuple:
    """Stack one tile's cells **cell-major** ``(B, n_stores)``: a
    contiguous row memcpy per cell, and the rows the scan kernel reads.
    Padding repeats cell 0."""
    padded = cells + [cells[0]] * (b_pad - len(cells))
    return (
        np.stack([c.arrivals for c in padded], axis=0),
        np.stack([c.coalesce for c in padded], axis=0),
        np.stack([c.exposed for c in padded], axis=0),
        np.stack([c.t_repl_i for c in padded], axis=0),
        np.stack([c.svc_i for c in padded], axis=0),
        np.asarray([c.config_idx for c in padded], np.int32),
        np.asarray([c.sb_size for c in padded], np.int32),
    )


def _prep_tile(tile: Tile, n_stores: int, cluster: ClusterConfig
               ) -> Tuple[List[_CellInputs], tuple]:
    """Host-side prep for one stacked-plane tile (runs on the prefetch
    thread): ``_prepare_cell`` per cell + the cell-major stacking. The
    banked plane's prep lives in :func:`run_grid` (it needs the
    lane->cells map) and ships only index vectors."""
    cells = [_prepare_cell(s, _trace_cached(s.workload, n_stores, s.seed,
                                            cluster), n_stores, cluster)
             for s in tile.specs]
    return cells, _stack_tile(cells, tile.sig.b_pad)


def _place_tile(np_args: tuple, dev: torch.device) -> tuple:
    """Put one tile's host arrays on the device: the two index vectors
    of the banked plane, or the five stacked arrays plus the per-cell
    vectors of the stacked plane."""
    return tuple(torch.from_numpy(x).to(dev) for x in np_args)


def _place_blocks(np_args: tuple, placements: Sequence[torch.device]
                  ) -> List[tuple]:
    """One tile's host arrays placed block by block: placement ``d``
    gets rows ``[d * b, (d + 1) * b)`` of every array, ``b = b_pad /
    len(placements)`` -- its shard's slot block of the index vectors, or
    its cell block of the stacked arrays (the JAX package places the
    tile cell-sharded, ``src/repro/core/engine.py:591-605``). One
    placement gets the whole tile."""
    if len(placements) == 1:
        return [_place_tile(np_args, placements[0])]
    b = np_args[0].shape[0] // len(placements)
    return [_place_tile(tuple(x[d * b:(d + 1) * b] for x in np_args), dev)
            for d, dev in enumerate(placements)]


def _on_card(dev: torch.device):
    """Make ``dev`` the current CUDA device around one placement's
    launches (a no-op on the CPU)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def launch_tile(sig: "TileSignature", placed: Sequence[tuple],
                placements: Sequence[torch.device],
                bank_parts: Optional[Sequence[tuple]] = None,
                costs: Optional[Tuple[float, float]] = None) -> List[tuple]:
    """Launch ``sig``'s program once on every placement -- against
    placement ``d``'s resident bank (``bank_parts[d]``) or its stacked
    block (with ``costs = (t_l1, t_wt)``) -- before any is drained, so
    the placements' devices run at once (the JAX package's one
    ``shard_map`` call over the ``cells`` mesh,
    ``src/repro/core/engine.py:1225-1227``). Returns the per-placement
    output triples, in slot order."""
    fn = _tile_fn(sig)
    outs = []
    for d, dev in enumerate(placements):
        with _on_card(dev):
            outs.append(fn(*bank_parts[d], *placed[d])
                        if bank_parts is not None
                        else fn(*placed[d], *costs))
    return outs


def drain_tile(outs: Sequence[tuple]) -> Tuple[np.ndarray, ...]:
    """Wait for a launched tile's per-placement outputs (``.cpu()``,
    placement by placement, after all were launched) and join them in
    slot order: ``(exec_ns, at_head, sb_full)`` -- the JAX package's
    drain of a cells-sharded output (``src/repro/core/engine.py:983-988``)."""
    host = [[o.cpu().numpy() for o in out] for out in outs]
    if len(host) == 1:
        return tuple(host[0])
    return tuple(np.concatenate(cols) for cols in zip(*host))


def _stacked_tile_bytes(sig: TileSignature) -> int:
    """Host bytes of one stacked tile's payload (5 per-store arrays at
    17 B per cell-store + the two per-cell i32 vectors)."""
    return sig.b_pad * (17 * sig.n_stores + 8)


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


def _placement_bytes(parts: Sequence[Optional[tuple]]) -> Tuple[int, int]:
    """``(total, most on one placement)`` resident bytes of a placed
    bank's per-placement tensors, measured from the tensors (a freed
    placement holds none) -- the JAX package's
    ``_measured_device_bytes`` (``src/repro/core/engine.py:675-691``)
    per placement. On one placement the two agree."""
    per = [sum(t.numel() * t.element_size() for t in p) if p is not None
           else 0 for p in parts]
    return (sum(per), max(per)) if per else (0, 0)


def _build_programs(sigs: Sequence[TileSignature],
                    placements: Sequence[torch.device]) -> None:
    """Build the tile program of every signature and, with a CUDA
    placement, load the bank-scan kernel library (``nvcc`` at its first
    use) and bring up the context of every card of the placements, so
    none of it waits on the timed path. Launches nothing. Runs on the
    compile-warm thread, as the JAX package's warm calls do
    (``src/repro/core/engine.py:1031-1043``)."""
    for sig in sigs:
        _tile_fn(sig)
    cards = list(dict.fromkeys(d for d in placements if d.type == "cuda"))
    if cards:
        _bank_scan_kernel.load()
    for d in cards:
        torch.empty(1, device=d)


def warm_signatures(sigs: List[TileSignature], t_l1, t_wt,
                    bank_dev: Optional[tuple] = None,
                    device=None, devices=None) -> None:
    """Build every tile program of ``sigs`` and launch each once on
    every placement with zero inputs, so the first live call builds and
    loads nothing and no card sees its first launch there. Public: the
    scenario-serving daemon's
    :meth:`~repro_torch.core.serving.ScenarioServer.warm` calls it
    against its own resident bank. The placements are ``devices`` (one
    per shard; ``bank_dev`` then holds one placed bank per placement)
    or else ``device`` (``None`` means CUDA). Banked programs run on
    ``bank_dev`` with zero index vectors (row 0 is a valid gather target
    in every layout); stacked ones on zero tiles. The JAX package's
    ``warm_signatures`` is ``src/repro/core/engine.py:694``."""
    placements = (tuple(resolve_device(d) for d in devices)
                  if devices is not None else (resolve_device(device),))
    _build_programs(sigs, placements)
    parts = (bank_dev,) if len(placements) == 1 else bank_dev
    for sig in sigs:
        if sig.data_plane == "bank":
            idx = (np.zeros((sig.b_pad,), np.int32),
                   np.zeros((sig.b_pad,), np.int32))
            launch_tile(sig, _place_blocks(idx, placements), placements,
                        bank_parts=parts)
            continue
        args = (np.zeros((sig.b_pad, sig.n_stores), np.float32),
                np.zeros((sig.b_pad, sig.n_stores), bool),
                np.zeros((sig.b_pad, sig.n_stores), np.float32),
                np.zeros((sig.b_pad, sig.n_stores), np.float32),
                np.zeros((sig.b_pad, sig.n_stores), np.float32),
                np.zeros((sig.b_pad,), np.int32),
                np.full((sig.b_pad,), sig.sb_uniform, np.int32))
        launch_tile(sig, _place_blocks(args, placements), placements,
                    costs=(t_l1, t_wt))


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
             device=None, devices=None) -> List[SimResult]:
    """Stream a (mega-)grid through the tile engine.

    ``device=None`` means CUDA (raises without one). Results come back
    in ``specs`` order, ``==`` to ``simulate_batch``, to the serial
    oracle and to the JAX package at the same ``n_shards`` on every
    field but ``meta``. ``chunk_size=None`` uses the
    :func:`~repro_torch.core.simulator.auto_chunk` pick per SB group;
    ``tile_cells`` defaults to the :data:`DEFAULT_TILE_BYTES` budget.
    ``n_shards`` (default 1) is the number of ``cells`` shards;
    ``n_shards < 1`` raises ``ValueError``. ``devices`` places them
    (:func:`~repro_torch.distributed.context.cells_devices`): ``None``
    (the default) or one device keeps every shard on one placement,
    ``device``, and a tile is one launch; ``n_shards`` devices put shard
    ``s`` on ``devices[s]``, the JAX package's layout
    (``src/repro/core/engine.py:843-851``, whose default is every local
    device; the port's default pins one launch a tile), and a tile is
    one launch per placement over ``b_pad / n_shards`` lanes; another
    length raises ``ValueError``. The four byte keys of
    :func:`bank_stats` and ``meta["bank_fabric_bytes"]`` are then ``==``
    the JAX package's at the same ``n_shards``. ``data_plane`` is
    ``"bank"`` (default: the device-resident bank, index-vector tiles
    over unique scan lanes) or ``"stacked"`` (every cell's arrays
    shipped in cell-major tiles, the measured baseline);
    ``bank_partition`` (bank plane) is ``"sub"`` (default: per-shard
    sub-bank stacks, lanes scheduled onto their owner shard) or
    ``"replicated"`` (one copy of the columns, lanes in cell blocks).

    The prefetch thread prepares tile k+1's host payload (index vectors
    and prepared cells, or the stacked arrays) while tile k is launched,
    and a compile-warm thread builds the tile programs; launches run
    ahead of the device by at most :data:`MAX_IN_FLIGHT_TILES` tiles,
    past which the oldest is drained. :func:`bank_stats` reports the
    run's accounting. With telemetry on, the spans ``bank/build`` and
    ``bank/place`` (bank plane), ``compile/warm``, and ``tile/prep``,
    ``tile/h2d``, ``tile/dispatch`` and ``tile/drain`` split the run.

    **Resilience.** ``k_replicas`` widens the sub-bank stacks with the
    paper's Replica set (default: 2 under an active ``chaos.inject``
    scope, else 1); ``worker_timeout_s`` bounds how long the launch loop
    waits on a silent prefetch worker before raising
    :class:`EngineWorkerError`. Under an active chaos scope the loop
    detects injected shard loss / corrupt rows / upload faults / dead
    worker threads and recovers in place: in-flight tiles are cancelled,
    the lost shard's rows are rebuilt from the surviving replica block
    (or the bank's Logging-Unit journal), digest-verified against the
    host truth, and re-placed at the same shapes -- zero new tile
    programs, results ``==``. On one placement the bank is placed
    again; over placements the lost placement's tensors are freed
    first, the rebuild reads only the survivor's placement, and only the
    lost placement is placed again (a spare), so the byte keys then
    count one placement where the JAX package, which places the whole
    bank again, counts all. ``ChaosConfig(recovery="degraded")`` instead
    finishes the unfinished cells on one shard fewer with the bank
    replicated (one new program per SB group): over placements on the
    surviving ones, the lost one dropped, where the JAX package takes
    its first ``n - 1`` devices -- the results are ``==`` either way.
    """
    if n_shards is None:
        n_shards = 1
    placements = cells_devices(n_shards, devices, device)
    dev = placements[0]
    multi = len(placements) > 1
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
    if k_replicas is not None and k_replicas != 1 and \
            (plane != "bank" or partition != "sub"):
        raise ValueError("k_replicas > 1 applies to the sub-partitioned "
                         f"bank plane only (got plane={plane!r}, "
                         f"partition={partition!r})")
    for s in specs:
        s.validate(cluster)

    plan_kw = dict(cluster=cluster, n_stores=n_stores, chunk_size=chunk_size,
                   tile_cells=tile_cells or _default_tile_cells(n_stores),
                   n_shards=n_shards)
    bank: Optional[TraceBank] = None
    # one placed (arrivals, w, v, pr_nc) per placement
    bank_parts: tuple = ()
    sub = False
    k_eff = 1
    local_rows = 0
    lane_members: List[List[int]] = []
    if plane == "bank":
        # --- scan-lane dedup: a timeline consumes exactly (arrivals row,
        # max-plus row, SB depth), so cells sharing that triple are one
        # lane
        lane_of: Dict[tuple, int] = {}
        lane_specs: List[ScenarioSpec] = []
        lane_wv_keys: List[tuple] = []
        for i, s in enumerate(specs):
            sb = s.sb_size if s.sb_size is not None else cluster.store_buffer
            key = (sb,) + _plane_keys(s, cluster)
            j = lane_of.setdefault(key, len(lane_specs))
            if j == len(lane_specs):
                lane_specs.append(s)
                lane_wv_keys.append(key[2])
                lane_members.append([i])
            else:
                lane_members[j].append(i)
        trace_map, wv_map = bank_row_maps(specs, cluster)
        sub = partition == "sub"
        if sub:
            # per-shard sub-banks: the signature carries one shard's
            # local axis (k_eff replica blocks of local_rows), and the
            # scheduler places each lane in its wv row owner's slot block
            k_eff = _chaos.resolve_k_replicas(k_replicas, n_shards)
            local_rows = sub_bank_rows(len(wv_map), n_shards)
            shape = (len(trace_map), k_eff * local_rows)
            owners = [wv_map[wk] % n_shards for wk in lane_wv_keys]
        else:
            shape = (len(trace_map), len(wv_map))
            owners = None
        tiles = [dataclasses.replace(
            t, sig=dataclasses.replace(t.sig, data_plane="bank",
                                       bank_shape=shape, bank_sub=sub))
            for t in plan_tiles(lane_specs, small_pad=False, owners=owners,
                                **plan_kw)]
    else:
        tiles = plan_tiles(specs, **plan_kw)
    costs = _commit_cost_ns("proactive", cluster)

    def tile_payload_bytes(sig: TileSignature) -> int:
        return 8 * sig.b_pad if plane == "bank" else _stacked_tile_bytes(sig)

    results: List[Optional[SimResult]] = [None] * len(specs)
    if plane == "bank":
        stacked_h2d = _stacked_plane_h2d(specs, cluster, n_stores,
                                         plan_kw["tile_cells"], n_shards)
    else:
        stacked_h2d = sum(_stacked_tile_bytes(t.sig) for t in tiles)
    h2d_bytes = sum(tile_payload_bytes(t.sig) for t in tiles)
    live_bytes = hwm_bytes = bank_dev_bytes = bank_dev_per = 0
    fabric_bytes = 0
    # one slot block of a sub-bank tile = one shard's k_eff blocks, at
    # its flat rows on one placement, at its local rows on its own
    wv_stride = 0 if multi else k_eff * local_rows

    def prep_banked(tile: Tile):
        """Prefetch-thread work for one banked tile: the two padded int32
        row-index vectors, plus the prepared member cells of each lane
        (the scatter targets). A sub-bank tile's wv entry is the flat
        row ``owner * k * local_rows + local`` of its lane on one
        placement, the local row ``wv_row // n_shards`` on its shard's
        own (the JAX package's ``prep_banked``,
        ``src/repro/core/engine.py:941-966``), at its :attr:`Tile.slots`
        position. Unfilled slots stay 0 -- row 0 is a valid gather
        target and padding outputs are discarded."""
        trace_idx = np.zeros(tile.sig.b_pad, np.int32)
        wv_idx = np.zeros(tile.sig.b_pad, np.int32)
        slots = tile.slots if tile.slots is not None \
            else range(len(tile.specs))
        for s, pos in zip(tile.specs, slots):
            tr, wr = bank.rows_for(s)
            trace_idx[pos] = tr
            wv_idx[pos] = ((wr % n_shards) * wv_stride + wr // n_shards
                           if tile.sig.bank_sub else wr)
        groups = [[(i, _prepare_cell(
            specs[i], _trace_cached(specs[i].workload, n_stores,
                                    specs[i].seed, cluster),
            n_stores, cluster)) for i in lane_members[lane]]
            for lane in tile.indices]
        return groups, (trace_idx, wv_idx)

    def prep_stacked(tile: Tile):
        """Prefetch-thread work for one stacked tile: its prepared cells
        (each its own scatter target) and their cell-major arrays."""
        cells, np_args = _prep_tile(tile, n_stores, cluster)
        return [[(i, c)] for i, c in zip(tile.indices, cells)], np_args

    prep = prep_banked if plane == "bank" else prep_stacked

    def finish(entry) -> None:
        """Drain one launched tile: wait for its outputs (``.cpu()``)
        and scatter each lane's outputs to its member cells (through
        :attr:`Tile.slots` where the sub-bank scheduler placed lanes in
        owner blocks). Marks the tile done -- the recovery loop
        re-launches exactly the tiles that never drained."""
        nonlocal live_bytes
        kt, tile, groups, outs = entry
        with _tm.span("tile/drain", tile=kt):
            exec_ns, at_head, sb_full = drain_tile(outs)
        live_bytes -= tile_payload_bytes(tile.sig)
        slots = tile.slots if tile.slots is not None \
            else range(len(tile.indices))
        for group, pos in zip(groups, slots):
            for i, cell in group:
                meta = {"engine": ("sharded" if tile.sig.n_shards > 1
                                   else "streamed"),
                        "chunk": tile.sig.chunk,
                        "auto_chunk": chunk_size is None,
                        "tile_cells": tile.sig.b_pad,
                        "n_shards": tile.sig.n_shards,
                        "data_plane": plane,
                        "bank_partition": (partition if plane == "bank"
                                           else None),
                        "bank_rows": bank.n_rows if bank is not None else 0,
                        "h2d_bytes": h2d_bytes,
                        "bank_fabric_bytes": fabric_bytes}
                results[i] = _finish_result(cell, exec_ns[pos],
                                            int(at_head[pos]),
                                            int(sb_full[pos]), meta=meta)
        done[kt] = True

    # --- resilience plumbing (inert without an active chaos scope) -----
    st = _chaos.active()

    def prep_guarded(tile: Tile, no: int):
        """Prefetch-thread unit of work: heartbeat + chaos kill point +
        context-wrapping -- a poisoned tile surfaces as an
        :class:`EngineWorkerError` naming the tile."""
        _HEARTBEATS["prefetch"] = time.monotonic()
        if st is not None:
            st.on_thread("prefetch")
        try:
            with _tm.span("tile/prep", tile=no):
                return prep(tile)
        except ChaosError:
            raise
        except Exception as e:
            raise EngineWorkerError("prefetch", no, tile.sig,
                                    repr(e)) from e

    def warm_guarded():
        _HEARTBEATS["compile-warm"] = time.monotonic()
        if st is not None:
            st.on_thread("warm")
        try:
            with _tm.span("compile/warm", signatures=len(sigs)):
                _build_programs(sigs, placements)
        except ChaosError:
            raise
        except Exception as e:
            raise EngineWorkerError("compile-warm", None,
                                    sigs[0] if sigs else None,
                                    repr(e)) from e

    def wait_prep(fut, no: int, sig: TileSignature):
        """Prefetch result with a stall bound: ``worker_timeout_s``
        turns a silently wedged worker into a prompt, attributed
        :class:`EngineWorkerError` instead of a hang."""
        if worker_timeout_s is None:
            return fut.result()
        deadline = time.monotonic() + worker_timeout_s
        while True:
            _futures_wait([fut], timeout=min(0.05, worker_timeout_s))
            if fut.done():
                return fut.result()
            if time.monotonic() > deadline:
                raise EngineWorkerError(
                    "prefetch", no, sig,
                    f"no result within worker_timeout_s={worker_timeout_s}")

    def check_warm() -> None:
        """Surface compile-thread failures promptly (each launch
        iteration), respawning the warm worker if chaos killed it --
        programs are then built on first call, which is correct."""
        nonlocal warm
        if warm.done() and warm.exception() is not None:
            if isinstance(warm.exception(), ThreadDeathError):
                warm = compile_pool.submit(warm_guarded)
            else:
                raise warm.exception()

    def verify_tile(tile: Tile) -> None:
        """Gather-path integrity sampling: CRC-check (a sample of) the
        tile's wv rows against the host truth before its launch. Chaos
        verification runs only -- the production path never reads
        device rows back."""
        if st is None or not st.wants_verify() or bank is None:
            return
        rows = sorted({bank.rows_for(sp)[1] for sp in tile.specs})
        _chaos.verify_rows(bank, bank_parts, rows[:VERIFY_ROWS_PER_TILE],
                           n_shards=n_shards if sub else 1,
                           local_cap=local_rows if sub else 0,
                           where="tile gather sample")

    def bank_place_key():
        return (sub_key(n_shards, k_eff, placements) if sub
                else columns_key(placements))

    def place_bank_now() -> None:
        """Place the bank (memoized on the bank): the sub stacks of
        ``TraceBank.sub_bank_host`` with ``k_eff`` replica blocks --
        contiguous on one placement, a shard's own on each of
        ``n_shards`` -- or one copy of the plain columns per placement
        (``"replicated"``); the JAX package's ``_place_sub_bank`` /
        ``_place_bank`` (``src/repro/core/engine.py:608-672``)."""
        nonlocal bank_parts, h2d_bytes, fabric_bytes
        with _tm.span("bank/place", rows=bank.n_rows):
            if sub:
                fresh, fabric, bank_parts = _retried(
                    lambda: bank.placed_sub(n_shards, placements,
                                            k_replicas=k_eff,
                                            on_upload=_h2d_hook),
                    "bank placement")
            else:
                fresh, fabric, bank_parts = _retried(
                    lambda: bank.placed_columns(placements,
                                                on_upload=_h2d_hook),
                    "bank placement")
        h2d_bytes += fresh
        fabric_bytes += fabric
        measure_bank()

    def measure_bank() -> None:
        nonlocal bank_dev_bytes, bank_dev_per
        bank_dev_bytes, bank_dev_per = _placement_bytes(bank_parts)

    def respare(lost: int, rebuilt) -> None:
        """Place the lost shard again on its own placement (a spare),
        its primary rows from ``rebuilt`` -- the other placements keep
        theirs."""
        nonlocal bank_parts, h2d_bytes, fabric_bytes
        fresh, fabric, bank_parts = _retried(
            lambda: bank.respare_sub(n_shards, placements, k_eff, lost,
                                     rebuilt, on_upload=_h2d_hook),
            "spare placement")
        h2d_bytes += fresh
        fabric_bytes += fabric
        measure_bank()

    def free_lost(lost: int) -> None:
        """A lost placement's memory is gone: drop its tensors from the
        run and from the bank's memo before anything is rebuilt."""
        nonlocal bank_parts
        bank.free_placement(bank_place_key(), lost)
        bank_parts = bank_parts[:lost] + (None,) + bank_parts[lost + 1:]
        measure_bank()

    def recover(err: Exception) -> None:
        """Spare-replacement recovery: rebuild the lost rows from the
        surviving replica block (or the Logging-Unit journal),
        digest-verify the rebuild against the host truth, then place
        again -- the whole bank on one placement, only the lost
        placement (freed before the rebuild) over several -- at the same
        shapes, so every tile program still hits (zero new programs).
        The JAX package's ``recover`` is
        ``src/repro/core/engine.py:1118-1159``."""
        t0 = time.monotonic()
        lost = err.shard if isinstance(err, ShardLossError) else None
        if lost is not None:
            # spare replacement: the shard count and placements are
            # unchanged (a spare takes the lost shard's place) --
            # validated by the elastic policy the trainer tier shares
            from repro_torch.distributed.elastic import \
                cells_spare_replacement
            cells_spare_replacement(n_shards, lost, placements)
        spare = multi and bank is not None and sub and lost is not None
        if spare:
            free_lost(lost)
        source = "redispatch"
        rebuilt = None
        if bank is not None and sub and lost is not None:
            with _tm.span("recover/rebuild", shard=lost):
                if k_eff >= 2:
                    rebuilt = _chaos.replica_rebuild(
                        bank_parts, lost, n_shards=n_shards,
                        k_replicas=k_eff, local_cap=local_rows,
                        wv_rows=bank.wv_rows)
                    source = "replica"
                elif bank.journal_enabled:
                    rebuilt = _chaos.journal_rebuild(bank, lost, n_shards)
                    source = "journal"
                else:
                    rebuilt = None
                    source = "host"
                if rebuilt is not None:
                    _chaos.verify_rebuild(bank, rebuilt, lost, n_shards)
        elif bank is not None:
            source = "host"
        if bank is not None:
            with _tm.span("recover/replace", source=source):
                if spare:
                    respare(lost, rebuilt)
                else:
                    bank.drop_placement(bank_place_key())
                    place_bank_now()
        if st is not None:
            st.note_recovery(source, (time.monotonic() - t0) * 1e3,
                             lost, "spare")

    in_flight: List[tuple] = []
    done = [False] * len(tiles)
    recover_attempts = 0
    redispatch_pending = False
    degraded_from: Optional[int] = None
    sigs = list(dict.fromkeys(t.sig for t in tiles))
    prep_pool = ThreadPoolExecutor(max_workers=1)
    compile_pool = ThreadPoolExecutor(max_workers=1)
    try:
        warm = compile_pool.submit(warm_guarded)
        if plane == "bank":
            with _tm.span("bank/build", cells=len(specs)):
                bank = get_trace_bank(specs, n_stores, cluster)
            if sub:
                # the memoized bank may have grown past this grid's rows
                # (a server extends it in place): its stacks are as wide
                # as its own rows, and the lanes' flat rows and replica
                # offsets follow them
                local_rows = sub_bank_rows(bank.wv_rows, n_shards)
                wv_stride = 0 if multi else k_eff * local_rows
            place_bank_now()
            if st is not None:
                # chaos row corruption lands on the DEVICE copy only (the
                # host columns stay the truth the digests and rebuilds
                # verify against)
                bank_parts = _chaos.placements(st.tamper_bank(
                    bank_parts if multi else bank_parts[0],
                    n_shards=n_shards,
                    k_replicas=k_eff if sub else 1,
                    local_cap=local_rows if sub else 0,
                    wv_rows=bank.wv_rows))
            live_bytes = hwm_bytes = bank_dev_bytes
        while not all(done):
            pending = [k for k, d in enumerate(done) if not d]
            try:
                fut = prep_pool.submit(prep_guarded, tiles[pending[0]],
                                       pending[0])
                for pi, kt in enumerate(pending):
                    tile = tiles[kt]
                    try:
                        groups, np_args = wait_prep(fut, kt, tile.sig)
                    except ThreadDeathError:
                        # prefetch worker killed mid-grid: rebuild this
                        # tile inline and keep streaming (the injected
                        # death was confined to the future)
                        groups, np_args = prep(tile)
                    if pi + 1 < len(pending):
                        nxt = pending[pi + 1]
                        fut = prep_pool.submit(prep_guarded, tiles[nxt],
                                               nxt)
                    check_warm()
                    verify_tile(tile)

                    def place_dispatch(args=np_args, sig=tile.sig):
                        _h2d_hook(tile_payload_bytes(sig))
                        return _place_blocks(args, placements)

                    with _tm.span("tile/h2d", tile=kt):
                        placed = _retried(place_dispatch,
                                          f"tile {kt} placement")
                    if st is not None:
                        st.on_dispatch(f"tile {kt}")
                    # the first launch after a recovery is the
                    # timeline's re-dispatch leg
                    dispatch_span = ("recover/redispatch"
                                     if redispatch_pending
                                     else "tile/dispatch")
                    redispatch_pending = False
                    with _tm.span(dispatch_span, tile=kt):
                        if plane == "bank":
                            outs = launch_tile(tile.sig, placed,
                                               placements,
                                               bank_parts=bank_parts)
                        else:
                            outs = launch_tile(tile.sig, placed,
                                               placements,
                                               costs=(costs["t_l1"],
                                                      costs["t_wt"]))
                    in_flight.append((kt, tile, groups, outs))
                    _tm.gauge("engine/in_flight_tiles", len(in_flight))
                    _tm.gauge("engine/prefetch_queue_depth",
                              len(pending) - pi - 1)
                    live_bytes += tile_payload_bytes(tile.sig)
                    hwm_bytes = max(hwm_bytes, live_bytes)
                    # backpressure: launches run ahead of the device, so
                    # drain the oldest tile once MAX_IN_FLIGHT_TILES are
                    # outstanding
                    if len(in_flight) >= MAX_IN_FLIGHT_TILES:
                        finish(in_flight.pop(0))
                while in_flight:
                    finish(in_flight.pop(0))
            except (ShardLossError, IntegrityError) as e:
                with _tm.span("recover", error=type(e).__name__):
                    with _tm.span("recover/detect",
                                  error=type(e).__name__):
                        _tm.count("chaos/faults_detected")
                    # cancel in-flight tiles: their outputs may involve
                    # the lost / corrupt placement, and they re-launch
                    # (done[] is only set by finish)
                    with _tm.span("recover/rollback",
                                  tiles=len(in_flight)):
                        for (_kt, t_, _g, _o) in in_flight:
                            live_bytes -= tile_payload_bytes(t_.sig)
                        in_flight.clear()
                    recover_attempts += 1
                    if st is None or recover_attempts > MAX_RECOVERIES:
                        raise
                    if (isinstance(e, ShardLossError) and n_shards > 1
                            and plane == "bank"
                            and st.cfg.recovery == "degraded"):
                        degraded_from = e.shard
                        break
                    recover(e)
                redispatch_pending = True
        if degraded_from is None:
            try:
                warm.result()  # surface compile-thread exceptions
            except ThreadDeathError:
                pass           # injected kill, already respawned/absorbed
    finally:
        prep_pool.shutdown(wait=True)
        compile_pool.shutdown(wait=True)

    if degraded_from is not None:
        # no spare: finish the unfinished cells on one shard fewer with
        # the bank replicated -- new programs, but no spare needed; over
        # placements the lost one is freed and dropped
        from repro_torch.distributed.elastic import cells_degraded_shards
        t0 = time.monotonic()
        if multi:
            free_lost(degraded_from)
        n_left, survivors = cells_degraded_shards(n_shards, placements,
                                                  degraded_from)
        left = [i for i, r in enumerate(results) if r is None]
        sub_res = run_grid([specs[i] for i in left], cluster=cluster,
                           n_stores=n_stores, chunk_size=chunk_size,
                           tile_cells=tile_cells, n_shards=n_left,
                           data_plane="bank",
                           bank_partition="replicated", device=dev,
                           devices=survivors)
        for i, r in zip(left, sub_res):
            results[i] = r
        st.note_recovery("degraded-mesh", (time.monotonic() - t0) * 1e3,
                         degraded_from, "degraded")

    _BANK_STATS.clear()
    _BANK_STATS.update({
        "data_plane": plane, "cells": len(specs), "n_shards": n_shards,
        "bank_partition": partition if plane == "bank" else None,
        "scan_lanes": len(lane_members) if plane == "bank" else len(specs),
        "tiles": len(tiles),
        "trace_rows": bank.trace_rows if bank is not None else 0,
        "wv_rows": bank.wv_rows if bank is not None else 0,
        "bank_rows": bank.n_rows if bank is not None else 0,
        "bank_bytes": bank.nbytes if bank is not None else 0,
        "bank_dev_bytes_per_shard": bank_dev_per,
        "bank_dev_bytes": bank_dev_bytes,
        "h2d_bytes": h2d_bytes,
        "bank_fabric_bytes": fabric_bytes,
        "placements": len(placements),
        "stacked_h2d_bytes": stacked_h2d,
        "dedup_ratio": stacked_h2d / max(h2d_bytes, 1),
        "dev_mem_hwm_bytes": hwm_bytes,
        "k_replicas": k_eff,
        "degraded": degraded_from is not None,
        "chaos": st.report() if st is not None else None,
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
                  device=None, devices=None) -> List[SimResult]:
    """Run a scenario grid on the right engine tier, on ``device``.

    ``engine``:

    * ``"auto"`` (default) -- the one-shot banked batch below
      :data:`STREAM_THRESHOLD` cells, the streaming tier at or above it;
    * ``"serial"`` -- the per-cell oracle loop (``simulate_spec``);
    * ``"perstep"`` -- the per-step batched engine
      (``simulate_batch(chunk_size=0)``);
    * ``"blocked"`` -- ``simulate_batch``;
    * ``"stream"`` -- :func:`run_grid`.

    ``data_plane`` (blocked and stream tiers) selects the columnar bank
    (default) or the stacked per-cell-copies baseline; ``n_shards``,
    ``bank_partition``, ``k_replicas`` and ``worker_timeout_s`` (stream
    tier only) pass through to :func:`run_grid`, and so does ``devices``
    (the placements of the shards,
    :func:`~repro_torch.distributed.context.cells_devices`; checked on
    every tier). Below the stream tier a grid runs on one device --
    ``device``, or the first placement -- as the JAX package runs its
    one-shot batch on its default device. ``device=None`` means CUDA
    (raises without one). All tiers return ``==`` results in ``specs``
    order; ``SimResult.meta`` records what actually ran.
    """
    if devices is not None:
        placements = cells_devices(n_shards or 1, devices, device)
        dev = resolve_device(device) if device is not None \
            else placements[0]
    else:
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
    if engine == "serial":
        for s in specs:
            s.validate(cluster)
        return [simulate_spec(s, cluster=cluster, n_stores=n_stores,
                              device=dev) for s in specs]
    if engine == "perstep":
        # forwarded so an explicit data_plane="bank" raises (the
        # per-step engine has no banked plane) instead of silently
        # running stacked
        return simulate_batch(specs, cluster=cluster, n_stores=n_stores,
                              chunk_size=0, data_plane=data_plane,
                              device=dev)
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
                        worker_timeout_s=worker_timeout_s, device=dev,
                        devices=devices)
    raise ValueError(f"unknown engine {engine!r}")
