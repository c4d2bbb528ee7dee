"""Logical shards of the port's streaming tier against the JAX package --
the twin of ``tests/test_sub_bank.py``.

The port runs ``n_shards`` logical shards on one card: the per-shard
sub-bank stacks ``(n_shards, k * local_rows, n_stores)`` lie contiguous
on the device, each lane is scheduled into its wv row owner's slot block
(``plan_tiles(owners=...)``), and a tile's program gathers from the flat
view of the stacks, the host having written each slot's flat row
``owner * k * local_rows + local`` into the index vector. The same specs
go through the JAX package (over the 8 host devices of
``tests/conftest.py``, at the same ``n_shards``) and the port
(``device="cpu"``: the plain bank-scan version); every ``SimResult``
field but ``meta`` must be ``==``, and ``meta`` too but for
``bank_fabric_bytes`` (0 on one card: nothing is copied between
devices). The one-card byte contract replaces the JAX test's
per-device one: the card holds one copy of the arrivals and of each
stack, so the measured bytes are the placed host arrays' bytes.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import engine as JE
from repro.core import simulator as JS
from repro_torch.core import engine as TE
from repro_torch.core import simulator as TS
from repro_torch.core.scenarios import mega_grid, sweep_grid
from repro_torch.core.serving import SERVE_ROW_PAD, _row_capacity
from repro_torch.kernels.bank_scan.ref import bank_scan_ref

N = 700
CPU = "cpu"
WORKLOAD_POOL = ("ycsb", "canneal", "barnes", "raytrace", "ocean_ncp")
META_KEYS = ("engine", "chunk", "auto_chunk", "tile_cells", "n_shards",
             "data_plane", "bank_partition", "bank_rows", "h2d_bytes")


def fields(r):
    return tuple(getattr(r, f.name) for f in dataclasses.fields(r)
                 if f.name != "meta")


def jax_specs(specs):
    return [JS.ScenarioSpec(**dataclasses.asdict(s)) for s in specs]


def assert_same(port, ref, ctx):
    assert len(port) == len(ref)
    for i, (p, j) in enumerate(zip(port, ref)):
        assert fields(p) == fields(j), (ctx, i)
        assert {k: p.meta[k] for k in META_KEYS} \
            == {k: j.meta[k] for k in META_KEYS}, (ctx, i, p.meta, j.meta)
        assert p.meta["bank_fabric_bytes"] == 0


def ragged_grid(seed: int, n: int = 14):
    """A ragged mixed-SB grid over every serve axis, the contention and
    directory knobs included (they add bank rows of their own, so
    ownership interleaves non-trivially), drawn from a numpy seed."""
    rng = np.random.default_rng(seed)

    def pick(xs):
        return xs[int(rng.integers(len(xs)))]

    return [TS.ScenarioSpec(
        pick(WORKLOAD_POOL), pick(TS.CONFIGS), seed=int(rng.integers(3)),
        n_replicas=pick((None, 2, 3)), link_bw_gbps=pick((None, 40.0)),
        sb_size=pick((None, 16, 48)), coalescing=bool(rng.integers(2)),
        read_share=pick((None, 0.3)), conflict_rate=pick((None, 0.05)),
        directory_load=pick((None, 0.5))) for _ in range(n)]


GRID = ragged_grid(0)


@pytest.fixture(scope="module")
def oracle():
    return JS.simulate_batch(jax_specs(GRID), n_stores=N)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sub_bank_equals_jax_across_shards_planes_partitions(n_shards,
                                                             oracle):
    """Sub vs replicated vs stacked, port vs the JAX package at the same
    shard count, and all of them vs the blocked oracle."""
    if jax.device_count() < n_shards:
        pytest.skip(f"needs {n_shards} host devices for the JAX side")
    jgrid = jax_specs(GRID)
    for kw in (dict(), dict(bank_partition="replicated"),
               dict(data_plane="stacked")):
        # fresh banks on both sides, so both count the bank's upload (the
        # port's one replicated copy is shared across shard counts)
        TS.clear_sim_caches()
        JS.clear_sim_caches()
        port = TE.run_grid(GRID, n_stores=N, tile_cells=16,
                           n_shards=n_shards, device=CPU, **kw)
        stats = TE.bank_stats()
        ref = JE.run_grid(jgrid, n_stores=N, tile_cells=16,
                          n_shards=n_shards, **kw)
        jstats = JE.bank_stats()
        assert_same(port, ref, (n_shards, kw))
        assert [fields(r) for r in port] == [fields(r) for r in oracle]
        assert all(r.meta["engine"] == "sharded" for r in port)
        for key in ("bank_partition", "scan_lanes", "trace_rows", "wv_rows",
                    "h2d_bytes", "stacked_h2d_bytes", "k_replicas"):
            assert stats[key] == jstats[key], (kw, key)


def test_plan_tiles_owner_partitioning():
    """The owner-aware scheduler places every lane exactly once, in its
    owning shard's slot block, with canonical padded shapes -- and the
    same tiles, slots and signatures as the JAX package's."""
    n_shards = 4
    specs = [TS.ScenarioSpec(w, c, seed=s)
             for w in WORKLOAD_POOL for c in TS.CONFIGS for s in (0, 1)]
    rng = np.random.default_rng(0)
    owners = [int(rng.integers(n_shards)) for _ in specs]
    tiles = TE.plan_tiles(specs, n_stores=N, tile_cells=16,
                          n_shards=n_shards, small_pad=False, owners=owners)
    jtiles = JE.plan_tiles(jax_specs(specs), n_stores=N, tile_cells=16,
                           n_shards=n_shards, small_pad=False, owners=owners)
    assert [(t.indices, t.slots, dataclasses.asdict(t.sig)) for t in tiles] \
        == [(t.indices, t.slots, dataclasses.asdict(t.sig)) for t in jtiles]
    seen = sorted(i for t in tiles for i in t.indices)
    assert seen == list(range(len(specs)))
    for t in tiles:
        assert t.slots is not None
        assert len(t.slots) == len(t.indices) == len(t.specs)
        assert len(set(t.slots)) == len(t.slots)
        assert t.sig.b_pad % n_shards == 0
        per = t.sig.b_pad // n_shards
        for i, pos in zip(t.indices, t.slots):
            assert 0 <= pos < t.sig.b_pad
            assert pos // per == owners[i], (i, pos, per)
    legacy = TE.plan_tiles(specs, n_stores=N, tile_cells=16,
                           n_shards=n_shards, small_pad=False)
    assert all(t.slots is None for t in legacy)
    single = TE.plan_tiles(specs, n_stores=N, tile_cells=16, n_shards=1,
                           small_pad=False, owners=[0] * len(specs))
    assert all(t.slots is None for t in single)


@pytest.mark.parametrize("k", [1, 2])
def test_sub_bank_host_and_device_bytes_equal_jax(k):
    """``sub_bank_host`` at 4 shards is byte-for-byte the JAX package's
    at ``k_replicas`` 1 and 2, and ``sub_device_args`` places exactly
    those bytes (one copy, on the CPU here) under its own memo key."""
    n = 4
    specs = [TS.ScenarioSpec(w, c) for w in WORKLOAD_POOL for c in TS.CONFIGS]
    bank = TS.get_trace_bank(specs, N)
    jbank = JS.get_trace_bank(jax_specs(specs), N)
    host = bank.sub_bank_host(n, k)
    jhost = jbank.sub_bank_host(n, k)
    assert host[0] is bank.arrivals
    for got, want in zip(host, jhost):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == np.asarray(want).tobytes()
    fresh, dev = bank.sub_device_args(n, device=CPU, k_replicas=k)
    assert fresh == sum(x.nbytes for x in host)
    assert TS.sub_key(n, k, torch.device(CPU)) in bank._device
    for t, h in zip(dev, host):
        assert t.numpy().tobytes() == h.tobytes()
    assert bank.sub_device_args(n, device=CPU, k_replicas=k)[0] == 0


def test_flat_index_of_a_slot_reads_its_row():
    """Flat row ``owner * k * local_rows + local`` of the contiguous
    stacks holds global wv row ``r`` (block 0), and its replica ``j`` in
    block ``j`` of shard ``(owner + j) % n`` -- the index arithmetic
    every sub-bank tile's index vector relies on."""
    n, k = 4, 2
    specs = sweep_grid(workloads=("ycsb", "raytrace", "barnes"),
                       configs=TS.CONFIGS, n_replicas=(None, 3))
    bank = TS.get_trace_bank(specs, N)
    _, dev = bank.sub_device_args(n, device=CPU, k_replicas=k)
    local = TS.sub_bank_rows(bank.wv_rows, n)
    for plane, col in zip(dev[1:], (bank.w, bank.v, bank.pr_nc)):
        flat = plane.view(-1, N)
        for r in range(bank.wv_rows):
            owner, loc = r % n, r // n
            for j in range(k):
                s = (owner + j) % n
                row = flat[s * k * local + j * local + loc].numpy()
                assert np.array_equal(row, col[r]), (r, j)


def test_gather_from_nan_filled_stack_equals_plain_columns():
    """The multi-shard case of the kernel's use: a 4-shard,
    ``k_replicas=2`` stack whose replica blocks and capacity tail are
    NaN, gathered through flat rows by lanes of every shard, gives the
    plain version's outputs on the unpartitioned columns, ``==`` -- a
    gather from the wrong block would show as NaN."""
    n, k = 4, 2
    specs = sweep_grid(workloads=WORKLOAD_POOL, configs=("wb", "proactive"),
                       n_replicas=(None, 2))
    bank = TS.get_trace_bank(specs, N)
    cap = TS.sub_bank_rows(bank.wv_rows, n) + 3          # capacity tail
    stacks = []
    for col in (bank.w, bank.v, bank.pr_nc):
        out = np.zeros((n, k * cap, N), col.dtype)
        if col.dtype != bool:
            out[:] = np.nan
        for s in range(n):
            rows = col[s::n]
            out[s, :rows.shape[0]] = rows
        stacks.append(torch.from_numpy(out))
    a = torch.from_numpy(bank.arrivals)
    rows = [bank.rows_for(s) for s in specs]
    assert {r[1] % n for r in rows} == set(range(n))     # every shard
    tr = torch.tensor([r[0] for r in rows], dtype=torch.int32)
    flat = torch.tensor([(r[1] % n) * k * cap + r[1] // n for r in rows],
                        dtype=torch.int32)
    wv = torch.tensor([r[1] for r in rows], dtype=torch.int32)
    cols = tuple(torch.from_numpy(x) for x in (bank.w, bank.v, bank.pr_nc))
    for sb in (48, 72, 200):
        got = bank_scan_ref(a, *(x.view(-1, N) for x in stacks), tr, flat,
                            chunk=sb, sb=sb)
        want = bank_scan_ref(a, *cols, tr, wv, chunk=sb, sb=sb)
        assert not bool(torch.isnan(got[0]).any())
        for g, w in zip(got, want):
            assert torch.equal(g, w), sb


@pytest.mark.parametrize("n_shards", [1, 4])
def test_one_card_device_bytes_contract(n_shards):
    """On one card the sub partition holds ONE copy of the arrivals and
    of each padded stack, and the replicated partition ONE copy of the
    columns: measured bytes are those host arrays' bytes, the per-shard
    figure is the same number (every shard is on the card), and no byte
    crosses between devices."""
    grid = sweep_grid(workloads=WORKLOAD_POOL, configs=TS.CONFIGS,
                      seeds=(0, 1), n_replicas=(None, 2, 3))
    TS.clear_sim_caches()
    TE.run_grid(grid, n_stores=N, tile_cells=16, n_shards=n_shards,
                device=CPU)
    sub = TE.bank_stats()
    TS.clear_sim_caches()
    TE.run_grid(grid, n_stores=N, tile_cells=16, n_shards=n_shards,
                bank_partition="replicated", device=CPU)
    rep = TE.bank_stats()
    assert sub["bank_bytes"] == rep["bank_bytes"] > 0
    assert rep["bank_dev_bytes"] == rep["bank_dev_bytes_per_shard"] \
        == rep["bank_bytes"]
    a, w, v, p = TS.get_trace_bank(grid, N).sub_bank_host(n_shards)
    assert sub["bank_dev_bytes"] == sub["bank_dev_bytes_per_shard"] \
        == a.nbytes + w.nbytes + v.nbytes + p.nbytes
    assert sub["bank_fabric_bytes"] == rep["bank_fabric_bytes"] == 0
    assert sub["n_shards"] == rep["n_shards"] == n_shards


def test_mega_grid_bank_keys_and_lanes_unchanged():
    """Partitioning moves no bank row or lane: the 12 960-cell mega-grid
    keeps the JAX package's 27 + 1 298 rows and 2 700 lanes, and its
    rows' owners cover every wv row once at 4 and 8 shards."""
    mega = mega_grid()
    trace_map, wv_map = TS.bank_row_maps(mega)
    jtrace, jwv = JS.bank_row_maps(jax_specs(mega))
    assert (len(trace_map), len(wv_map)) == (len(jtrace), len(jwv)) \
        == (27, 1298)
    lanes = {(s.sb_size if s.sb_size is not None
              else TS.PAPER_CLUSTER.store_buffer,)
             + TS._plane_keys(s, TS.PAPER_CLUSTER) for s in mega}
    assert len(lanes) == 2700
    for n in (4, 8):
        owners = [r % n for r in wv_map.values()]
        assert TS.sub_bank_rows(len(wv_map), n) == -(-len(wv_map) // n)
        assert sum(owners.count(s) for s in range(n)) == len(wv_map)
    # at 4 shards: 325 local rows, padded by the server to 512
    assert TS.sub_bank_rows(len(wv_map), 4) == 325
    assert _row_capacity(325, SERVE_ROW_PAD) == 512


def test_n_shards_below_one_raises():
    with pytest.raises(ValueError, match="n_shards"):
        TE.run_grid(GRID, n_stores=N, n_shards=0, device=CPU)
