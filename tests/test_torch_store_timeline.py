"""The port's store_timeline against the JAX package's two scans.

``_timeline`` (the serial oracle's ``lax.scan``) and ``_timeline_batch``
(the per-step engine's) get the very same arrays as the port's plain
versions -- real prepared cells of the JAX package, and seeded random
ones -- and the three outputs must be ``==``: every rule is IEEE add, max
and compares. The CUDA kernel itself runs only on the card: its tests
skip here and ``chip_smoke.py`` holds it against the plain versions
there. The arguments its launch gets, where its ring lives, the counters
and a failed launch are tested against a fake library in place of the
built one.
"""

import contextlib
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import simulator as JS
from repro_torch.kernels.store_timeline import (store_timeline,
                                                store_timeline_batch,
                                                store_timeline_batch_ref,
                                                store_timeline_ref)
from repro_torch.kernels.store_timeline import kernel as st_kernel
from repro_torch.kernels.store_timeline import ops as st_ops

N = 700                                  # ragged against sb 72
COSTS = JS._commit_cost_ns("proactive", JS.PAPER_CLUSTER)
KNOBS = {"t_l1": COSTS["t_l1"], "t_wt": COSTS["t_wt"]}


def _cell(workload, config, n=N, **kw):
    """The JAX package's prepared arrays of one cell (numpy)."""
    spec = JS.ScenarioSpec(workload, config, **kw)
    cell = JS._prepare_cell(spec, JS._trace_cached(
        workload, n, spec.seed, JS.PAPER_CLUSTER), n, JS.PAPER_CLUSTER)
    return (cell.arrivals, cell.coalesce, cell.exposed, cell.t_repl_i,
            cell.svc_i)


def _random(shape, seed):
    """Seeded arrays with every rule's branches taken: coalesced and not,
    stalls on a full SB, bursts of slow log service."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(3.0, shape).astype(np.float32)
    return (np.cumsum(gaps, axis=0, dtype=np.float32),
            rng.random(shape) < 0.3,
            (rng.random(shape) * 20).astype(np.float32),
            (rng.random(shape) * 60 + 10).astype(np.float32),
            np.where(rng.random(shape) < 0.5, 0.4166667, 12.0
                     ).astype(np.float32))


def _jax_serial(arrs, config, sb):
    return JS._timeline(*(jnp.asarray(x) for x in arrs), config, sb,
                        COSTS["t_l1"], COSTS["t_wt"], COSTS["t_drain"])


def _same(port, want, ctx):
    for p, w, name in zip(port, want, ("exec", "at_head", "sb_full")):
        p = p.numpy()
        w = np.asarray(w)
        assert p.dtype == w.dtype, (ctx, name, p.dtype, w.dtype)
        assert np.array_equal(p, w), (ctx, name, p, w)


@pytest.mark.parametrize("sb", [1, 7, 48, 72, N + 1])
@pytest.mark.parametrize("config", JS.CONFIGS)
def test_serial_plain_equals_jax_timeline(config, sb):
    """Each rule at sb 1, 7, the mega-grid's 48, the paper's 72 and deeper
    than the trace, on a real cell with contention and directory load
    folded in."""
    arrs = _cell("canneal", config, conflict_rate=0.2, directory_load=0.4)
    port = store_timeline(*(torch.from_numpy(x) for x in arrs),
                          config=config, sb=sb, **KNOBS)
    _same(port, _jax_serial(arrs, config, sb), (config, sb))


@pytest.mark.parametrize("config", JS.CONFIGS)
def test_serial_plain_equals_jax_ragged_random(config):
    arrs = _random((333,), seed=JS.CONFIGS.index(config))
    port = store_timeline_ref(*(torch.from_numpy(x) for x in arrs),
                              config=config, sb=5, **KNOBS)
    _same(port, _jax_serial(arrs, config, 5), config)


@pytest.mark.parametrize("n", [N, 333])
def test_batch_plain_equals_jax_timeline_batch(n):
    """Mixed rules and mixed depths (1, 7, 16, 72 and one deeper than the
    trace) sharing one ring of sb_max slots."""
    b = 13
    arrs = _random((n, b), seed=n)
    cfg = np.arange(b, dtype=np.int32) % 5
    sbs = np.asarray([1, 7, 16, 72, n + 1] * 3, np.int32)[:b]
    sb_max = JS._pad_len(int(sbs.max()))
    want = JS._timeline_batch(*(jnp.asarray(x) for x in arrs),
                              jnp.asarray(cfg), jnp.asarray(sbs), sb_max,
                              COSTS["t_l1"], COSTS["t_wt"])
    port = store_timeline_batch(*(torch.from_numpy(x) for x in arrs),
                                torch.from_numpy(cfg), torch.from_numpy(sbs),
                                sb_max=sb_max, **KNOBS)
    _same(port, want, n)


def test_batch_plain_on_real_cells_equals_serial():
    """The per-step walk of real cells of every rule gives each cell's
    serial answer (the plain versions against each other)."""
    cells = [(c, _cell("ycsb", c)) for c in JS.CONFIGS]
    stacked = [np.stack([a[k] for _, a in cells], axis=1) for k in range(5)]
    cfg = torch.tensor([JS.CONFIGS.index(c) for c, _ in cells],
                       dtype=torch.int32)
    sbs = torch.tensor([72, 1, 16, 72, 40], dtype=torch.int32)
    got = store_timeline_batch(*(torch.from_numpy(x) for x in stacked), cfg,
                               sbs, sb_max=72, **KNOBS)
    for j, (config, arrs) in enumerate(cells):
        one = store_timeline(*(torch.from_numpy(x) for x in arrs),
                             config=config, sb=int(sbs[j]), **KNOBS)
        for g, o in zip(got, one):
            assert g[j] == o, (config, g[j], o)


def test_cpu_route_counts_no_launch():
    arrs = tuple(torch.from_numpy(x) for x in _random((50,), seed=1))
    before = (store_timeline.launches, dict(store_timeline.launches_by_mode),
              dict(store_timeline.launches_by_ring))
    store_timeline(*arrs, config="wb", sb=4, **KNOBS)
    two = tuple(torch.stack([x, x], dim=1) for x in arrs)
    store_timeline_batch(*two, torch.tensor([0, 4], dtype=torch.int32),
                         torch.tensor([4, 8], dtype=torch.int32), sb_max=8,
                         **KNOBS)
    assert (store_timeline.launches, store_timeline.launches_by_mode,
            store_timeline.launches_by_ring) == before


def test_batch_plain_uniform_depth_equals_serial():
    """A batch whose lanes all have one register-ring depth (48) gives,
    lane by lane, the serial plain version's results under each lane's
    rule."""
    arrs = tuple(torch.from_numpy(x) for x in _random((120, 8), seed=9))
    cfg = torch.arange(8, dtype=torch.int32) % 5
    sbs = torch.full((8,), 48, dtype=torch.int32)
    got = store_timeline_batch(*arrs, cfg, sbs, sb_max=48, **KNOBS)
    for lane in range(8):
        want = store_timeline_ref(*(x[:, lane].contiguous() for x in arrs),
                                  config=JS.CONFIGS[lane % 5], sb=48,
                                  **KNOBS)
        for g, w in zip(got, want):
            assert torch.equal(g[lane], w), lane


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity", "device",
                                  "config", "depth", "lane-shape"])
def test_inputs_are_checked(case):
    a, co, coh, tr, sv = (torch.from_numpy(x)
                          for x in _random((40, 2), seed=2))
    cfg = torch.tensor([0, 4], dtype=torch.int32)
    sbs = torch.tensor([4, 8], dtype=torch.int32)
    if case == "dtype":
        with pytest.raises(TypeError):
            store_timeline_batch(a.double(), co, coh, tr, sv, cfg, sbs,
                                 sb_max=8, **KNOBS)
    elif case == "shape":
        with pytest.raises(ValueError):
            store_timeline(a[:, 0].contiguous(), co[:-1, 0].contiguous(),
                           coh[:, 0].contiguous(), tr[:, 0].contiguous(),
                           sv[:, 0].contiguous(), config="wb", sb=4, **KNOBS)
    elif case == "contiguity":
        with pytest.raises(ValueError):
            store_timeline_batch(a.T.contiguous().T, co, coh, tr, sv, cfg,
                                 sbs, sb_max=8, **KNOBS)
    elif case == "device":
        with pytest.raises(ValueError):
            store_timeline_batch(a.to("meta"), co, coh, tr, sv, cfg, sbs,
                                 sb_max=8, **KNOBS)
    elif case == "config":
        with pytest.raises(ValueError):
            store_timeline(*(x[:, 0].contiguous() for x in
                             (a, co, coh, tr, sv)), config="nosuch", sb=4,
                           **KNOBS)
    elif case == "depth":
        with pytest.raises(ValueError):
            store_timeline_batch(a, co, coh, tr, sv, cfg,
                                 torch.tensor([4, 9], dtype=torch.int32),
                                 sb_max=8, **KNOBS)
    else:
        with pytest.raises(ValueError):
            store_timeline_batch(a, co, coh, tr, sv, cfg[:1], sbs,
                                 sb_max=8, **KNOBS)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode "
                    "(chip_smoke.py runs it against the plain version)")
    return torch.device("cuda")


@pytest.mark.parametrize("config", JS.CONFIGS)
def test_cuda_serial_kernel_matches_plain(cuda_device, config):
    arrs = tuple(torch.from_numpy(x) for x in _cell("barnes", config))
    on_card = tuple(x.to(cuda_device) for x in arrs)
    for sb in (1, 7, 48, 72, 500):
        before = store_timeline.launches
        ring = store_timeline.launches_by_ring[st_kernel.ring_for(sb)]
        got = store_timeline(*on_card, config=config, sb=sb, **KNOBS)
        assert store_timeline.launches == before + 1
        assert (store_timeline.launches_by_ring[st_kernel.ring_for(sb)]
                == ring + 1)
        want = store_timeline_ref(*arrs, config=config, sb=sb, **KNOBS)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), (config, sb)


def _chunk_sizes():
    chunk = st_kernel.load().store_timeline_chunk_stores()
    return (1, 5, chunk - 1, chunk + 1)


@pytest.mark.parametrize("config", JS.CONFIGS)
def test_cuda_serial_small_and_ragged_n(cuda_device, config):
    """n = 1, 5, one below and one above the kernel's chunk, on the
    register ring (sb 48, 72) and the shared one (sb 7)."""
    for n in _chunk_sizes():
        arrs = tuple(torch.from_numpy(x) for x in _random((n,), seed=n))
        on_card = tuple(x.to(cuda_device) for x in arrs)
        for sb in (7, 48, 72):
            got = store_timeline(*on_card, config=config, sb=sb, **KNOBS)
            want = store_timeline_ref(*arrs, config=config, sb=sb, **KNOBS)
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w), (config, n, sb)


@pytest.mark.parametrize("config", JS.CONFIGS)
def test_cuda_serial_misaligned_inputs(cuda_device, config):
    """Contiguous views that start at element 1: no input 16-byte
    aligned, the coalesce bytes not even 4-byte aligned."""
    arrs = tuple(torch.from_numpy(x) for x in _random((2004,), seed=11))
    on_card = tuple(x.to(cuda_device)[1:] for x in arrs)
    assert all(x.is_contiguous() and x.data_ptr() % 16 for x in on_card)
    for sb in (7, 72):
        got = store_timeline(*on_card, config=config, sb=sb, **KNOBS)
        want = store_timeline_ref(*(x[1:] for x in arrs), config=config,
                                  sb=sb, **KNOBS)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), (config, sb)


def test_cuda_perstep_kernel_matches_plain(cuda_device):
    arrs = tuple(torch.from_numpy(x) for x in _random((2003, 21), seed=3))
    cfg = torch.arange(21, dtype=torch.int32) % 5
    sbs = torch.tensor([16, 48, 72, 200] * 6, dtype=torch.int32)[:21]
    before = store_timeline.launches_by_mode["perstep"]
    got = store_timeline_batch(*(x.to(cuda_device) for x in arrs),
                               cfg.to(cuda_device), sbs.to(cuda_device),
                               sb_max=200, **KNOBS)
    assert store_timeline.launches_by_mode["perstep"] == before + 1
    want = store_timeline_batch_ref(*arrs, cfg, sbs, sb_max=200, **KNOBS)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("sb, sb_max, ring", [(48, 48, "register"),
                                              (72, 72, "register"),
                                              (None, 400, "scratch")])
def test_cuda_perstep_rings_match_plain(cuda_device, sb, sb_max, ring):
    """Every lane at sb 48 / 72, read from ``sb_size`` (the register
    ring), and mixed depths past the shared limit (scratch); rules mixed
    across the eight lanes of a block, ragged lanes and small n."""
    for n in _chunk_sizes() + (2003,):
        arrs = tuple(torch.from_numpy(x) for x in _random((n, 19), seed=n))
        cfg = torch.arange(19, dtype=torch.int32) % 5
        sbs = (torch.full((19,), sb, dtype=torch.int32) if sb else
               torch.tensor([1, 7, 385, 400] * 5, dtype=torch.int32)[:19])
        before = store_timeline.launches_by_ring[ring]
        got = store_timeline_batch(*(x.to(cuda_device) for x in arrs),
                                   cfg.to(cuda_device), sbs.to(cuda_device),
                                   sb_max=sb_max, **KNOBS)
        assert store_timeline.launches_by_ring[ring] == before + 1
        want = store_timeline_batch_ref(*arrs, cfg, sbs, sb_max=sb_max,
                                        **KNOBS)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), (n, sb)


class FakeLibrary:
    """Stands in for the built library: records each launch's arguments
    and returns ``status``."""

    def __init__(self, status=0, depths=(48, 72)):
        self.status = status
        self.depths = depths
        self.calls = []

    def store_timeline_max_shared_ring(self):
        return 384

    def store_timeline_chunk_stores(self):
        return 432

    def store_timeline_register_ring_depth(self, k):
        return self.depths[k] if 0 <= k < len(self.depths) else 0

    def store_timeline_launch(self, *args):
        self.calls.append(args)
        return self.status

    def store_timeline_error_string(self, code):
        return b"fake failure"


@contextlib.contextmanager
def _no_card(dev):
    yield 7                              # a stream handle


@pytest.fixture
def fake_library(monkeypatch):
    """The CUDA route of the ops, on CPU tensors, into a fake library; the
    sizes of the tensors the launch allocates are recorded."""
    lib = FakeLibrary()
    sizes = []
    empty = torch.empty

    def recording_empty(*shape, **kw):
        sizes.append(shape)
        return empty(*shape, **kw)

    monkeypatch.setattr(st_ops, "_route", lambda t: "cuda")
    monkeypatch.setattr(st_kernel, "load", lambda: lib)
    monkeypatch.setattr(st_kernel, "on_card", _no_card)
    monkeypatch.setattr(torch, "empty", recording_empty)
    return lib, sizes


@pytest.mark.parametrize("sb, memory_ring", [(1, "shared"), (48, "shared"),
                                             (72, "shared"), (384, "shared"),
                                             (385, "scratch"),
                                             (500, "scratch")])
def test_serial_launch_arguments(fake_library, sb, memory_ring):
    """The serial mode passes its rule's index, its depth as the ring's
    width, the ring instantiation, no per-lane vectors and f32-rounded
    costs. ``memory_ring`` is where a ring of ``sb`` slots lives in
    memory; the launch keeps it in registers instead at the register
    depths (sb 48 / 72). Rings past the shared limit get a scratch buffer
    of ring x lanes floats."""
    ring = "register" if sb in (48, 72) else memory_ring
    lib, sizes = fake_library
    arrs = tuple(torch.from_numpy(x) for x in _random((90,), seed=4))
    total = store_timeline.launches
    serial = store_timeline.launches_by_mode["serial"]
    by_ring = store_timeline.launches_by_ring[ring]
    out = store_timeline(*arrs, config="parallel", sb=sb, **KNOBS)
    assert [tuple(x.shape) for x in out] == [()] * 3
    [args] = lib.calls
    assert args[5] is None and args[6] is None      # no per-lane vectors
    assert args[7:12] == (3, sb, 1, 90, sb)
    assert args[12] == st_kernel.RINGS[ring]
    assert args[13] == float(np.float32(KNOBS["t_l1"]))
    assert args[14] == float(np.float32(KNOBS["t_wt"]))
    assert (args[15] is not None) == (ring == "scratch")
    assert args[19] == 7
    assert st_kernel.ring_for(sb) == ring
    assert st_kernel.ring_for(None, sb) == memory_ring
    assert sizes[:3] == [(1,)] * 3
    assert sizes[3:] == ([(sb,)] if ring == "scratch" else [])
    assert store_timeline.launches == total + 1
    assert store_timeline.launches_by_mode["serial"] == serial + 1
    assert store_timeline.launches_by_ring[ring] == by_ring + 1


def test_perstep_launch_arguments(fake_library):
    lib, sizes = fake_library
    arrs = tuple(torch.from_numpy(x) for x in _random((60, 16), seed=5))
    cfg = torch.arange(16, dtype=torch.int32) % 5
    sbs = torch.full((16,), 400, dtype=torch.int32)
    perstep = store_timeline.launches_by_mode["perstep"]
    out = store_timeline_batch(*arrs, cfg, sbs, sb_max=400, **KNOBS)
    assert [tuple(x.shape) for x in out] == [(16,)] * 3
    [args] = lib.calls
    assert args[5] == cfg.data_ptr() and args[6] == sbs.data_ptr()
    assert args[7:13] == (st_kernel.PER_LANE_CONFIG, 0, 16, 60, 400,
                          st_kernel.RINGS["scratch"])
    assert args[15] is not None
    assert sizes[3:] == [(400 * 16,)]
    assert store_timeline.launches_by_mode["perstep"] == perstep + 1


@pytest.mark.parametrize("sbs, sb_max, ring, sb_arg", [
    ([72] * 16, 72, "register", 72),
    ([48] * 16, 48, "register", 48),
    ([72] * 16, 200, "register", 72),
    ([16] * 16, 16, "shared", 0),
    ([16, 48, 72, 200] * 4, 200, "shared", 0),
    ([48, 72] * 8, 400, "scratch", 0),
    ([72] * 16, 48, "shared", 0),
])
def test_perstep_ring_from_sb_size(fake_library, sbs, sb_max, ring, sb_arg):
    """A depth with a register instantiation that every lane of
    ``sb_size`` shares takes the register ring and hands the kernel that
    depth; other depths, mixed depths, and a depth past ``sb_max`` (its
    lanes get NaN / -1) keep a ring of ``sb_max`` slots in shared memory
    or scratch."""
    lib, sizes = fake_library
    arrs = tuple(torch.from_numpy(x) for x in _random((60, 16), seed=12))
    cfg = torch.arange(16, dtype=torch.int32) % 5
    by_ring = store_timeline.launches_by_ring[ring]
    store_timeline_batch(*arrs, cfg, torch.tensor(sbs, dtype=torch.int32),
                         sb_max=sb_max, **KNOBS)
    [args] = lib.calls
    assert args[8] == sb_arg and args[11] == sb_max
    assert args[12] == st_kernel.RINGS[ring]
    assert (args[15] is not None) == (ring == "scratch")
    assert sizes[3:] == ([(sb_max * 16,)] if ring == "scratch" else [])
    assert store_timeline.launches_by_ring[ring] == by_ring + 1


def test_perstep_engine_takes_register_ring(monkeypatch):
    """Through ``simulate_batch(chunk_size=0)``, Fig. 10's sb-72 cells
    take the register ring and a mixed-SB batch does not; results are
    those of the plain route."""
    from repro_torch.core import scenarios as TSc
    from repro_torch.core import simulator as TS

    specs = TSc.fig10_grid()[:6]
    mixed = [dataclasses.replace(s, sb_size=(16, 72)[i % 2])
             for i, s in enumerate(specs)]
    groups = (specs, mixed)
    want = [TS.simulate_batch(g, n_stores=150, chunk_size=0, device="cpu")
            for g in groups]
    rings = []

    def plain_launch(*args):
        rings.append(args[10])
        return store_timeline_batch_ref(*args[:7], sb_max=args[9],
                                        t_l1=args[11], t_wt=args[12])

    monkeypatch.setattr(st_ops, "_route", lambda t: "cuda")
    monkeypatch.setattr(st_kernel, "load", FakeLibrary)
    monkeypatch.setattr(st_kernel, "launch", plain_launch)
    for g, ring, plain in zip(groups, ("register", "shared"), want):
        TS.clear_sim_caches()
        got = TS.simulate_batch(g, n_stores=150, chunk_size=0, device="cpu")
        assert rings[-1] == ring
        assert [_fields(r) for r in got] == [_fields(r) for r in plain]
    TS.clear_sim_caches()


def _fields(r):
    return tuple(getattr(r, f.name) for f in dataclasses.fields(r)
                 if f.name != "meta")


def test_register_ring_depths_come_from_the_library(monkeypatch):
    """The register-ring depths are the built library's, not a copy:
    a library with another list moves ``ring_for`` with it."""
    monkeypatch.setattr(st_kernel, "load", lambda: FakeLibrary())
    assert st_kernel.register_ring_depths() == (48, 72)
    lib = FakeLibrary(depths=(16,))
    monkeypatch.setattr(st_kernel, "load", lambda: lib)
    assert st_kernel.register_ring_depths() == (16,)
    assert st_kernel.ring_for(16) == "register"
    assert st_kernel.ring_for(48) == st_kernel.ring_for(72) == "shared"
    assert st_kernel.ring_for(None, 16) == "shared"
    # a depth past the ring's width never takes the register ring
    assert st_kernel.ring_for(16, 8) == "shared"


def test_nonzero_launch_status_raises(fake_library):
    lib, _ = fake_library
    lib.status = 1
    arrs = tuple(torch.from_numpy(x) for x in _random((30,), seed=6))
    total = store_timeline.launches
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        store_timeline(*arrs, config="wb", sb=4, **KNOBS)
    assert store_timeline.launches == total


def test_reset_counts(fake_library):
    arrs = tuple(torch.from_numpy(x) for x in _random((30,), seed=7))
    store_timeline(*arrs, config="wt", sb=4, **KNOBS)
    assert store_timeline.launches >= 1
    st_ops.reset_counts()
    assert store_timeline.launches == 0
    assert store_timeline.launches_by_mode == {"serial": 0, "perstep": 0}
    assert store_timeline.launches_by_ring == {"register": 0, "shared": 0,
                                               "scratch": 0}


def test_launches_by_ring_counts(fake_library):
    """Each launch counts once under the ring it took, and nowhere
    else."""
    arrs = tuple(torch.from_numpy(x) for x in _random((30,), seed=10))
    st_ops.reset_counts()
    for sb in (72, 48, 7, 500, 72):
        store_timeline(*arrs, config="proactive", sb=sb, **KNOBS)
    two = tuple(torch.stack([x] * 8, dim=1) for x in arrs)
    cfg = torch.arange(8, dtype=torch.int32) % 5
    store_timeline_batch(*two, cfg, torch.full((8,), 48, dtype=torch.int32),
                         sb_max=48, **KNOBS)
    assert store_timeline.launches_by_ring == {"register": 4, "shared": 1,
                                               "scratch": 1}
    assert store_timeline.launches_by_mode == {"serial": 5, "perstep": 1}
    assert store_timeline.launches == 6
    st_ops.reset_counts()


def test_cuda_route_never_falls_back(monkeypatch):
    """With the build failing, the CUDA route raises and never calls the
    plain version."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def plain_called(*args, **kwargs):
        raise AssertionError("the CUDA route called the plain version")

    monkeypatch.setattr(st_ops, "_route", lambda t: "cuda")
    monkeypatch.setattr(st_kernel, "load", no_nvcc)
    monkeypatch.setattr(st_ops, "store_timeline_ref", plain_called)
    monkeypatch.setattr(st_ops, "store_timeline_batch_ref", plain_called)
    arrs = tuple(torch.from_numpy(x) for x in _random((30,), seed=8))
    with pytest.raises(RuntimeError, match="nvcc"):
        store_timeline(*arrs, config="wb", sb=4, **KNOBS)


def test_new_modules_import_no_jax():
    root = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    mods = ["repro_torch.kernels.store_timeline",
            "repro_torch.kernels.store_timeline.ref",
            "repro_torch.kernels.store_timeline.kernel",
            "repro_torch.kernels.store_timeline.ops",
            "repro_torch.examples", "repro_torch.examples.protocol_sim"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
