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


@pytest.mark.parametrize("sb", [1, 7, 72, N + 1])
@pytest.mark.parametrize("config", JS.CONFIGS)
def test_serial_plain_equals_jax_timeline(config, sb):
    """Each rule at sb 1, 7, the paper's 72 and deeper than the trace, on
    a real cell with contention and directory load folded in."""
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
    before = (store_timeline.launches, dict(store_timeline.launches_by_mode))
    store_timeline(*arrs, config="wb", sb=4, **KNOBS)
    two = tuple(torch.stack([x, x], dim=1) for x in arrs)
    store_timeline_batch(*two, torch.tensor([0, 4], dtype=torch.int32),
                         torch.tensor([4, 8], dtype=torch.int32), sb_max=8,
                         **KNOBS)
    assert (store_timeline.launches,
            store_timeline.launches_by_mode) == before


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
    for sb in (1, 7, 72, 500):
        before = store_timeline.launches
        got = store_timeline(*on_card, config=config, sb=sb, **KNOBS)
        assert store_timeline.launches == before + 1
        want = store_timeline_ref(*arrs, config=config, sb=sb, **KNOBS)
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


class FakeLibrary:
    """Stands in for the built library: records each launch's arguments
    and returns ``status``."""

    def __init__(self, status=0):
        self.status = status
        self.calls = []

    def store_timeline_max_shared_ring(self):
        return 384

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


@pytest.mark.parametrize("sb, ring", [(1, "shared"), (72, "shared"),
                                      (384, "shared"), (385, "scratch"),
                                      (500, "scratch")])
def test_serial_launch_arguments(fake_library, sb, ring):
    """The serial mode passes its rule's index, its depth as the ring's
    width, no per-lane vectors and f32-rounded costs; rings past the
    shared limit get a scratch buffer of ring x lanes floats."""
    lib, sizes = fake_library
    arrs = tuple(torch.from_numpy(x) for x in _random((90,), seed=4))
    total = store_timeline.launches
    serial = store_timeline.launches_by_mode["serial"]
    out = store_timeline(*arrs, config="parallel", sb=sb, **KNOBS)
    assert [tuple(x.shape) for x in out] == [()] * 3
    [args] = lib.calls
    assert args[5] is None and args[6] is None      # no per-lane vectors
    assert args[7:12] == (3, sb, 1, 90, sb)
    assert args[12] == float(np.float32(KNOBS["t_l1"]))
    assert args[13] == float(np.float32(KNOBS["t_wt"]))
    assert (args[14] is not None) == (ring == "scratch")
    assert args[18] == 7
    assert st_kernel.ring_for(sb) == ring
    assert sizes[:3] == [(1,)] * 3
    assert sizes[3:] == ([(sb,)] if ring == "scratch" else [])
    assert store_timeline.launches == total + 1
    assert store_timeline.launches_by_mode["serial"] == serial + 1


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
    assert args[7:12] == (st_kernel.PER_LANE_CONFIG, 0, 16, 60, 400)
    assert args[14] is not None
    assert sizes[3:] == [(400 * 16,)]
    assert store_timeline.launches_by_mode["perstep"] == perstep + 1


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
