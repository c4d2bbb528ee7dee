"""The port's bank_scan against the JAX package's, on the very same bank.

The JAX package builds the bank; ``TraceBank.from_host_arrays`` hands
its columns to the port, so both scan identical rows. The port's CPU
path (the plain torch version) must be ``==`` to the Pallas kernel run
in interpret mode and to the JAX ``bank_scan_ref`` on all three
outputs. The CUDA kernel itself runs only on the card: its tests skip
here and ``chip_smoke.py`` holds it against the plain version there.
Which ring instantiation a depth takes, the arguments the launch gets,
the counters and a failed launch are tested here against a fake library
in place of the built one.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import simulator as JS
from repro.kernels.bank_scan import bank_scan as jax_bank_scan
from repro.kernels.bank_scan.ref import bank_scan_ref as jax_bank_scan_ref
from repro_torch.core import simulator as TS
from repro_torch.kernels.bank_scan import bank_scan, bank_scan_ref
from repro_torch.kernels.bank_scan import kernel as scan_kernel
from repro_torch.kernels.bank_scan import ops as scan_ops

N = 500                                  # ragged vs every chunk below
SB = 24


def _grid(mod, sb):
    return tuple(mod.ScenarioSpec(w, c, seed=s, sb_size=sb)
                 for w in ("ycsb", "canneal") for c in mod.CONFIGS
                 for s in (0, 1))


def _banks(sb, n=N):
    """(jax args, port CPU tensors, index vectors) of one shared bank."""
    specs_j = _grid(JS, sb)
    jbank = JS.get_trace_bank(specs_j, n, JS.PAPER_CLUSTER)
    rows = np.asarray([jbank.rows_for(s) for s in specs_j], np.int32)
    specs_t = _grid(TS, sb)
    trace_row, wv_row = TS.bank_row_maps(specs_t)
    tbank = TS.TraceBank.from_host_arrays(
        jbank.arrivals, jbank.w, jbank.v, jbank.pr_nc, trace_row, wv_row,
        n)
    assert [tbank.rows_for(s) for s in specs_t] == [tuple(r) for r in rows]
    _, cols = tbank.device_args(device="cpu")
    jargs = tuple(jnp.asarray(x) for x in
                  (jbank.arrivals, jbank.w, jbank.v, jbank.pr_nc))
    return jargs, cols, rows[:, 0].copy(), rows[:, 1].copy()


@pytest.fixture(scope="module")
def sb24():
    return _banks(SB)


def _same(port, want, ctx):
    for p, w, name in zip(port, want, ("exec", "at_head", "sb_full")):
        p = p.numpy()
        w = np.asarray(w)
        assert p.dtype == w.dtype, (ctx, name, p.dtype, w.dtype)
        assert np.array_equal(p, w), (ctx, name)


@pytest.mark.parametrize("chunk", [1, 7, SB])
def test_port_matches_pallas_interpret_and_ref(sb24, chunk):
    jargs, cols, tr, wv = sb24
    port = bank_scan(*cols, torch.from_numpy(tr), torch.from_numpy(wv),
                     chunk=chunk, sb=SB)
    pal = jax_bank_scan(*jargs, jnp.asarray(tr), jnp.asarray(wv),
                        chunk=chunk, sb=SB, force="pallas_interpret")
    ref = jax_bank_scan_ref(*jargs, jnp.asarray(tr), jnp.asarray(wv),
                            chunk=chunk, sb=SB)
    _same(port, pal, f"pallas chunk={chunk}")
    _same(port, ref, f"ref chunk={chunk}")


def test_port_matches_pallas_at_paper_sb():
    jargs, cols, tr, wv = _banks(72)
    pal = jax_bank_scan(*jargs, jnp.asarray(tr), jnp.asarray(wv),
                        chunk=SB, sb=72, force="pallas_interpret")
    for chunk in (72, 5):                # the chunk changes no result
        port = bank_scan(*cols, torch.from_numpy(tr), torch.from_numpy(wv),
                         chunk=chunk, sb=72)
        _same(port, pal, f"sb=72 chunk={chunk}")


def test_chunk_clamped_to_sb_and_trace(sb24):
    _, cols, tr, wv = sb24
    idx = (torch.from_numpy(tr), torch.from_numpy(wv))
    a = bank_scan_ref(*cols, *idx, chunk=4 * SB, sb=SB)
    b = bank_scan_ref(*cols, *idx, chunk=SB, sb=SB)
    c = bank_scan_ref(*cols, *idx, chunk=0, sb=SB)
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)


def test_cpu_path_counts_no_launch(sb24):
    _, cols, tr, wv = sb24
    before = bank_scan.launches
    bank_scan(*cols, torch.from_numpy(tr), torch.from_numpy(wv), chunk=7,
              sb=SB)
    assert bank_scan.launches == before


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity", "device",
                                  "sb"])
def test_wrapper_rejects_bad_inputs(sb24, case):
    _, cols, tr, wv = sb24
    a, w, v, p = cols
    tr_t, wv_t = torch.from_numpy(tr), torch.from_numpy(wv)
    if case == "dtype":
        with pytest.raises(TypeError):
            bank_scan(a, w, v, p, tr_t.long(), wv_t, chunk=1, sb=SB)
    elif case == "shape":
        with pytest.raises(ValueError):
            bank_scan(a, w[:, :-1].contiguous(), v, p, tr_t, wv_t, chunk=1,
                      sb=SB)
    elif case == "contiguity":
        with pytest.raises(ValueError):
            bank_scan(a, w, v, p, tr_t.repeat(2)[::2], wv_t, chunk=1, sb=SB)
    elif case == "device":
        meta = tuple(x.to("meta") for x in (a, w, v, p, tr_t, wv_t))
        with pytest.raises(ValueError):
            bank_scan(*meta, chunk=1, sb=SB)
    else:
        with pytest.raises(ValueError):
            bank_scan(a, w, v, p, tr_t, wv_t, chunk=1, sb=0)


def test_from_host_arrays_checks_shapes(sb24):
    _, cols, _, _ = sb24
    a, w, v, p = (x.numpy() for x in cols)
    with pytest.raises(ValueError):
        TS.TraceBank.from_host_arrays(a, w, v, p, {}, {}, N)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode "
                    "(chip_smoke.py runs it against the plain version)")
    return torch.device("cuda")


def test_cuda_kernel_matches_plain(sb24, cuda_device):
    _, cols, tr, wv = sb24
    dev_cols = tuple(x.to(cuda_device) for x in cols)
    idx = (torch.from_numpy(tr).to(cuda_device),
           torch.from_numpy(wv).to(cuda_device))
    for sb in (1, SB, 72, 500):
        before = bank_scan.launches
        got = bank_scan(*dev_cols, *idx, chunk=sb, sb=sb)
        assert bank_scan.launches == before + 1
        want = bank_scan_ref(*cols, *(x.cpu() for x in idx), chunk=sb, sb=sb)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), sb


@pytest.mark.parametrize("sb", [48, 72])
def test_cuda_kernel_register_ring_ragged_rows(cuda_device, sb):
    """The register ring at the repo's depths, on n = 2003 (rows not
    16-byte aligned, a partial last chunk)."""
    _, cols, tr, wv = _banks(sb, n=2003)
    dev_cols = tuple(x.to(cuda_device) for x in cols)
    idx = (torch.from_numpy(tr).to(cuda_device),
           torch.from_numpy(wv).to(cuda_device))
    before = bank_scan.launches_by_ring["register"]
    got = bank_scan(*dev_cols, *idx, chunk=sb, sb=sb)
    assert bank_scan.launches_by_ring["register"] == before + 1
    want = bank_scan_ref(*cols, torch.from_numpy(tr), torch.from_numpy(wv),
                         chunk=sb, sb=sb)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w), sb


class FakeLibrary:
    """Stands in for the built library: records each launch's arguments
    and returns ``status``."""

    def __init__(self, status=0):
        self.status = status
        self.calls = []

    def bank_scan_max_shared_sb(self):
        return 384

    def bank_scan_launch(self, *args):
        self.calls.append(args)
        return self.status

    def bank_scan_error_string(self, code):
        return b"fake failure"


@contextlib.contextmanager
def _no_card(dev):
    yield 5                              # a stream handle


@pytest.fixture
def fake_library(monkeypatch):
    """The CUDA route of the op, on CPU tensors, into a fake library; the
    sizes of the tensors the launch allocates are recorded."""
    lib = FakeLibrary()
    sizes = []
    empty = torch.empty

    def recording_empty(*shape, **kw):
        sizes.append(shape)
        return empty(*shape, **kw)

    monkeypatch.setattr(scan_ops, "_route", lambda t: "cuda")
    monkeypatch.setattr(scan_kernel, "load", lambda: lib)
    monkeypatch.setattr(scan_kernel, "on_card", _no_card)
    monkeypatch.setattr(torch, "empty", recording_empty)
    return lib, sizes


@pytest.mark.parametrize("sb, ring", [(48, "register"), (72, "register"),
                                      (1, "shared"), (7, "shared"),
                                      (384, "shared"), (385, "scratch"),
                                      (500, "scratch")])
def test_depth_picks_the_ring(sb24, fake_library, sb, ring):
    """sb 48 and 72 take the register ring, other depths up to the shared
    limit the shared ring, deeper ones the scratch ring with sb x lanes
    floats; the launch gets the bank shapes and the counters move."""
    lib, sizes = fake_library
    _, cols, tr, wv = sb24
    lanes = len(tr)
    total = bank_scan.launches
    by_ring = dict(bank_scan.launches_by_ring)
    out = bank_scan(*cols, torch.from_numpy(tr), torch.from_numpy(wv),
                    chunk=sb, sb=sb)
    assert [tuple(x.shape) for x in out] == [(lanes,)] * 3
    [args] = lib.calls
    assert args[6:10] == (lanes, N, cols[0].shape[0], cols[1].shape[0])
    assert args[10:12] == (sb, scan_kernel.RINGS[ring])
    assert (args[12] is not None) == (ring == "scratch")
    assert args[16] == 5
    # three outputs, then the scratch ring if any
    assert sizes[:3] == [(lanes,)] * 3
    assert sizes[3:] == ([(sb * lanes,)] if ring == "scratch" else [])
    assert bank_scan.launches == total + 1
    assert bank_scan.launches_by_ring == {
        r: c + (r == ring) for r, c in by_ring.items()}


def test_nonzero_launch_status_raises(sb24, fake_library):
    lib, _ = fake_library
    lib.status = 1
    _, cols, tr, wv = sb24
    total = bank_scan.launches
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        bank_scan(*cols, torch.from_numpy(tr), torch.from_numpy(wv),
                  chunk=72, sb=72)
    assert bank_scan.launches == total
