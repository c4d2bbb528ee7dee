"""The port's bank_scan against the JAX package's, on the very same bank.

The JAX package builds the bank; ``TraceBank.from_host_arrays`` hands
its columns to the port, so both scan identical rows. The port's CPU
path (the plain torch version) must be ``==`` to the Pallas kernel run
in interpret mode and to the JAX ``bank_scan_ref`` on all three
outputs. The CUDA kernel itself runs only on the card: its test skips
here and ``chip_smoke.py`` holds it against the plain version there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import simulator as JS
from repro.kernels.bank_scan import bank_scan as jax_bank_scan
from repro.kernels.bank_scan.ref import bank_scan_ref as jax_bank_scan_ref
from repro_torch.core import simulator as TS
from repro_torch.kernels.bank_scan import bank_scan, bank_scan_ref

N = 500                                  # ragged vs every chunk below
SB = 24


def _grid(mod, sb):
    return tuple(mod.ScenarioSpec(w, c, seed=s, sb_size=sb)
                 for w in ("ycsb", "canneal") for c in mod.CONFIGS
                 for s in (0, 1))


def _banks(sb):
    """(jax args, port CPU tensors, index vectors) of one shared bank."""
    specs_j = _grid(JS, sb)
    jbank = JS.get_trace_bank(specs_j, N, JS.PAPER_CLUSTER)
    rows = np.asarray([jbank.rows_for(s) for s in specs_j], np.int32)
    specs_t = _grid(TS, sb)
    trace_row, wv_row = TS.bank_row_maps(specs_t)
    tbank = TS.TraceBank.from_host_arrays(
        jbank.arrivals, jbank.w, jbank.v, jbank.pr_nc, trace_row, wv_row,
        N)
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
