"""The port's SSD-scan kernel op against the JAX package's.

The same numpy inputs go through the JAX ``ssd_scan`` (the Pallas kernel
in interpret mode and the ``jnp`` route, as ``tests/test_kernels.py``
runs them on the CPU), its ``ssd_ref`` oracle and ``ssd_chunked``, and
through the port's ``ssd_scan`` on CPU tensors (the plain version, the
port's ``ssd_chunked``) and the port's ``ssd_ref``. Tolerances are the
JAX test's: y within 1e-5 (f32) / 3e-2 (bf16) of max |y|, the state
within ten times that. The CUDA kernels run only on the card: their
tests skip here, and ``chip_smoke.py`` holds them against the plain
version there. The wrapper (which kernel a call takes, the arguments each
C entry point gets, the counters) is tested here with a fake library.

The backward's plain version (``ref.py::ssd_bwd_ref``, the formulas of
the backward kernel) is held against torch autograd of the port's
``ssd_chunked`` in f64 and against ``jax.grad`` of the reference's
``ssd_chunked`` on the same inputs, with an initial state and the final
state's gradient too: each gradient within 1e-5 (f32) / 3e-2 (bf16) of
its max |value|.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_ref as jax_ssd_ref
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssd_scan import (kernel, ssd_bwd_ref,
                                          ssd_priors_ref, ssd_ref, ssd_scan)
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.ssm import ssd_chunked

# (b, l, h, p, n, chunk, dtype): tests/test_kernels.py's SSD_CASES
SSD_CASES = [
    (2, 128, 4, 16, 32, 32, "float32"),
    (1, 96, 2, 64, 128, 32, "float32"),   # unaligned l
    (2, 64, 3, 32, 16, 64, "float32"),
    (1, 128, 2, 32, 32, 32, "bfloat16"),
]
IDS = ["f32", "unaligned-l", "one-chunk", "bf16"]


def _inputs(case, seed):
    b, l, h, p, n, chunk, dt = case
    rng = np.random.default_rng(seed)
    arrs = {
        "x": (rng.standard_normal((b, l, h, p)) * 0.5).astype(np.float32),
        "dt": rng.uniform(0.001, 0.1, (b, l, h)).astype(np.float32),
        "A": -rng.uniform(0.5, 2.0, (h,)).astype(np.float32),
        "B": (rng.standard_normal((b, l, n)) * 0.3).astype(np.float32),
        "C": (rng.standard_normal((b, l, n)) * 0.3).astype(np.float32),
    }
    typed = ("x", "B", "C")
    jx = {k: jnp.asarray(a, dt if k in typed else jnp.float32)
          for k, a in arrs.items()}
    tx = {k: torch.from_numpy(a).to(getattr(torch, dt) if k in typed
                                    else torch.float32)
          for k, a in arrs.items()}
    return jx, tx, chunk, (3e-2 if dt == "bfloat16" else 1e-5)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t.astype(jnp.float32))


def _close(y, s, y_ref, s_ref, tol, what):
    scale = float(np.max(np.abs(_np(y_ref)))) + 1e-9
    assert np.max(np.abs(_np(y) - _np(y_ref))) / scale < tol, what
    assert np.max(np.abs(_np(s) - _np(s_ref))) < tol * 10, what
    # the JAX test's absolute state limit exceeds a bf16 state's whole
    # scale; hold the state to its own scale as y is held
    s_scale = float(np.max(np.abs(_np(s_ref)))) + 1e-9
    assert np.max(np.abs(_np(s) - _np(s_ref))) / s_scale < tol, what


@pytest.mark.parametrize("case", SSD_CASES, ids=IDS)
def test_plain_version_matches_jax_paths(case):
    jx, tx, chunk, tol = _inputs(case, seed=21)
    before = ssd_scan.launches
    y, s = ssd_scan(tx["x"], tx["dt"], tx["A"], tx["B"], tx["C"], chunk=chunk)
    assert ssd_scan.launches == before
    assert y.dtype == s.dtype == tx["x"].dtype
    j = (jx["x"], jx["dt"], jx["A"], jx["B"], jx["C"])
    y_ref, s_ref = jax_ssd_ref(*j)
    _close(y, s, y_ref, s_ref, tol, "jax ssd_ref")
    for path in ("pallas_interpret", "jnp"):
        jy, js = jax_ssd_scan(*j, chunk=chunk, force=path)
        _close(y, s, jy, js, tol, path)


@pytest.mark.parametrize("case", SSD_CASES, ids=IDS)
def test_oracle_matches_jax_oracle(case):
    jx, tx, _, tol = _inputs(case, seed=22)
    y, s = ssd_ref(tx["x"], tx["dt"], tx["A"], tx["B"], tx["C"])
    jy, js = jax_ssd_ref(jx["x"], jx["dt"], jx["A"], jx["B"], jx["C"])
    _close(y, s, jy, js, tol, "ssd_ref")


@pytest.mark.parametrize("split", [32, 48])
def test_init_state_continuation(split):
    """Two calls with the state carried equal one call (the
    prefill -> decode contract), and match the JAX ssd_chunked given
    the same initial state."""
    jx, tx, _, _ = _inputs((1, 96, 2, 16, 16, 32, "float32"), seed=23)
    t = {k: v for k, v in tx.items()}
    y_full, s_full = ssd_scan(t["x"], t["dt"], t["A"], t["B"], t["C"], 16)
    cut = lambda d, a, b: {k: (v if k == "A" else v[:, a:b])  # noqa: E731
                           for k, v in d.items()}
    p1, p2 = cut(t, 0, split), cut(t, split, None)
    y1, s1 = ssd_scan(p1["x"], p1["dt"], p1["A"], p1["B"], p1["C"], 16)
    y2, s2 = ssd_scan(p2["x"], p2["dt"], p2["A"], p2["B"], p2["C"], 16,
                      init_state=s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(),
                               atol=3e-5, rtol=3e-4)
    np.testing.assert_allclose(s2.numpy(), s_full.numpy(), atol=3e-5,
                               rtol=3e-4)
    j2 = cut(jx, split, None)
    jy2, js2 = jax_ssd_chunked(j2["x"], j2["dt"], j2["A"], j2["B"], j2["C"],
                               16, init_state=jnp.asarray(s1.numpy()))
    r2, rs2 = ssd_ref(p2["x"], p2["dt"], p2["A"], p2["B"], p2["C"],
                      init_state=s1)
    _close(y2, s2, jy2, js2, 1e-5, "jax ssd_chunked with init_state")
    _close(y2, s2, r2, rs2, 1e-5, "port ssd_ref with init_state")


@pytest.mark.parametrize("chunk", [16, 32, 96])
def test_ssd_chunked_matches_jax_at_every_chunk(chunk):
    jx, tx, _, _ = _inputs((2, 96, 2, 16, 24, 0, "float32"), seed=24)
    y, s = ssd_chunked(tx["x"], tx["dt"], tx["A"], tx["B"], tx["C"], chunk)
    jy, js = jax_ssd_chunked(jx["x"], jx["dt"], jx["A"], jx["B"], jx["C"],
                             chunk)
    np.testing.assert_allclose(y.numpy(), _np(jy), atol=2e-5, rtol=2e-4)
    np.testing.assert_allclose(s.numpy(), _np(js), atol=2e-5, rtol=2e-4)


def test_strong_decay_gives_no_nan():
    """A = -50 makes exp(seg_i - seg_j) overflow above the diagonal; the
    mask is a select, so no NaN reaches y (hymba's last head)."""
    _, tx, _, _ = _inputs((1, 256, 2, 16, 16, 256, "float32"), seed=25)
    A = torch.tensor([-50.0, -1.0])
    dt = torch.full_like(tx["dt"], 0.1)
    y, s = ssd_scan(tx["x"], dt, A, tx["B"], tx["C"], chunk=256)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    y_ref, s_ref = ssd_ref(tx["x"], dt, A, tx["B"], tx["C"])
    _close(y, s, y_ref, s_ref, 1e-5, "strong decay")


@pytest.mark.parametrize("case", ["rank", "dt-shape", "A-shape", "BC-shape",
                                  "dtype-mix", "dtype", "head-dim",
                                  "state-size", "init-shape", "chunk",
                                  "heads"])
def test_kernel_wrapper_rejects_bad_inputs(case):
    """What the CUDA kernel does not take raises before any launch."""
    x = torch.zeros(1, 32, 2, 64)
    dt, A = torch.zeros(1, 32, 2), torch.zeros(2)
    B = torch.zeros(1, 32, 16)
    a = dict(x=x, dt=dt, A=A, B=B, C=B, chunk=16, init_state=None)
    a.update({
        "rank": dict(x=x[0]), "dt-shape": dict(dt=dt[:, :8]),
        "A-shape": dict(A=torch.zeros(3)),
        "BC-shape": dict(C=torch.zeros(1, 32, 8)),
        "dtype-mix": dict(B=B.bfloat16(), C=B.bfloat16()),
        "dtype": dict(x=x.half(), B=B.half(), C=B.half()),
        "head-dim": dict(x=torch.zeros(1, 32, 2, 48)),
        "state-size": dict(B=torch.zeros(1, 32, 200),
                           C=torch.zeros(1, 32, 200)),
        "init-shape": dict(init_state=torch.zeros(1, 2, 64, 8)),
        "chunk": dict(chunk=0),
        "heads": dict(x=torch.zeros(1, 1, 65536, 16),
                      dt=torch.zeros(1, 1, 65536), A=torch.zeros(65536),
                      B=torch.zeros(1, 1, 16), C=torch.zeros(1, 1, 16)),
    }[case])
    err = TypeError if case.startswith("dtype") else ValueError
    with pytest.raises(err):
        kernel.check_inputs(**a)


def test_other_devices_raise():
    x = torch.zeros(1, 8, 2, 32, device="meta")
    with pytest.raises(ValueError):
        ssd_scan(x, x[..., 0], x[0, 0, :, 0], x[:, :, 0], x[:, :, 0])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode "
                    "(chip_smoke.py runs it against the plain version)")
    return torch.device("cuda")


def _on_card_call(tx, chunk, dev, init=None):
    """The op on the card; asserts that it made one call of the dtype's
    kernel (bf16: the tensor-core passes, f32: the CUDA-core kernel)."""
    which = "mma" if tx["x"].dtype == torch.bfloat16 else "simt"
    before = ssd_scan.launches
    by_kernel = dict(ssd_scan.launches_by_kernel)
    y, s = ssd_scan(*(tx[k].to(dev) for k in "x dt A B C".split()),
                    chunk=chunk,
                    init_state=None if init is None else init.to(dev))
    assert ssd_scan.launches == before + 1
    assert ssd_scan.launches_by_kernel == {
        k: c + (k == which) for k, c in by_kernel.items()}
    return y.cpu(), s.cpu()


@pytest.mark.parametrize("case", SSD_CASES, ids=IDS)
def test_cuda_kernel_matches_plain(case, cuda_device):
    _, tx, chunk, tol = _inputs(case, seed=26)
    y, s = _on_card_call(tx, chunk, cuda_device)
    y_ref, s_ref = ssd_ref(tx["x"], tx["dt"], tx["A"], tx["B"], tx["C"])
    _close(y, s, y_ref, s_ref, tol, "kernel vs ssd_ref")


# (b, l, h, p, n, chunk, dtype), kind: what the tensor-core passes must take
MMA_CASES = [
    ((2, 512, 4, 64, 128, 256, "bfloat16"), None),     # mamba2-2.7b's p, n
    ((2, 256, 4, 32, 8, 64, "bfloat16"), None),        # n = 8
    ((2, 300, 3, 64, 16, 128, "bfloat16"), None),      # ragged last chunk
    ((1, 100, 2, 128, 5, 48, "bfloat16"), None),       # n = 5, chunk 48
    ((1, 4096, 4, 64, 16, 256, "bfloat16"), "weak-decay"),
    ((1, 4096, 4, 64, 16, 256, "float32"), "weak-decay"),
    ((1, 256, 2, 32, 16, 256, "bfloat16"), "strong-decay"),
    ((2, 200, 4, 64, 16, 64, "bfloat16"), "init-state"),
]
MMA_IDS = ["mamba2-width", "n8", "ragged", "n5", "weak-decay-bf16",
           "weak-decay-f32", "strong-decay-bf16", "init-state-bf16"]


@pytest.mark.parametrize("case,kind", MMA_CASES, ids=MMA_IDS)
def test_cuda_kernel_new_cases(case, kind, cuda_device):
    """Shapes and decays the chunk-parallel passes must take, against the
    oracle and the plain version, through the dtype's kernel."""
    _, tx, chunk, tol = _inputs(case, seed=27)
    if kind == "weak-decay":             # the state carries over 16 chunks
        tx["A"] = torch.full_like(tx["A"], -0.05)
    if kind == "strong-decay":
        tx["A"] = torch.tensor([-50.0, -1.0])
        tx["dt"] = torch.full_like(tx["dt"], 0.1)
    init = None
    if kind == "init-state":
        b, _, h, p, n = case[:5]
        init = torch.from_numpy(np.random.default_rng(28).standard_normal(
            (b, h, p, n)).astype(np.float32) * 0.1)
    y, s = _on_card_call(tx, chunk, cuda_device, init)
    assert torch.isfinite(y.float()).all() and torch.isfinite(s.float()).all()
    args = (tx["x"], tx["dt"], tx["A"], tx["B"], tx["C"])
    y_ref, s_ref = ssd_ref(*args, init_state=init)
    _close(y, s, y_ref, s_ref, tol, "kernel vs ssd_ref")
    y_pl, s_pl = ssd_chunked(*args, chunk, init)
    _close(y, s, y_pl, s_pl, tol, "kernel vs ssd_chunked")


class FakeLibrary:
    """Stands in for the built libraries (forward and backward): records
    each launch's arguments and returns ``status``; reports ``smem``
    bytes of shared memory and a workspace of ``ws_bytes``."""

    def __init__(self, status=0, smem=1024, ws_bytes=4096):
        self.status, self.smem, self.ws_bytes = status, smem, ws_bytes
        self.calls = []
        self.ws_asked = []

    def ssd_scan_mma_launch(self, *args):
        self.calls.append(("mma", args))
        return self.status

    def ssd_scan_launch(self, *args):
        self.calls.append(("simt", args))
        return self.status

    def ssd_scan_mma_priors_launch(self, *args):
        self.calls.append(("mma-priors", args))
        return self.status

    def ssd_scan_priors_launch(self, *args):
        self.calls.append(("simt-priors", args))
        return self.status

    def ssd_scan_mma_prior_width(self, n):
        return 16 if n <= 16 else 32 if n <= 32 else 64 if n <= 64 else 128

    def ssd_scan_bwd_launch(self, *args):
        self.calls.append(("bwd", args))
        return self.status

    def ssd_scan_bwd_mma_launch(self, *args):
        self.calls.append(("bwd-mma", args))
        return self.status

    def ssd_scan_bwd_planted_launch(self, *args):
        self.calls.append(("bwd-planted", args))
        return self.status

    def ssd_scan_bwd_smem_bytes(self, p, n, chunk, l):
        return self.smem

    ssd_scan_bwd_mma_smem_bytes = ssd_scan_bwd_smem_bytes

    def ssd_scan_bwd_workspace_bytes(self, *args):
        self.ws_asked.append(("bwd",) + args)
        return self.ws_bytes

    def ssd_scan_bwd_mma_workspace_bytes(self, *args):
        self.ws_asked.append(("bwd-mma",) + args)
        return self.ws_bytes

    def ssd_scan_mma_smem_bytes(self, p, n, chunk):
        return self.smem

    def ssd_scan_smem_bytes(self, p, n, chunk):
        return self.smem

    def ssd_scan_mma_workspace_bytes(self, *args):
        self.ws_asked.append(args)
        return self.ws_bytes

    def ssd_scan_error_string(self, code):
        return b"fake failure"

    ssd_scan_bwd_error_string = ssd_scan_error_string


@contextlib.contextmanager
def _no_card(dev):
    yield 7                              # a stream handle


@pytest.fixture
def fake_library(monkeypatch):
    """The CUDA route of the op, on CPU tensors, into a fake library."""
    lib = FakeLibrary()
    monkeypatch.setattr(ssd_ops, "_route", lambda t: "cuda")
    monkeypatch.setattr(kernel, "load", lambda: lib)
    monkeypatch.setattr(kernel, "load_bwd", lambda: lib)
    monkeypatch.setattr(kernel, "on_card", _no_card)
    return lib


def _zeros(b, l, h, p, n, dtype):
    dt = getattr(torch, dtype)
    return (torch.zeros(b, l, h, p, dtype=dt), torch.zeros(b, l, h),
            torch.zeros(h), torch.zeros(b, l, n, dtype=dt),
            torch.zeros(b, l, n, dtype=dt))


@pytest.mark.parametrize("p", kernel.HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dtype_picks_the_kernel_and_its_arguments(fake_library, p, dtype):
    """bf16 calls the tensor-core entry point with a workspace of the size
    the library asks for, f32 the CUDA-core one with its dtype code; each
    with the shapes, the chunk and the stream; the total and the
    per-kernel counters move by one."""
    x, dt, A, B, C = _zeros(2, 96, 3, p, 16, dtype)
    total = ssd_scan.launches
    by_kernel = dict(ssd_scan.launches_by_kernel)
    y, s = ssd_scan(x, dt, A, B, C, chunk=32)
    assert y.shape == x.shape and y.dtype == x.dtype
    assert s.shape == (2, 3, p, 16) and s.dtype == x.dtype
    [(which, args)] = fake_library.calls
    assert which == ("mma" if dtype == "bfloat16" else "simt")
    assert args[0] == x.data_ptr() and args[5] is None
    assert args[6] == y.data_ptr() and args[7] == s.data_ptr()
    if which == "mma":
        assert fake_library.ws_asked == [(2, 96, 3, p, 16, 32)]
        assert isinstance(args[8], int) and args[8] != 0
        assert args[9:] == (2, 96, 3, p, 16, 32, 7)
    else:
        assert fake_library.ws_asked == []
        assert args[8:] == (2, 96, 3, p, 16, 32, kernel.DTYPES[x.dtype], 7)
    assert ssd_scan.launches == total + 1
    assert ssd_scan.launches_by_kernel == {
        k: c + (k == which) for k, c in by_kernel.items()}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_chunk_is_clamped_and_init_state_passed(fake_library, dtype):
    x, dt, A, B, C = _zeros(1, 40, 2, 16, 8, dtype)
    init = torch.zeros(1, 2, 16, 8)
    ssd_scan(x, dt, A, B, C, chunk=256, init_state=init)
    [(which, args)] = fake_library.calls
    assert args[5] == init.data_ptr()
    assert args[-2 if which == "mma" else -3] == 40


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_nonzero_launch_status_raises(fake_library, dtype):
    fake_library.status = 9
    total = ssd_scan.launches
    by_kernel = dict(ssd_scan.launches_by_kernel)
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        ssd_scan(*_zeros(1, 64, 2, 32, 16, dtype), chunk=32)
    assert ssd_scan.launches == total
    assert ssd_scan.launches_by_kernel == by_kernel


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_shared_memory_refused_before_launch(fake_library, dtype):
    fake_library.smem = kernel.MAX_SMEM_BYTES + 16
    with pytest.raises(ValueError, match="shared memory"):
        ssd_scan(*_zeros(1, 64, 2, 32, 16, dtype), chunk=64)
    assert fake_library.calls == []


def test_tensor_core_kernel_takes_only_bf16(fake_library):
    with pytest.raises(TypeError):
        kernel.launch(*_zeros(1, 64, 2, 32, 16, "float32"), 32, None, "mma")
    with pytest.raises(ValueError):
        kernel.launch(*_zeros(1, 64, 2, 32, 16, "bfloat16"), 32, None,
                      "wgmma")
    with pytest.raises(TypeError):
        kernel.kernel_for(torch.float16)
    assert fake_library.calls == []


def test_cuda_core_kernel_runs_bf16_by_name(fake_library):
    """The yardstick route: the CUDA-core kernel on bf16 inputs, asked for
    by name (the public op never does)."""
    kernel.launch(*_zeros(1, 64, 2, 32, 16, "bfloat16"), 32, None, "simt")
    [(which, args)] = fake_library.calls
    assert which == "simt" and args[-2] == kernel.DTYPES[torch.bfloat16]


def test_cpu_calls_count_nothing():
    total = ssd_scan.launches
    by_kernel = dict(ssd_scan.launches_by_kernel)
    bwd = ssd_scan.bwd_launches
    for dtype in ("bfloat16", "float32"):
        x, dt, A, B, C = _zeros(1, 64, 2, 16, 8, dtype)
        y, _ = ssd_scan(x.requires_grad_(True), dt, A, B, C, chunk=32)
        y.float().sum().backward()
    assert ssd_scan.launches == total
    assert ssd_scan.launches_by_kernel == by_kernel
    assert ssd_scan.bwd_launches == bwd


def test_reset_counts():
    ssd_ops.reset_counts()
    assert ssd_scan.launches == 0
    assert ssd_scan.launches_by_kernel == {"mma": 0, "simt": 0}
    assert ssd_scan.bwd_launches == 0
    assert ssd_scan.bwd_launches_by_kernel == {"mma": 0, "simt": 0}


@pytest.mark.parametrize("which", ["x", "dt", "B", "init_state"])
def test_cuda_route_refuses_grad(fake_library, which):
    """The contract C1 left (ROADMAP C) is now the gradient: on the CUDA
    route, with grad mode on and an input that requires grad (the
    initial state too), the op launches the forward entry point that
    writes the priors (once), and ``backward()`` launches the backward
    entry point once, with output buffers only for the inputs that
    require a gradient (ddt and dA are computed inside in any case); the
    gradient reaches only those inputs. Under ``no_grad`` /
    ``inference_mode`` the same call launches the plain forward entry
    point, as before, and no backward."""
    x, dt, A, B, C = _zeros(1, 64, 2, 32, 16, "float32")
    t = {"x": x, "dt": dt, "B": B, "init_state": torch.zeros(1, 2, 32, 16)}
    t[which].requires_grad_(True)
    args = (t["x"], t["dt"], A, t["B"], C)
    total, bwd = ssd_scan.launches, ssd_scan.bwd_launches
    y, s = ssd_scan(*args, chunk=32, init_state=t["init_state"])
    assert y.requires_grad and s.requires_grad
    [(name, fargs)] = fake_library.calls
    assert name == "simt-priors" and fargs[5] == t["init_state"].data_ptr()
    assert ssd_scan.launches == total + 1 and ssd_scan.bwd_launches == bwd
    (y.sum() + s.sum()).backward()
    [(name, bargs)] = fake_library.calls[1:]
    assert name == "bwd" and bargs[5] == fargs[8]          # the priors
    assert bargs[6] == 16 and bargs[-2] == kernel.DTYPES[torch.float32]
    assert bargs[-8:-2] == (1, 64, 2, 32, 16, 32)
    assert bargs[8] is not None                            # dstate
    outs = dict(zip(GRAD_NAMES, bargs[9:15]))
    for name, ptr in outs.items():
        assert (ptr is not None) == (name == which), name
    assert ssd_scan.bwd_launches == bwd + 1
    assert ssd_scan.bwd_launches_by_kernel["simt"] >= 1
    for name, tensor in t.items():
        assert (tensor.grad is not None) == (name == which), name
    assert t[which].grad.shape == t[which].shape
    assert t[which].grad.dtype == t[which].dtype
    with torch.no_grad():
        ssd_scan(*args, chunk=32, init_state=t["init_state"])
    with torch.inference_mode():
        ssd_scan(*args, chunk=32, init_state=t["init_state"])
    assert [w for w, _ in fake_library.calls[2:]] == ["simt", "simt"]
    assert ssd_scan.launches == total + 3
    assert ssd_scan.bwd_launches == bwd + 1


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_grad_route_launches_the_priors_entry(fake_library, dtype):
    """A call that autograd will differentiate takes the dtype's kernel
    through its priors entry point: the priors buffer (b, h, nc, p, w),
    w = n on the CUDA cores and n padded to 16 on the tensor cores,
    after the state and otherwise the arguments of the plain entry
    point; the backward reads that buffer with its width, takes y's
    gradient in x's dtype and, with the final state unused, no dstate:
    bf16 through the tensor-core entry point (no dtype code), f32 the
    CUDA-core one."""
    x, dt, A, B, C = _zeros(2, 100, 3, 16, 8, dtype)
    by_kernel = dict(ssd_scan.launches_by_kernel)
    y, s, priors = kernel.launch(x, dt, A, B, C, 32, with_priors=True)
    w = 16 if dtype == "bfloat16" else 8
    assert priors.shape == (2, 3, 4, 16, w) and priors.dtype == x.dtype
    [(which, args)] = fake_library.calls
    assert which == ("mma-priors" if dtype == "bfloat16" else "simt-priors")
    assert args[8] == priors.data_ptr()
    fake_library.calls.clear()
    y, _ = ssd_scan(x.requires_grad_(True), dt, A, B, C, chunk=32)
    assert ssd_scan.launches_by_kernel == {
        k: c + (k == kernel.kernel_for(x.dtype)) for k, c in by_kernel.items()}
    (y.float() * 2.0).sum().backward()
    [(_, fargs), (name, bargs)] = fake_library.calls
    entry = "bwd-mma" if dtype == "bfloat16" else "bwd"
    assert name == entry and bargs[5] == fargs[8] and bargs[6] == w
    assert bargs[8] is None                                # dstate unused
    assert bargs[9] is not None and bargs[10:15] == (None,) * 5
    assert fake_library.ws_asked[-1] == (entry, 2, 100, 3, 16, 8, 32)
    if dtype == "bfloat16":
        assert bargs[-7:] == (2, 100, 3, 16, 8, 32, 7)
    else:
        assert bargs[-2] == kernel.DTYPES[x.dtype]
    assert x.grad.shape == x.shape and x.grad.dtype == x.dtype


def test_bwd_checks_before_any_launch(fake_library):
    """What the backward does not take raises before its launch: priors
    of another shape, width or dtype, a dy or dstate of another shape,
    too much shared memory; a non-zero status raises with its code."""
    x, dt, A, B, C = _zeros(1, 64, 2, 32, 16, "float32")
    pr = torch.zeros(1, 2, 2, 32, 16)
    dy = torch.zeros_like(x)
    bad = [dict(priors=pr[:, :, :1]), dict(priors=pr[..., :8]),
           dict(priors=pr.bfloat16()), dict(dy=dy[:, :32]),
           dict(dstate=torch.zeros(1, 2, 32, 8))]
    for kw in bad:
        a = dict(priors=pr, dy=dy, dstate=None)
        a.update(kw)
        with pytest.raises(ValueError):
            kernel.launch_bwd(x, dt, A, B, C, 32, a["priors"], a["dy"],
                              a["dstate"])
    fake_library.smem = kernel.MAX_SMEM_BYTES + 4
    with pytest.raises(ValueError, match="shared memory"):
        kernel.launch_bwd(x, dt, A, B, C, 32, pr, dy)
    assert fake_library.calls == []
    fake_library.smem, fake_library.status = 1024, 11
    with pytest.raises(RuntimeError, match="CUDA error 11"):
        kernel.launch_bwd(x, dt, A, B, C, 32, pr, dy)
    with pytest.raises(TypeError):
        kernel.bwd_kernel_for(torch.float16)


@pytest.mark.parametrize("p", kernel.HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bwd_dtype_picks_the_kernels_and_their_arguments(fake_library, p,
                                                         dtype):
    """bf16's backward takes the tensor-core entry point, f32's the
    CUDA-core one (``bwd_kernel_for``): each with the forward's inputs,
    the priors and their width, dy, dstate, the six gradient buffers, a
    workspace of the size its own entry point asks for, the shapes, the
    chunk and the stream; the CUDA-core one also with its dtype code."""
    x, dt, A, B, C = _zeros(2, 96, 3, p, 16, dtype)
    assert kernel.bwd_kernel_for(x.dtype) == (
        "mma" if dtype == "bfloat16" else "simt")
    pr = torch.zeros(2, 3, 3, p, 16, dtype=x.dtype)
    dy = torch.zeros_like(x)
    ds = torch.zeros(2, 3, p, 16)
    grads = kernel.launch_bwd(x, dt, A, B, C, 32, pr, dy, ds,
                              dinit_dtype=torch.float32)
    [(name, args)] = fake_library.calls
    entry = "bwd-mma" if dtype == "bfloat16" else "bwd"
    assert name == entry
    assert fake_library.ws_asked == [(entry, 2, 96, 3, p, 16, 32)]
    assert args[0] == x.data_ptr() and args[5] == pr.data_ptr()
    assert args[6] == 16 and args[7] == dy.data_ptr()
    assert args[8] == ds.data_ptr()
    assert args[9:15] == tuple(g.data_ptr() for g in grads)
    assert isinstance(args[15], int) and args[15] != 0     # the workspace
    tail = (2, 96, 3, p, 16, 32)
    if entry == "bwd-mma":
        assert args[16:] == tail + (7,)
    else:
        assert args[16:] == tail + (kernel.DTYPES[x.dtype], 7)
    assert [g.dtype for g in grads] == [x.dtype, torch.float32,
                                        torch.float32, x.dtype, x.dtype,
                                        torch.float32]


@pytest.mark.parametrize("which", ["mma", "simt"])
def test_bwd_either_kernel_runs_bf16_by_name(fake_library, which):
    """bf16 reaches both backward routes by name: the tensor-core one (its
    default) and the CUDA-core one, the yardstick it is timed against."""
    x, dt, A, B, C = _zeros(1, 64, 2, 32, 16, "bfloat16")
    pr = torch.zeros(1, 2, 2, 32, 16, dtype=torch.bfloat16)
    kernel.launch_bwd(x, dt, A, B, C, 32, pr, torch.zeros_like(x),
                      which=which)
    [(name, args)] = fake_library.calls
    if which == "mma":
        assert name == "bwd-mma" and args[-7:] == (1, 64, 2, 32, 16, 32, 7)
    else:
        assert name == "bwd" and args[-2] == kernel.DTYPES[torch.bfloat16]


@pytest.mark.parametrize("status", [1, 700])
def test_bwd_mma_nonzero_status_raises(fake_library, status):
    """A non-zero status of the tensor-core backward raises with its code
    and the route's name."""
    fake_library.status = status
    x, dt, A, B, C = _zeros(1, 64, 2, 32, 16, "bfloat16")
    pr = torch.zeros(1, 2, 2, 32, 16, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match=f"mma launch failed .* CUDA "
                                           f"error {status}"):
        kernel.launch_bwd(x, dt, A, B, C, 32, pr, torch.zeros_like(x))
    assert [name for name, _ in fake_library.calls] == ["bwd-mma"]


def test_bwd_mma_takes_only_bf16(fake_library):
    """The tensor-core backward refuses f32 and an unknown name, and too
    much shared memory, before any launch."""
    x, dt, A, B, C = _zeros(1, 64, 2, 32, 16, "float32")
    pr = torch.zeros(1, 2, 2, 32, 16)
    with pytest.raises(TypeError):
        kernel.launch_bwd(x, dt, A, B, C, 32, pr, torch.zeros_like(x),
                          which="mma")
    xb, dtb, Ab, Bb, Cb = _zeros(1, 64, 2, 32, 16, "bfloat16")
    prb = pr.bfloat16()
    with pytest.raises(ValueError):
        kernel.launch_bwd(xb, dtb, Ab, Bb, Cb, 32, prb, torch.zeros_like(xb),
                          which="wgmma")
    fake_library.smem = kernel.MAX_SMEM_BYTES + 4
    with pytest.raises(ValueError, match="shared memory"):
        kernel.launch_bwd(xb, dtb, Ab, Bb, Cb, 32, prb, torch.zeros_like(xb))
    assert fake_library.calls == []


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_grad_route_counts_the_backward_by_kernel(fake_library, dtype):
    """One backward of the op moves ``bwd_launches`` by one and
    ``bwd_launches_by_kernel`` by one on the dtype's kernels only."""
    x, dt, A, B, C = _zeros(1, 64, 2, 16, 8, dtype)
    bwd = ssd_scan.bwd_launches
    by_kernel = dict(ssd_scan.bwd_launches_by_kernel)
    y, _ = ssd_scan(x.requires_grad_(True), dt, A, B, C, chunk=32)
    y.float().sum().backward()
    which = kernel.bwd_kernel_for(x.dtype)
    assert ssd_scan.bwd_launches == bwd + 1
    assert ssd_scan.bwd_launches_by_kernel == {
        k: c + (k == which) for k, c in by_kernel.items()}


def test_library_file_name_hashes_its_source_and_the_flags(monkeypatch):
    """A library's file name is ``lib<name>-<hash>.so``, the hash over its
    source and :data:`NVCC_FLAGS`: two libraries of one source share a
    file, and other flags make another. Nothing is compiled here."""
    from repro_torch.kernels import nvcc
    lib = kernel.BWD_LIBRARY
    same = nvcc.CudaLibrary("ssd_scan_bwd", lambda _: None)
    assert same.source == lib.source and same.path() == lib.path()
    assert lib.path().name.startswith("libssd_scan_bwd-")
    assert lib.path() != kernel.LIBRARY.path()
    before = lib.path()
    monkeypatch.setattr(nvcc, "NVCC_FLAGS",
                        tuple(f for f in nvcc.NVCC_FLAGS
                              if not f.startswith("--split-compile")))
    assert lib.path() != before


@pytest.mark.parametrize("fault", sorted(kernel.PLANTED_FAULTS))
@pytest.mark.parametrize("which", ["mma", "simt"])
def test_bwd_planted_fault_reaches_its_entry_point(fake_library, which,
                                                    fault):
    """A planted fault goes to ``ssd_scan_bwd_planted_launch`` on either
    route: the route's arguments and workspace, then the dtype code, the
    route (1 on the tensor cores) and the fault's code; an unknown fault
    is refused before any launch, and a non-zero status raises."""
    x, dt, A, B, C = _zeros(1, 64, 2, 32, 16, "bfloat16")
    pr = torch.zeros(1, 2, 2, 32, 16, dtype=torch.bfloat16)
    dy = torch.zeros_like(x)
    kernel.launch_bwd(x, dt, A, B, C, 32, pr, dy, which=which, fault=fault)
    [(name, args)] = fake_library.calls
    entry = "bwd-mma" if which == "mma" else "bwd"
    assert name == "bwd-planted"
    assert fake_library.ws_asked == [(entry, 1, 64, 2, 32, 16, 32)]
    assert args[0] == x.data_ptr() and args[7] == dy.data_ptr()
    assert args[16:] == (1, 64, 2, 32, 16, 32,
                         kernel.DTYPES[torch.bfloat16], int(which == "mma"),
                         kernel.PLANTED_FAULTS[fault], 7)
    with pytest.raises(ValueError, match="planted"):
        kernel.launch_bwd(x, dt, A, B, C, 32, pr, dy, which=which,
                          fault="decay")
    fake_library.status = 5
    with pytest.raises(RuntimeError, match="CUDA error 5"):
        kernel.launch_bwd(x, dt, A, B, C, 32, pr, dy, which=which,
                          fault=fault)
    assert len(fake_library.calls) == 2


def test_cpu_route_backpropagates():
    """On CPU tensors the op is the plain version (``ssd_chunked``),
    which autograd differentiates: finite, non-zero gradients reach x,
    dt, A, B, C and the initial state."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(1, 40, 2, 16, generator=g).requires_grad_()
    dt = (torch.rand(1, 40, 2, generator=g) * 0.1 + 0.01).requires_grad_()
    A = (-torch.rand(2, generator=g) - 0.5).requires_grad_()
    B = torch.randn(1, 40, 8, generator=g).requires_grad_()
    C = torch.randn(1, 40, 8, generator=g).requires_grad_()
    s0 = torch.randn(1, 2, 16, 8, generator=g).requires_grad_()
    y, s = ssd_scan(x, dt, A, B, C, chunk=16, init_state=s0)
    (y.sum() + s.square().sum()).backward()
    for t in (x, dt, A, B, C, s0):
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())
        assert float(t.grad.abs().max()) > 0.0


# ---------------------------------------------------------------------------
# The backward: its plain version against autograd and jax.grad
# ---------------------------------------------------------------------------

GRAD_NAMES = ("x", "dt", "A", "B", "C", "init_state")


def _grad_inputs(case, seed, with_init):
    """The case's inputs (``_inputs``) and, from the same generator, y's
    gradient and, ``with_init``, an initial state and the final state's
    gradient, as numpy arrays."""
    jx, tx, chunk, tol = _inputs(case, seed)
    b, l, h, p, n = case[:5]
    rng = np.random.default_rng(seed + 100)
    extra = {"dy": rng.standard_normal((b, l, h, p)).astype(np.float32)}
    if with_init:
        extra["init_state"] = (rng.standard_normal((b, h, p, n))
                               * 0.1).astype(np.float32)
        extra["dstate"] = rng.standard_normal((b, h, p, n)).astype(
            np.float32)
    return jx, tx, chunk, tol, extra


def _autograd_grads(tx, chunk, extra, dtype):
    """Gradients of ``sum(y dy) + sum(state dstate)`` by torch autograd of
    the port's ``ssd_chunked`` on ``dtype`` copies of the inputs (x, B, C
    kept in their own type when ``dtype`` is None)."""
    leaves = {k: (v.to(dtype) if dtype is not None else v)
              .detach().clone().requires_grad_(True) for k, v in tx.items()}
    init = None
    if "init_state" in extra:
        init = torch.from_numpy(extra["init_state"]).to(
            dtype or torch.float32).requires_grad_(True)
        leaves["init_state"] = init
    y, s = ssd_chunked(leaves["x"], leaves["dt"], leaves["A"], leaves["B"],
                       leaves["C"], chunk, init)
    loss = (y.double() * torch.from_numpy(extra["dy"]).double()).sum()
    if "dstate" in extra:
        loss = loss + (s.double()
                       * torch.from_numpy(extra["dstate"]).double()).sum()
    loss.backward()
    return {k: leaves[k].grad for k in GRAD_NAMES if k in leaves}


def _jax_grads(jx, chunk, extra):
    names = ["x", "dt", "A", "B", "C"] + (["init_state"] if "init_state"
                                          in extra else [])
    args = [jx[k] for k in names[:5]]
    if "init_state" in extra:
        args.append(jnp.asarray(extra["init_state"]))

    def loss(*a):
        init = a[5] if len(a) > 5 else None
        y, s = jax_ssd_chunked(*a[:5], chunk, init_state=init)
        out = jnp.sum(y.astype(jnp.float32) * extra["dy"])
        if "dstate" in extra:
            out = out + jnp.sum(s.astype(jnp.float32) * extra["dstate"])
        return out

    grads = jax.grad(loss, argnums=tuple(range(len(args))))(*args)
    return dict(zip(names, grads))


def _ref_grads(tx, chunk, extra, priors=None):
    init = dstate = None
    if "init_state" in extra:
        init = torch.from_numpy(extra["init_state"])
        dstate = torch.from_numpy(extra["dstate"])
    dy = torch.from_numpy(extra["dy"]).to(tx["x"].dtype)
    got = ssd_bwd_ref(tx["x"], tx["dt"], tx["A"], tx["B"], tx["C"], chunk,
                      dy, dstate, init, priors)
    return {k: g for k, g in zip(GRAD_NAMES, got) if g is not None}


def _grad_rel(got, want) -> float:
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                 1e-30))


@pytest.mark.parametrize("with_init", [False, True], ids=["zero", "init"])
@pytest.mark.parametrize("case", SSD_CASES, ids=IDS)
def test_bwd_ref_matches_autograd_and_jax_grad(case, with_init):
    """``ssd_bwd_ref`` gives each gradient of the chunked scan within 1e-5
    (f32) / 3e-2 (bf16) of its max |value| against torch autograd of the
    port's ``ssd_chunked`` (f64 for the f32 cases, the inputs' own type
    for bf16) and against ``jax.grad`` of the reference's ``ssd_chunked``
    on the same inputs; with an initial state, the final state's gradient
    flows in and the initial state's out."""
    jx, tx, chunk, tol, extra = _grad_inputs(case, 31, with_init)
    got = _ref_grads(tx, chunk, extra)
    assert set(got) == set(GRAD_NAMES[:5 + with_init])
    for k, g in got.items():
        want = tx[k].dtype if k != "init_state" else torch.float32
        assert g.dtype == want and g.shape == (
            tx[k].shape if k != "init_state" else extra[k].shape), k
    f32 = case[-1] == "float32"
    oracle = _autograd_grads(tx, chunk, extra,
                             torch.float64 if f32 else None)
    jgrads = _jax_grads(jx, chunk, extra)
    for k, g in got.items():
        assert _grad_rel(g, oracle[k]) <= tol, ("autograd", k)
        assert _grad_rel(g, jgrads[k]) <= tol, ("jax.grad", k)


@pytest.mark.parametrize("chunk", [16, 40, 96])
def test_bwd_ref_padded_tail_and_given_priors(chunk):
    """l = 96 at chunks that leave a padded tail (40) or none: the tail's
    seg_last terms flow into the real positions before it; the priors
    the forward kernel would write (``ssd_priors_ref``) give the same
    gradients as priors recomputed inside."""
    case = (2, 96, 3, 16, 8, chunk, "float32")
    _, tx, _, _, extra = _grad_inputs(case, 32, True)
    init = torch.from_numpy(extra["init_state"])
    priors = ssd_priors_ref(tx["x"], tx["dt"], tx["A"], tx["B"], tx["C"],
                            chunk, init)
    assert priors.shape == (2, 3, -(-96 // chunk), 16, 8)
    assert torch.equal(priors[:, :, 0], init)
    got = _ref_grads(tx, chunk, extra, priors=priors)
    again = _ref_grads(tx, chunk, extra)
    oracle = _autograd_grads(tx, chunk, extra, torch.float64)
    for k, g in got.items():
        assert torch.equal(g, again[k]), k
        assert _grad_rel(g, oracle[k]) <= 1e-5, k


def test_bwd_ref_strong_decay_gives_no_nan():
    """A = -50 overflows exp(seg_q - seg_k) above the diagonal. The mask
    is a select, so no NaN reaches a gradient of ``ssd_bwd_ref`` nor of
    the port's ``ssd_chunked``, which selects before the exp; the
    reference's ``ssd_chunked`` selects after it, and ``jax.grad`` gives
    NaN for dt and A there (ROADMAP C3), while its y and its other
    gradients agree."""
    jx, tx, _, _, extra = _grad_inputs((1, 256, 2, 16, 16, 256, "float32"),
                                       33, False)
    tx["A"] = torch.tensor([-50.0, -1.0])
    tx["dt"] = torch.full_like(tx["dt"], 0.1)
    jx["A"], jx["dt"] = jnp.asarray(tx["A"].numpy()), jnp.asarray(
        tx["dt"].numpy())
    got = _ref_grads(tx, 256, extra)
    oracle = _autograd_grads(tx, 256, extra, torch.float64)
    jgrads = _jax_grads(jx, 256, extra)
    for k, g in got.items():
        assert bool(torch.isfinite(g).all()), k
        assert _grad_rel(g, oracle[k]) <= 1e-5, k
        if k in ("dt", "A"):
            assert bool(np.isnan(np.asarray(jgrads[k])).any()), k
        else:
            assert _grad_rel(g, jgrads[k]) <= 1e-5, k


# (b, l, h, p, n, chunk, dtype), with an initial state and dstate or not
BWD_CUDA_CASES = [
    ((2, 128, 4, 16, 32, 32, "float32"), False),
    ((1, 96, 2, 64, 128, 32, "float32"), True),       # unaligned l
    ((1, 128, 2, 32, 32, 32, "bfloat16"), False),
    ((2, 300, 3, 64, 16, 128, "bfloat16"), True),     # ragged last chunk
    ((1, 100, 2, 128, 5, 48, "float32"), True),       # n = 5, chunk 48
]


@pytest.mark.parametrize("case,with_init", BWD_CUDA_CASES,
                         ids=["f32", "unaligned-l", "bf16", "ragged-bf16",
                              "n5"])
def test_cuda_backward_matches_plain(case, with_init, cuda_device):
    """The backward kernels through the op on the card against
    ``ssd_bwd_ref`` on the CPU from the same inputs: each gradient within
    1e-5 (f32) / 3e-2 (bf16) of its max |value|; one backward launch,
    on the dtype's kernels (bf16 the tensor-core route); two launches
    bit-identical. bf16 also through the CUDA-core route by name."""
    _, tx, chunk, tol, extra = _grad_inputs(case, 34, with_init)
    want = _ref_grads(tx, chunk, extra)
    leaves = {k: v.to(cuda_device).requires_grad_(True)
              for k, v in tx.items()}
    init = dstate = None
    if with_init:
        init = torch.from_numpy(extra["init_state"]).to(
            cuda_device).requires_grad_(True)
        leaves["init_state"] = init
        dstate = torch.from_numpy(extra["dstate"]).to(cuda_device)
    dy = torch.from_numpy(extra["dy"]).to(cuda_device, tx["x"].dtype)
    bwd = ssd_scan.bwd_launches
    by_kernel = dict(ssd_scan.bwd_launches_by_kernel)
    which = kernel.bwd_kernel_for(tx["x"].dtype)
    y, s = ssd_scan(leaves["x"], leaves["dt"], leaves["A"], leaves["B"],
                    leaves["C"], chunk=chunk, init_state=init)
    grads = torch.autograd.grad(
        [y, s] if with_init else [y], list(leaves.values()),
        [dy, dstate.to(s.dtype)] if with_init else [dy], retain_graph=True)
    again = torch.autograd.grad(
        [y, s] if with_init else [y], list(leaves.values()),
        [dy, dstate.to(s.dtype)] if with_init else [dy])
    assert ssd_scan.bwd_launches == bwd + 2
    assert ssd_scan.bwd_launches_by_kernel == {
        k: c + 2 * (k == which) for k, c in by_kernel.items()}
    for name, g, g2 in zip(leaves, grads, again):
        assert torch.equal(g, g2), name
        assert _grad_rel(g.cpu(), want[name]) <= tol, name
    if which == "mma":
        x, dt, A, B, C = (leaves[k].detach() for k in ("x", "dt", "A", "B",
                                                       "C"))
        _, _, pr = kernel.launch(x, dt, A, B, C, chunk,
                                 None if init is None else init.detach(),
                                 with_priors=True)
        simt = kernel.launch_bwd(
            x, dt, A, B, C, chunk, pr, dy, dstate,
            dinit_dtype=torch.float32 if with_init else None, which="simt")
        for name, g in zip(GRAD_NAMES, simt):
            if g is not None:
                assert _grad_rel(g.cpu(), want[name]) <= tol, name
