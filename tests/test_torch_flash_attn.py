"""The port's attention kernel op against the JAX package's.

The same numpy inputs go through the JAX ``flash_attention`` (the
Pallas kernel in interpret mode and the ``jnp`` route, as
``tests/test_kernels.py`` runs them on the CPU) and its ``attention_ref``
oracle, and through the port's ``flash_attention`` on CPU tensors, which
runs the plain version (``_blockwise_attention``), and the port's
``attention_ref``. Tolerances are the JAX test's: 2e-5 in f32, 2e-2 in
bf16 (summation order and bf16 rounding points differ between XLA and
torch). The CUDA kernels run only on the card: their tests skip here, and
``chip_smoke.py`` holds them against the plain version there. What
surrounds them -- which kernel a dtype takes, the arguments each entry
point gets, the counters, a failed launch -- is tested here against a
fake library in place of the built one.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attn.ops import flash_attention as jax_flash
from repro.kernels.flash_attn.ref import attention_ref as jax_attention_ref
from repro_torch.kernels.flash_attn import attention_ref, flash_attention
from repro_torch.kernels.flash_attn import kernel
from repro_torch.kernels.flash_attn import ops as fa_ops

# (b, sq, skv, h, kh, d, causal, dtype): tests/test_kernels.py's ATTN_CASES
ATTN_CASES = [
    (2, 256, 256, 4, 2, 64, True, "float32"),
    (1, 128, 128, 8, 8, 32, True, "float32"),     # MHA
    (1, 128, 128, 8, 1, 64, True, "float32"),     # MQA
    (2, 192, 192, 6, 2, 64, True, "bfloat16"),    # bf16 + unaligned
    (1, 64, 320, 4, 2, 64, True, "float32"),      # kv longer (decode-ish)
    (1, 256, 256, 4, 4, 128, False, "float32"),   # non-causal
]
IDS = ["gqa", "mha", "mqa", "bf16-unaligned", "kv-longer", "non-causal"]
# stablelm-12b's head dim, 160 (GQA group 4, a ragged last q tile)
D160_CASES = [(1, 200, 200, 8, 2, 160, True, dt)
              for dt in ("float32", "bfloat16")]
D160_IDS = ["d160-f32", "d160-bf16"]
# on the card: a bf16 twin of each f32 case (the tensor-core kernel), head
# dim 16 and head dim 160
CUDA_CASES = ATTN_CASES + [c[:7] + ("bfloat16",) for c in ATTN_CASES
                           if c[7] == "float32"] + [
    (1, 128, 128, 4, 2, 16, True, "bfloat16")] + D160_CASES
CUDA_IDS = IDS + [f"{i}-bf16" for i, c in zip(IDS, ATTN_CASES)
                  if c[7] == "float32"] + ["d16-bf16"] + D160_IDS


def _inputs(case, seed):
    b, sq, skv, h, kh, d, causal, dt = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, kh, d)).astype(np.float32)
    jax_in = [jnp.asarray(a, dt) for a in (q, k, v)]
    torch_in = [torch.from_numpy(a).to(getattr(torch, dt)) for a in (q, k, v)]
    return jax_in, torch_in, causal, (2e-2 if dt == "bfloat16" else 2e-5)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t.astype(jnp.float32))


@pytest.mark.parametrize("case", ATTN_CASES + D160_CASES,
                         ids=IDS + D160_IDS)
def test_plain_version_matches_jax_paths(case):
    (jq, jk, jv), (q, k, v), causal, tol = _inputs(case, seed=11)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, block_q=64, block_k=64)
    assert flash_attention.launches == before
    assert out.dtype == q.dtype and out.shape == q.shape
    want = {
        "ref": jax_attention_ref(jq, jk, jv, causal),
        "pallas_interpret": jax_flash(jq, jk, jv, causal=causal, block_q=64,
                                      block_k=64, force="pallas_interpret"),
        "jnp": jax_flash(jq, jk, jv, causal=causal, block_q=64, block_k=64,
                         force="jnp"),
    }
    for name, w in want.items():
        np.testing.assert_allclose(_np(out), _np(w), atol=tol, rtol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("case", ATTN_CASES, ids=IDS)
def test_oracle_matches_jax_oracle(case):
    (jq, jk, jv), (q, k, v), causal, tol = _inputs(case, seed=12)
    np.testing.assert_allclose(_np(attention_ref(q, k, v, causal)),
                               _np(jax_attention_ref(jq, jk, jv, causal)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("blocks", [(32, 32), (64, 128), (512, 512)])
def test_plain_version_block_sizes(blocks):
    """The plain version's answer does not depend on its tiles."""
    _, (q, k, v), causal, tol = _inputs(ATTN_CASES[4], seed=13)
    out = flash_attention(q, k, v, causal=causal, block_q=blocks[0],
                          block_k=blocks[1])
    np.testing.assert_allclose(_np(out), _np(attention_ref(q, k, v, causal)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("case", ["rank", "batch", "heads", "dtype-mix",
                                  "dtype", "head-dim", "causal-short-kv",
                                  "empty"])
def test_kernel_wrapper_rejects_bad_inputs(case):
    """What the CUDA kernel does not take raises before any launch (the
    checks run on any device, so they are tested here)."""
    q = torch.zeros(1, 8, 4, 64)
    k = torch.zeros(1, 8, 2, 64)
    args = {
        "rank": (q[0], k, k), "batch": (q, torch.zeros(2, 8, 2, 64),
                                        torch.zeros(2, 8, 2, 64)),
        "heads": (q, torch.zeros(1, 8, 3, 64), torch.zeros(1, 8, 3, 64)),
        "dtype-mix": (q, k.bfloat16(), k.bfloat16()),
        "dtype": (q.half(), k.half(), k.half()),
        "head-dim": (torch.zeros(1, 8, 4, 48), torch.zeros(1, 8, 2, 48),
                     torch.zeros(1, 8, 2, 48)),
        "causal-short-kv": (q, k[:, :4], k[:, :4]),
        "empty": (q[:, :0], k[:, :0], k[:, :0]),
    }[case]
    err = TypeError if case.startswith("dtype") else ValueError
    with pytest.raises(err):
        kernel.check_inputs(*args, causal=True)


@pytest.mark.parametrize("d", [20, 96, 256])
def test_uninstantiated_head_dims_name_the_contract(d):
    """A head dim with no instantiation raises before any launch, saying
    that the JAX kernel takes any D and where the gap is tracked."""
    q = torch.zeros(1, 8, 2, d)
    with pytest.raises(ValueError, match="any D.*ROADMAP"):
        kernel.check_inputs(q, q, q, causal=True)


def test_other_devices_raise():
    q = torch.zeros(1, 8, 4, 64, device="meta")
    with pytest.raises(ValueError):
        flash_attention(q, q, q)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode "
                    "(chip_smoke.py runs it against the plain version)")
    return torch.device("cuda")


@pytest.mark.parametrize("case", CUDA_CASES, ids=CUDA_IDS)
def test_cuda_kernel_matches_plain(case, cuda_device):
    _, (q, k, v), causal, tol = _inputs(case, seed=14)
    before = flash_attention.launches
    by_kernel = dict(flash_attention.launches_by_kernel)
    got = flash_attention(q.to(cuda_device), k.to(cuda_device),
                          v.to(cuda_device), causal=causal)
    assert flash_attention.launches == before + 1
    which = "mma" if q.dtype == torch.bfloat16 else "simt"
    assert flash_attention.launches_by_kernel[which] == by_kernel[which] + 1
    want = flash_attention(q, k, v, causal=causal, block_q=64, block_k=64)
    np.testing.assert_allclose(_np(got.cpu()), _np(want), atol=tol, rtol=tol)


class FakeLibrary:
    """Stands in for the built libraries (forward and backward): records
    each entry point's arguments and returns ``status``."""

    def __init__(self, status=0):
        self.status = status
        self.calls = []

    def flash_attn_mma_launch(self, *args):
        self.calls.append(("mma", args))
        return self.status

    def flash_attn_launch(self, *args):
        self.calls.append(("simt", args))
        return self.status

    def flash_attn_mma_lse_launch(self, *args):
        self.calls.append(("mma-lse", args))
        return self.status

    def flash_attn_lse_launch(self, *args):
        self.calls.append(("simt-lse", args))
        return self.status

    def flash_attn_bwd_launch(self, *args):
        self.calls.append(("bwd", args))
        return self.status

    def flash_attn_bwd_mma_launch(self, *args):
        self.calls.append(("bwd-mma", args))
        return self.status

    def flash_attn_error_string(self, code):
        return b"fake failure"

    flash_attn_bwd_error_string = flash_attn_error_string


@contextlib.contextmanager
def _no_card(dev):
    yield 7                              # a stream handle


@pytest.fixture
def fake_library(monkeypatch):
    """The CUDA route of the op, on CPU tensors, into a fake library."""
    lib = FakeLibrary()
    monkeypatch.setattr(fa_ops, "_route", lambda t: "cuda")
    monkeypatch.setattr(kernel, "load", lambda: lib)
    monkeypatch.setattr(kernel, "load_bwd", lambda: lib)
    monkeypatch.setattr(kernel, "on_card", _no_card)
    return lib


@pytest.mark.parametrize("d", kernel.HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dtype_picks_the_kernel_and_its_arguments(fake_library, d, dtype):
    """bf16 calls the tensor-core entry point, f32 the CUDA-core one, each
    with the shapes, the f32 scale 1/sqrt(D), the mask flag and the stream;
    the total and the per-kernel counters move by one."""
    dt = getattr(torch, dtype)
    q = torch.zeros(2, 96, 6, d, dtype=dt)
    k = torch.zeros(2, 160, 3, d, dtype=dt)
    total = flash_attention.launches
    by_kernel = dict(flash_attention.launches_by_kernel)
    out = flash_attention(q, k, k.clone(), causal=True)
    assert out.shape == q.shape and out.dtype == dt
    [(which, args)] = fake_library.calls
    assert which == ("mma" if dtype == "bfloat16" else "simt")
    assert args[4:11] == (2, 96, 160, 6, 3, d, 1)
    assert args[11] == pytest.approx(1.0 / np.sqrt(d), rel=1e-7)
    assert args[0] == q.data_ptr() and args[3] == out.data_ptr()
    if which == "mma":
        assert args[12:] == (7,)
    else:
        assert args[12:] == (kernel.DTYPES[dt], 7)
    assert flash_attention.launches == total + 1
    assert flash_attention.launches_by_kernel == {
        n: c + (n == which) for n, c in by_kernel.items()}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_nonzero_launch_status_raises(fake_library, dtype):
    fake_library.status = 9
    q = torch.zeros(1, 64, 2, 32, dtype=getattr(torch, dtype))
    total = flash_attention.launches
    by_kernel = dict(flash_attention.launches_by_kernel)
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        flash_attention(q, q, q, causal=False)
    assert flash_attention.launches == total
    assert flash_attention.launches_by_kernel == by_kernel


def test_tensor_core_kernel_takes_only_bf16(fake_library):
    q = torch.zeros(1, 64, 2, 32)
    with pytest.raises(TypeError):
        kernel.launch(q, q, q, True, "mma")
    with pytest.raises(TypeError):
        kernel.kernel_for(torch.float16)
    assert fake_library.calls == []


def test_reset_counts():
    fa_ops.reset_counts()
    assert flash_attention.launches == 0
    assert flash_attention.launches_by_kernel == {"mma": 0, "simt": 0}
    assert flash_attention.bwd_launches == 0
    assert flash_attention.bwd_launches_by_kernel == {"mma": 0, "simt": 0}


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_cuda_route_refuses_grad(fake_library, which):
    """The contract C1 left (ROADMAP C) is now the gradient: on the CUDA
    route, with grad mode on and an input that requires grad, the op
    launches the forward entry point that writes lse (once), and
    ``backward()`` launches the backward entry point once, asking for
    dq only when q requires grad and for dk / dv only when k or v does;
    the gradient reaches only the inputs that require it. Under
    ``no_grad`` / ``inference_mode`` the same call launches the plain
    forward entry point, as before."""
    t = {n: torch.randn(1, 64, 2, 32) for n in "qkv"}
    t[which].requires_grad_(True)
    total = flash_attention.launches
    bwd = flash_attention.bwd_launches
    out = flash_attention(t["q"], t["k"], t["v"], causal=False)
    assert out.requires_grad and out.shape == t["q"].shape
    assert [w for w, _ in fake_library.calls] == ["simt-lse"]
    assert flash_attention.launches == total + 1
    assert flash_attention.bwd_launches == bwd
    out.backward(torch.ones_like(out))
    [(name, args)] = fake_library.calls[1:]
    assert name == "bwd" and flash_attention.bwd_launches == bwd + 1
    assert (args[6] != 0) == (which == "q")                   # dq
    assert (args[7] != 0) == (args[8] != 0) == (which != "q")  # dk, dv
    for n in "qkv":
        assert (t[n].grad is not None) == (n == which)
    assert t[which].grad.shape == t[which].shape
    with torch.no_grad():
        flash_attention(t["q"], t["k"], t["v"], causal=False)
    with torch.inference_mode():
        flash_attention(t["q"], t["k"], t["v"], causal=True)
    assert [w for w, _ in fake_library.calls[2:]] == ["simt", "simt"]
    assert flash_attention.launches == total + 3


@pytest.mark.parametrize("causal", [True, False])
def test_cpu_route_backpropagates(causal):
    """On CPU tensors the op is the plain version, which autograd
    differentiates: finite, non-zero gradients reach q, k and v."""
    q, k, v = (torch.randn(1, 48, 4, 16, requires_grad=True)
               for _ in range(3))
    out = flash_attention(q, k, v, causal=causal, block_q=16, block_k=16)
    (out * torch.randn_like(out)).sum().backward()
    for t in (q, k, v):
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())
        assert float(t.grad.abs().max()) > 0.0


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_grad_route_launches_the_lse_entry(fake_library, dtype):
    """A call that autograd will differentiate takes the dtype's kernel
    through its lse entry point, with the lse buffer (B, H, Sq) f32 after
    the output and otherwise the arguments of the plain entry point."""
    dt = getattr(torch, dtype)
    q = torch.zeros(2, 96, 6, 64, dtype=dt, requires_grad=True)
    k = torch.zeros(2, 160, 3, 64, dtype=dt)
    by_kernel = dict(flash_attention.launches_by_kernel)
    out, lse = kernel.launch(q.detach(), k, k.clone(), True, with_lse=True)
    assert lse.shape == (2, 6, 96) and lse.dtype == torch.float32
    flash_attention(q, k, k.clone(), causal=True)
    [(_, a1), (which, args)] = fake_library.calls
    assert which == ("mma-lse" if dtype == "bfloat16" else "simt-lse")
    assert args[5:12] == (2, 96, 160, 6, 3, 64, 1)
    assert args[12] == pytest.approx(1.0 / 8.0, rel=1e-7)
    assert args[13:] == ((7,) if dtype == "bfloat16"
                         else (kernel.DTYPES[dt], 7))
    kind = "mma" if dtype == "bfloat16" else "simt"
    assert flash_attention.launches_by_kernel[kind] == by_kernel[kind] + 1


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_backward_entry_arguments(fake_library, dtype, causal):
    """Each dtype reaches its backward entry point: bf16 the tensor-core
    one (no dtype argument), f32 the CUDA-core one. Each gets q, k, v,
    the output, lse, a contiguous dout (autograd may pass a strided one),
    dq / dk / dv and the Dv scratch, the shapes, the mask flag, the f32
    scale, (f32: the dtype) and the stream; dq / dk / dv come back in the
    inputs' shapes and dtype, and the backward counter of that kernel
    moves by one."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(24)
    q = torch.randn(2, 40, 4, 32, generator=gen).to(dt).requires_grad_(True)
    k = torch.randn(2, 56, 2, 32, generator=gen).to(dt).requires_grad_(True)
    v = torch.randn(2, 56, 2, 32, generator=gen).to(dt).requires_grad_(True)
    out = flash_attention(q, k, v, causal=causal)
    strided = torch.randn(2, 4, 40, 32, generator=gen).to(dt).permute(
        0, 2, 1, 3)
    assert not strided.is_contiguous()
    by_kernel = dict(flash_attention.bwd_launches_by_kernel)
    out.backward(strided)
    (name, args) = fake_library.calls[-1]
    which = kernel.bwd_kernel_for(dt)
    assert which == ("mma" if dtype == "bfloat16" else "simt")
    assert name == ("bwd-mma" if which == "mma" else "bwd")
    assert args[10:17] == (2, 40, 56, 4, 2, 32, int(causal))
    assert args[17] == pytest.approx(1.0 / np.sqrt(32), rel=1e-7)
    assert args[18:] == ((7,) if which == "mma"
                         else (kernel.DTYPES[dt], 7))
    assert args[5] != strided.data_ptr()          # a contiguous copy
    assert all(a != 0 for a in args[:10])
    for t in (q, k, v):
        assert t.grad.shape == t.shape and t.grad.dtype == dt
    assert flash_attention.bwd_launches_by_kernel == {
        n: c + (n == which) for n, c in by_kernel.items()}


@pytest.mark.parametrize("which", ["mma", "simt"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_backward_kernel_by_name(fake_library, dtype, which):
    """``launch_bwd(..., which=)``: "simt" on bf16 reaches the CUDA-core
    entry point with the bf16 dtype code (the timing yardstick), "mma"
    on f32 raises ``TypeError`` before any launch, and a name that is no
    kernel raises ``ValueError``."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(24)
    q = torch.randn(1, 40, 4, 32, generator=gen).to(dt)
    k = torch.randn(1, 48, 2, 32, generator=gen).to(dt)
    lse = torch.zeros(1, 4, 40)
    if which == "mma" and dtype == "float32":
        with pytest.raises(TypeError, match="bfloat16"):
            kernel.launch_bwd(q, k, k, q, lse, q, True, which=which)
        assert fake_library.calls == []
        return
    dq, dk, dv = kernel.launch_bwd(q, k, k, q, lse, q, True, which=which)
    [(name, args)] = fake_library.calls
    assert name == ("bwd-mma" if which == "mma" else "bwd")
    assert args[10:17] == (1, 40, 48, 4, 2, 32, 1)
    assert args[17] == pytest.approx(1.0 / np.sqrt(32), rel=1e-7)
    assert args[18:] == ((7,) if which == "mma"
                         else (kernel.DTYPES[dt], 7))
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, k.shape)
    assert dq.dtype == dk.dtype == dv.dtype == dt
    with pytest.raises(ValueError, match="no flash_attn kernel"):
        kernel.launch_bwd(q, k, k, q, lse, q, True, which="wgmma")
    assert len(fake_library.calls) == 1


def test_backward_kernel_for_each_dtype():
    """The one place the backward's kernel is chosen: bf16 on the tensor
    cores, f32 on the CUDA cores, other dtypes refused."""
    assert kernel.bwd_kernel_for(torch.bfloat16) == "mma"
    assert kernel.bwd_kernel_for(torch.float32) == "simt"
    with pytest.raises(TypeError):
        kernel.bwd_kernel_for(torch.float16)


def test_nonzero_backward_status_raises(fake_library):
    q = torch.randn(1, 64, 2, 32, requires_grad=True)
    out = flash_attention(q, q.detach(), q.detach(), causal=False)
    fake_library.status = 9
    bwd = flash_attention.bwd_launches
    with pytest.raises(RuntimeError, match="backward launch failed.*9"):
        out.sum().backward()
    assert flash_attention.bwd_launches == bwd


def test_backward_checks_its_inputs(fake_library):
    q = torch.zeros(1, 8, 4, 64)
    k = torch.zeros(1, 8, 2, 64)
    lse = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="lse"):
        kernel.launch_bwd(q, k, k, q, lse[..., :4], q, True)
    with pytest.raises(ValueError, match="dout"):
        kernel.launch_bwd(q, k, k, q, lse, q[:, :4], True)
    assert fake_library.calls == []


@pytest.mark.parametrize("case", CUDA_CASES, ids=CUDA_IDS)
def test_cuda_backward_matches_plain(case, cuda_device):
    """On the card: the backward kernels' dq, dk, dv against the explicit
    plain version on the kernel's own lse and output (f32 at 1e-5, bf16
    at 2e-2 of each gradient's max |value|); in bf16 both the tensor-core
    kernels (the dtype's) and the CUDA-core ones, and two launches of the
    tensor-core ones are bit-identical."""
    from repro_torch.kernels.flash_attn.ref import attention_bwd_ref
    _, (q, k, v), causal, _ = _inputs(case, seed=15)
    q, k, v = (t.to(cuda_device) for t in (q, k, v))
    gen = torch.Generator().manual_seed(16)
    do = torch.randn(q.shape, generator=gen).to(cuda_device, q.dtype)
    out, lse = kernel.launch(q, k, v, causal, with_lse=True)
    want = attention_bwd_ref(q, k, v, out, lse, do, causal)
    tol = 2e-2 if q.dtype == torch.bfloat16 else 1e-5
    kinds = ["mma", "simt"] if q.dtype == torch.bfloat16 else ["simt"]
    for which in kinds:
        got = kernel.launch_bwd(q, k, v, out, lse, do, causal, which=which)
        for g, w in zip(got, want):
            err = float((g.float() - w.float()).abs().max())
            assert err <= tol * float(w.float().abs().max())
    if "mma" in kinds:
        first = kernel.launch_bwd(q, k, v, out, lse, do, causal)
        second = kernel.launch_bwd(q, k, v, out, lse, do, causal)
        assert all(torch.equal(a, b) for a, b in zip(first, second))
