"""The port's attention kernel op against the JAX package's.

The same numpy inputs go through the JAX ``flash_attention`` (the
Pallas kernel in interpret mode and the ``jnp`` route, as
``tests/test_kernels.py`` runs them on the CPU) and its ``attention_ref``
oracle, and through the port's ``flash_attention`` on CPU tensors, which
runs the plain version (``_blockwise_attention``), and the port's
``attention_ref``. Tolerances are the JAX test's: 2e-5 in f32, 2e-2 in
bf16 (summation order and bf16 rounding points differ between XLA and
torch). The CUDA kernel runs only on the card: its test skips here, and
``chip_smoke.py`` holds it against the plain version there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attn.ops import flash_attention as jax_flash
from repro.kernels.flash_attn.ref import attention_ref as jax_attention_ref
from repro_torch.kernels.flash_attn import attention_ref, flash_attention
from repro_torch.kernels.flash_attn import kernel

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


@pytest.mark.parametrize("case", ATTN_CASES, ids=IDS)
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


@pytest.mark.parametrize("case", ATTN_CASES, ids=IDS)
def test_cuda_kernel_matches_plain(case, cuda_device):
    _, (q, k, v), causal, tol = _inputs(case, seed=14)
    before = flash_attention.launches
    got = flash_attention(q.to(cuda_device), k.to(cuda_device),
                          v.to(cuda_device), causal=causal)
    assert flash_attention.launches == before + 1
    want = flash_attention(q, k, v, causal=causal, block_q=64, block_k=64)
    np.testing.assert_allclose(_np(got.cpu()), _np(want), atol=tol, rtol=tol)
