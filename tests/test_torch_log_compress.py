"""The port's log-dump compressor against the JAX package's.

The same numpy inputs go through the JAX ``compress`` / ``decompress``
(the Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs
it on the CPU, and the ``jnp`` reference) and through the port's public
ops on CPU tensors, which run the plain torch version. Codes and scales
must be ``==``. Decompression is held at the JAX test's bound (half a
quantization step per block) and to the JAX value within the rounding
of the product: XLA on the CPU contracts ``base + code * scale`` into
one FMA, while the port rounds the product first (its kernel and its
plain version alike, so those two are ``==`` each other on the card).
The CUDA kernels run only on the card: their test skips here, and
``chip_smoke.py`` holds them against the plain version there.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.log_compress import compress as jax_compress
from repro.kernels.log_compress import decompress as jax_decompress
from repro.kernels.log_compress.ref import compress_ref as jax_compress_ref
from repro.kernels.log_compress.ref import \
    decompress_ref as jax_decompress_ref
from repro_torch.kernels.log_compress import (compress, compress_ref,
                                              compression_factor, decompress,
                                              decompress_ref)
from repro_torch.kernels.log_compress import ops

SIZES = [1, 256, 1000, 4096, 12345]


def _inputs(n, seed, zero_rows=False):
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal(n).astype(np.float32)
    base = (vals + rng.standard_normal(n) * 0.02).astype(np.float32)
    if zero_rows:                       # every other 256-word row unchanged
        for r in range(0, -(-n // 256), 2):
            base[r * 256:(r + 1) * 256] = vals[r * 256:(r + 1) * 256]
    return vals, base


def _within_product_rounding(out, want, codes, scales):
    """|out - want| within half an ulp of ``code * scale`` plus one
    rounding of the sum: what separates an FMA from mul-then-add."""
    prod = codes.astype(np.float32) * scales.astype(np.float32)
    tol = np.spacing(np.abs(prod)).reshape(-1)[:out.size] \
        + np.spacing(np.abs(want))
    assert (np.abs(out - want) <= tol).all()


def _jax(vals, base, bits, use_pallas):
    codes, scales = jax_compress(jnp.asarray(vals), jnp.asarray(base),
                                 bits=bits, use_pallas=use_pallas)
    rec = jax_decompress(codes, scales, jnp.asarray(base), len(vals),
                         use_pallas=use_pallas)
    return np.asarray(codes), np.asarray(scales), np.asarray(rec)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("zero_rows", [False, True], ids=["dense",
                                                          "zero-rows"])
def test_port_matches_pallas_interpret_and_ref(n, bits, zero_rows):
    vals, base = _inputs(n, seed=n * 10 + bits, zero_rows=zero_rows)
    codes, scales = compress(torch.from_numpy(vals), torch.from_numpy(base),
                             bits=bits)
    rec = decompress(codes, scales, torch.from_numpy(base), n).numpy()
    bound = float(scales.max()) * 0.51
    assert np.max(np.abs(rec - vals)) <= bound
    for use_pallas in (True, False):
        j_codes, j_scales, j_rec = _jax(vals, base, bits, use_pallas)
        assert codes.dtype == torch.int8 and scales.dtype == torch.float32
        assert np.array_equal(codes.numpy(), j_codes), use_pallas
        assert np.array_equal(scales.numpy(), j_scales), use_pallas
        assert np.max(np.abs(rec - j_rec)) <= bound
        _within_product_rounding(rec, j_rec, j_codes, j_scales)


def test_all_zero_delta_rows():
    vals = np.tile(np.linspace(-3, 3, 256, dtype=np.float32), 8)
    codes, scales = compress(torch.from_numpy(vals), torch.from_numpy(vals))
    j_codes, j_scales, _ = _jax(vals, vals, 8, True)
    assert not codes.any() and torch.equal(scales, torch.ones(8, 1))
    assert np.array_equal(codes.numpy(), j_codes)
    assert np.array_equal(scales.numpy(), j_scales)
    rec = decompress(codes, scales, torch.from_numpy(vals), vals.size)
    assert np.array_equal(rec.numpy(), vals)


def test_bf16_input_cast_to_f32():
    vals, base = _inputs(3000, seed=7)
    tv = torch.from_numpy(vals).bfloat16()
    tb = torch.from_numpy(base).bfloat16()
    codes, scales = compress(tv, tb)
    j_codes, j_scales = jax_compress(jnp.asarray(vals, jnp.bfloat16),
                                     jnp.asarray(base, jnp.bfloat16))
    assert np.array_equal(codes.numpy(), np.asarray(j_codes))
    assert np.array_equal(scales.numpy(), np.asarray(j_scales))
    rec = decompress(codes, scales, tb, 3000)
    assert rec.dtype == torch.float32 and rec.shape == (3000,)


def test_plain_version_matches_jnp_ref_on_rows():
    """Against the ``jnp`` reference jitted, as the package's ops run it:
    under ``jit`` XLA computes ``amax / qmax`` as ``amax * (1 / qmax)``
    (op-by-op it divides), and the port follows the jitted op."""
    vals, base = _inputs(8 * 256 * 3, seed=1)
    v2d, b2d = vals.reshape(-1, 256), base.reshape(-1, 256)
    jref = jax.jit(jax_compress_ref, static_argnames=("block", "bits"))
    for bits in (8, 4):
        codes, scales = compress_ref(torch.from_numpy(v2d),
                                     torch.from_numpy(b2d), bits=bits)
        j_codes, j_scales = jref(jnp.asarray(v2d), jnp.asarray(b2d),
                                 bits=bits)
        assert np.array_equal(codes.numpy(), np.asarray(j_codes))
        assert np.array_equal(scales.numpy(), np.asarray(j_scales))
        out = decompress_ref(codes, scales, torch.from_numpy(b2d)).numpy()
        j_out = np.asarray(jax_decompress_ref(j_codes, j_scales,
                                              jnp.asarray(b2d)))
        _within_product_rounding(out.reshape(-1), j_out.reshape(-1),
                                 np.asarray(j_codes), np.asarray(j_scales))
        # the port rounds the product first: == numpy's unfused f32 sum
        want = b2d + codes.numpy().astype(np.float32) * scales.numpy()
        assert np.array_equal(out, want)


@pytest.mark.parametrize("fill", [1e-40, -3e-39, 1.4e-45])
def test_subnormal_round_trip_is_exact(fill):
    """The port's contract: IEEE subnormals are kept, so a zero delta
    reconstructs a subnormal value exactly (XLA on the CPU flushes it to
    zero; the CUDA kernel is built without -ftz)."""
    vals = torch.full((1500,), fill, dtype=torch.float32)
    codes, scales = compress(vals, vals)
    assert not codes.any()
    rec = decompress(codes, scales, vals, 1500)
    assert torch.equal(rec, vals) and float(rec[0]) != 0.0


def test_subnormal_deltas_quantize_like_normal_ones():
    rng = np.random.default_rng(3)
    base = (rng.standard_normal(2048) * 1e-39).astype(np.float32)
    vals = (base + rng.standard_normal(2048) * 1e-41).astype(np.float32)
    codes, scales = compress(torch.from_numpy(vals), torch.from_numpy(base))
    assert (scales > 0).all() and (scales < 1.2e-38).all()
    assert codes.abs().max() == 127
    rec = decompress(codes, scales, torch.from_numpy(base), 2048).numpy()
    assert np.max(np.abs(rec - vals)) <= float(scales.max()) * 0.51


def test_compression_factor():
    assert compression_factor(8) == ops.compression_factor(8) == 8192 / 2080
    assert compression_factor(4) == 8192 / 1056
    assert 3.5 < compression_factor(8) < 4.0 and 7.0 < compression_factor(4)


def test_cpu_path_counts_no_launch():
    vals, base = _inputs(512, seed=2)
    before = (compress.launches, decompress.launches)
    c, s = compress(torch.from_numpy(vals), torch.from_numpy(base))
    decompress(c, s, torch.from_numpy(base), 512)
    assert (compress.launches, decompress.launches) == before


@pytest.mark.parametrize("case", ["bits", "dtype", "size", "device",
                                  "codes-shape", "codes-dtype", "n"])
def test_wrapper_rejects_bad_inputs(case):
    v = torch.zeros(300)
    c, s = compress(v, v)
    if case == "bits":
        with pytest.raises(ValueError):
            compress(v, v, bits=6)
    elif case == "dtype":
        with pytest.raises(TypeError):
            compress(v.int(), v)
    elif case == "size":
        with pytest.raises(ValueError):
            compress(v, v[:-1])
    elif case == "device":
        with pytest.raises(ValueError):
            compress(v.to("meta"), v.to("meta"))
    elif case == "codes-shape":
        with pytest.raises(ValueError):
            decompress(c[:-1], s[:-1], v, 300)
    elif case == "codes-dtype":
        with pytest.raises(TypeError):
            decompress(c.int(), s, v, 300)
    else:
        with pytest.raises(ValueError):
            decompress(c, s, v, 10**6)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode "
                    "(chip_smoke.py runs them against the plain version)")
    return torch.device("cuda")


def test_cuda_kernels_match_plain(cuda_device):
    for n in (1, 4096, 12345):
        for bits in (8, 4):
            vals, base = _inputs(n, seed=n + bits, zero_rows=True)
            v, b = torch.from_numpy(vals), torch.from_numpy(base)
            before = (compress.launches, decompress.launches)
            codes, scales = compress(v.to(cuda_device), b.to(cuda_device),
                                     bits=bits)
            rec = decompress(codes, scales, b.to(cuda_device), n)
            assert (compress.launches, decompress.launches) == \
                (before[0] + 1, before[1] + 1)
            want_c, want_s = compress(v, b, bits=bits)
            assert torch.equal(codes.cpu(), want_c)
            assert torch.equal(scales.cpu(), want_s)
            assert torch.equal(rec.cpu(), decompress(want_c, want_s, b, n))
