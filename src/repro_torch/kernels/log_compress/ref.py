"""Plain torch version of the log-dump compressor.

Scheme (the JAX package's ``kernels/log_compress/ref.py``): the paper
gzip-9s its logs (5.8x) before dumping to the MNs; the fixed-rate
scheme here is

    delta  = values - base              (base = last dumped version)
    scale  = max(|delta|) * (1 / qmax)  per block of ``block`` words
    codes  = round(delta / scale)       int8 (or int4 range)

Decompression is ``base + codes * scale``, the product rounded before
the sum (two separate torch operations, so never one FMA). Fixed rate:
8 (or 4) bits per word + one f32 scale per block -> 3.94x (7.76x) vs
the f32 log-entry payload. The CPU path of ``ops.py`` runs these;
``chip_smoke.py`` holds the CUDA kernels against them on the card.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def compress_ref(values: torch.Tensor, base: torch.Tensor, block: int = 256,
                 bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """values, base: (n, block) f32. Returns (codes int8 (n, block),
    scales f32 (n, 1))."""
    if values.dim() != 2 or values.shape != base.shape \
            or values.shape[1] != block:
        raise ValueError(f"values and base must both be (n, {block}), got "
                         f"{tuple(values.shape)} / {tuple(base.shape)}")
    delta = values.float() - base.float()
    amax = delta.abs().amax(dim=1, keepdim=True)
    qmax = float(2 ** (bits - 1) - 1)
    # XLA turns the reference's amax / qmax into amax times the f32
    # reciprocal of the constant; the port takes that product, which is
    # not always the IEEE quotient.
    inv_qmax = torch.full_like(amax, float(np.float32(1.0) / np.float32(qmax)))
    scale = torch.where(amax > 0, amax * inv_qmax, torch.ones_like(amax))
    codes = torch.clamp(torch.round(delta / scale), -qmax, qmax)
    return codes.to(torch.int8), scale


def decompress_ref(codes: torch.Tensor, scales: torch.Tensor,
                   base: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`compress_ref`. Returns f32 (n, block)."""
    return base.float() + codes.float() * scales.float()
