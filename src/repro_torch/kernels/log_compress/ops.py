"""Public ops of the log-dump compressor.

The signatures of the JAX package's ``kernels/log_compress/ops.py``:
flat input is cast to f32 (bf16 included), padded with zeros to a whole
number of 8 x 256-word tiles and cut into 256-word rows. A CUDA tensor
launches the hand-written kernel (``kernel.py``) or raises; a CPU tensor
runs the plain torch version (``ref.py``); other devices raise. There
is no override that sends a CUDA tensor to the plain version.
``compress.launches`` and ``decompress.launches`` count kernel launches,
so a run can show that its dumps went through the kernels.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.log_compress import kernel
from repro_torch.kernels.log_compress.ref import compress_ref, decompress_ref
from repro_torch.kernels._tensor import aligned16

BLOCK = 256
TILE_ROWS = 8                   # the JAX package's padding granule (rows)


def _route(t: torch.Tensor, name: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got "
                         f"{t.device}")
    return t.device.type


def _pad_to_blocks(flat: torch.Tensor, block: int) -> Tuple[torch.Tensor,
                                                            int]:
    n = flat.shape[0]
    pad = (-n) % (block * TILE_ROWS)
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(-1, block), n


def compress(values: torch.Tensor, base: torch.Tensor, bits: int = 8
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compress a flat f32/bf16 update against its base snapshot.

    Returns (codes int8 (n_blocks, BLOCK), scales f32 (n_blocks, 1)) on
    the inputs' device, without synchronising.
    """
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if values.device != base.device:
        raise ValueError(f"values on {values.device}, base on {base.device}")
    if not values.is_floating_point() or not base.is_floating_point():
        raise TypeError(f"values and base must be floating point, got "
                        f"{values.dtype} / {base.dtype}")
    if values.numel() != base.numel():
        raise ValueError(f"values has {values.numel()} words, base "
                         f"{base.numel()}")
    route = _route(values, "compress")
    v2d, _ = _pad_to_blocks(values.reshape(-1).float(), BLOCK)
    b2d, _ = _pad_to_blocks(base.reshape(-1).float(), BLOCK)
    if route == "cpu":
        return compress_ref(v2d, b2d, block=BLOCK, bits=bits)
    out = kernel.launch_compress(aligned16(v2d), aligned16(b2d), bits)
    compress.launches += 1
    return out


def decompress(codes: torch.Tensor, scales: torch.Tensor,
               base: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse transform; returns flat f32 of length ``n``."""
    if not codes.device == scales.device == base.device:
        raise ValueError(f"codes on {codes.device}, scales on "
                         f"{scales.device}, base on {base.device}")
    if codes.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"codes must be int8 and scales float32, got "
                        f"{codes.dtype} / {scales.dtype}")
    if not base.is_floating_point():
        raise TypeError(f"base must be floating point, got {base.dtype}")
    route = _route(codes, "decompress")
    b2d, _ = _pad_to_blocks(base.reshape(-1).float(), BLOCK)
    if codes.shape != b2d.shape or scales.shape != (b2d.shape[0], 1):
        raise ValueError(f"codes {tuple(codes.shape)} and scales "
                         f"{tuple(scales.shape)} do not fit a base of "
                         f"{base.numel()} words ({tuple(b2d.shape)} rows)")
    if not 0 <= n <= b2d.numel():
        raise ValueError(f"n={n} outside [0, {b2d.numel()}]")
    if route == "cpu":
        out = decompress_ref(codes, scales, b2d)
    else:
        out = kernel.launch_decompress(aligned16(codes), scales.contiguous(),
                                       aligned16(b2d))
        decompress.launches += 1
    return out.reshape(-1)[:n]


def compression_factor(bits: int = 8, block: int = BLOCK) -> float:
    """Fixed-rate factor vs. the f32 log payload (excludes base storage,
    which recovery already holds as the previous dump)."""
    payload_bits = 32 * block
    compressed_bits = bits * block + 32
    return payload_bits / compressed_bits


#: Kernel launches since import (CPU calls are not counted).
compress.launches = 0
decompress.launches = 0
