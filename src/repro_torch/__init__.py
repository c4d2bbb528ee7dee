"""PyTorch port of the ReCXL reproduction, for NVIDIA Hopper GPUs.

Laid out like the JAX package ``repro`` and held against it by parity
tests; it imports nothing of it. This package covers the paper's
evaluation path: :mod:`repro_torch.core.scenarios` grids ->
:mod:`repro_torch.core.engine` tiers -> :mod:`repro_torch.core.simulator`
banks -> the hand-written CUDA scan kernel in
:mod:`repro_torch.kernels.bank_scan`. Importing it starts no build and
touches no device.
"""
