"""PyTorch port of the ReCXL reproduction, for NVIDIA Hopper GPUs.

Laid out like the JAX package ``repro`` and held against it by parity
tests; it imports nothing of it. This package covers the paper's
evaluation path (:mod:`repro_torch.core.scenarios` grids ->
:mod:`repro_torch.core.engine` tiers -> :mod:`repro_torch.core.simulator`
banks -> the hand-written CUDA scan kernel in
:mod:`repro_torch.kernels.bank_scan`), the ReCXL mechanism
(:mod:`repro_torch.core.replication` log rings ->
:mod:`repro_torch.core.recovery` Algorithms 1-2 -> the fault scenarios
of :mod:`repro_torch.core.scenarios`, with the log-dump compressor in
:mod:`repro_torch.kernels.log_compress`), and model serving
(:mod:`repro_torch.launch.serve` -> :mod:`repro_torch.models` for the
dense, ssm and hybrid families, with the prefill's attention and SSD
scan in :mod:`repro_torch.kernels.flash_attn` and
:mod:`repro_torch.kernels.ssd_scan`). Importing it starts no build and
touches no device.
"""
