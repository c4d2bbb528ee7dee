"""Configurations of the port.

``recxl_paper`` is the paper's evaluated cluster (Table II). The model
configs -- ``hymba_1_5b`` (hybrid), ``qwen3_0_6b`` (dense) and
``mamba2_2_7b`` (ssm), copies of the JAX package's, each with its
published config and a reduced one for CPU tests -- register themselves
with :mod:`repro_torch.config` when this package is imported. The moe,
enc-dec and vlm configs wait for their model families (ROADMAP item 18).
"""

from repro_torch.configs import (  # noqa: F401
    hymba_1_5b,
    mamba2_2_7b,
    qwen3_0_6b,
)
