"""Configurations of the port.

``recxl_paper`` is the paper's evaluated cluster (Table II). The model
configs -- ``hymba_1_5b`` (hybrid), ``qwen3_0_6b``, ``deepseek_67b``,
``stablelm_12b`` and ``starcoder2_15b`` (dense), ``mamba2_2_7b`` (ssm),
``moonshot_v1_16b_a3b`` and ``grok1_314b`` (moe), ``whisper_medium``
(audio, enc-dec) and ``internvl2_26b`` (vlm), copies of the JAX
package's, each with its published config and a reduced one for CPU
tests -- register themselves with :mod:`repro_torch.config` when this
package is imported.
"""

from repro_torch.configs import (  # noqa: F401
    deepseek_67b,
    grok1_314b,
    hymba_1_5b,
    internvl2_26b,
    mamba2_2_7b,
    moonshot_v1_16b_a3b,
    qwen3_0_6b,
    stablelm_12b,
    starcoder2_15b,
    whisper_medium,
)

#: the architectures of the dry-run's cells, in the JAX package's order
ASSIGNED_ARCHS = (
    "internvl2-26b",
    "qwen3-0.6b",
    "deepseek-67b",
    "stablelm-12b",
    "starcoder2-15b",
    "mamba2-2.7b",
    "grok-1-314b",
    "moonshot-v1-16b-a3b",
    "whisper-medium",
    "hymba-1.5b",
)
