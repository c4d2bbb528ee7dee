"""Configurations of the port.

``recxl_paper`` is the paper's evaluated cluster (Table II). The model
configs -- ``hymba_1_5b`` (hybrid), ``qwen3_0_6b``, ``deepseek_67b``,
``stablelm_12b`` and ``starcoder2_15b`` (dense), ``mamba2_2_7b`` (ssm),
``moonshot_v1_16b_a3b`` and ``grok1_314b`` (moe), copies of the JAX
package's, each with its published config and a reduced one for CPU
tests -- register themselves with :mod:`repro_torch.config` when this
package is imported. The enc-dec (whisper) and vlm (internvl2) configs
wait for their model families (ROADMAP A6).
"""

from repro_torch.configs import (  # noqa: F401
    deepseek_67b,
    grok1_314b,
    hymba_1_5b,
    mamba2_2_7b,
    moonshot_v1_16b_a3b,
    qwen3_0_6b,
    stablelm_12b,
    starcoder2_15b,
)
