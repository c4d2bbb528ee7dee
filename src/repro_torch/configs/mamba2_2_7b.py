"""mamba2-2.7b -- SSD (state-space duality) stack [arXiv:2405.21060].

Assigned cell: [ssm] 64L d_model=2560 (attn-free) d_ff=0 vocab=50280,
ssm_state=128. expand=2 => d_inner=5120, head_dim=64 => 80 SSD heads.
"""

from repro_torch.config import ModelConfig, register_model

FULL = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
)

REDUCED = ModelConfig(
    name="mamba2-2.7b-reduced",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=512,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_chunk=32,
)

register_model(FULL, reduced=REDUCED)
