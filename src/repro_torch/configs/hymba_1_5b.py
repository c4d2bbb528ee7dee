"""hymba-1.5b -- parallel attention + mamba heads [arXiv:2411.13676; hf].

Assigned cell: [hybrid] 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16. Each layer runs attention heads and SSM heads
in parallel on the same input and fuses the branch outputs (mean of
per-branch-normalized outputs, per the paper).
"""

from repro_torch.config import ModelConfig, register_model

FULL = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    rope_theta=10_000.0,
)

REDUCED = ModelConfig(
    name="hymba-1.5b-reduced",
    family="hybrid",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    head_dim=16,
    ssm_state=8,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_chunk=32,
    rope_theta=10_000.0,
)

register_model(FULL, reduced=REDUCED)
