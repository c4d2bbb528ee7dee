"""starcoder2-15b -- GQA + RoPE code LM [arXiv:2402.19173; hf].

Assigned cell: [dense] 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152.
"""

from repro_torch.config import ModelConfig, register_model

FULL = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    mlp="gelu",
    rope_theta=100_000.0,
)

REDUCED = ModelConfig(
    name="starcoder2-15b-reduced",
    family="dense",
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    head_dim=16,
    mlp="gelu",
    rope_theta=10_000.0,
)

register_model(FULL, reduced=REDUCED)
