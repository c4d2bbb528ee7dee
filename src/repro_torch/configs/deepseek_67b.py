"""deepseek-67b -- llama-arch dense LM [arXiv:2401.02954; hf].

Assigned cell: [dense] 95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400.
"""

from repro_torch.config import ModelConfig, register_model

FULL = ModelConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    head_dim=128,
    rope_theta=10_000.0,
)

REDUCED = ModelConfig(
    name="deepseek-67b-reduced",
    family="dense",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=512,
    head_dim=16,
    rope_theta=10_000.0,
)

register_model(FULL, reduced=REDUCED)
