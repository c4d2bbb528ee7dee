"""qwen3-0.6b -- [hf:Qwen/Qwen3-8B family; hf].

Assigned cell: [dense] 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936, qk_norm, GQA. head_dim=128 per the HF config (q_proj is
16*128 = 2048 wide, wider than d_model).
"""

from repro_torch.config import ModelConfig, register_model

FULL = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=3072,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="qwen3-0.6b-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    head_dim=32,
    qk_norm=True,
    rope_theta=10_000.0,
    tie_embeddings=True,
)

register_model(FULL, reduced=REDUCED)
