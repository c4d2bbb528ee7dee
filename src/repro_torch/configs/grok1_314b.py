"""grok-1-314b -- 8-expert top-2 MoE [hf:xai-org/grok-1].

Assigned cell: [moe] 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8e top-2.
"""

from repro_torch.config import ModelConfig, register_model

FULL = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    head_dim=128,
    n_experts=8,
    top_k=2,
    rope_theta=10_000.0,
)

REDUCED = ModelConfig(
    name="grok-1-314b-reduced",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    head_dim=16,
    n_experts=4,
    top_k=2,
    rope_theta=10_000.0,
)

register_model(FULL, reduced=REDUCED)
