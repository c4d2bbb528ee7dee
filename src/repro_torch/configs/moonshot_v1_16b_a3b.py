"""moonshot-v1-16b-a3b -- kimi/Moonlight fine-grained MoE
[hf:moonshotai/Moonlight-16B-A3B].

Assigned cell: [moe] 48L d_model=2048 16H (GQA kv=16 => MHA) d_ff=1408
(per-expert) vocab=163840, MoE 64e top-6 + 2 shared experts (HF config).
"""

from repro_torch.config import ModelConfig, register_model

FULL = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    head_dim=128,
    n_experts=64,
    top_k=6,
    moe_d_ff=1408,
    n_shared_experts=2,
    rope_theta=50_000.0,
)

REDUCED = ModelConfig(
    name="moonshot-v1-16b-a3b-reduced",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=48,
    vocab_size=512,
    head_dim=16,
    n_experts=8,
    top_k=2,
    moe_d_ff=48,
    n_shared_experts=1,
    rope_theta=10_000.0,
)

register_model(FULL, reduced=REDUCED)
