"""whisper-medium -- encoder-decoder audio backbone [arXiv:2212.04356].

Assigned cell: [audio] 24L d_model=1024 16H (kv=16 => MHA) d_ff=4096
vocab=51865. enc-dec; the conv mel frontend is a STUB -- ``batch_struct``
/ ``make_batch`` provide precomputed frame embeddings (batch, 1500,
d_model).
"""

from repro_torch.config import ModelConfig, register_model

FULL = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,            # decoder layers
    encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    head_dim=64,
    n_frames=1500,
    mlp="gelu",
    rope_theta=10_000.0,    # backbone uses RoPE in this repro (frontend stubbed)
)

REDUCED = ModelConfig(
    name="whisper-medium-reduced",
    family="audio",
    n_layers=2,
    encoder_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    head_dim=16,
    n_frames=16,
    mlp="gelu",
    rope_theta=10_000.0,
)

register_model(FULL, reduced=REDUCED)
