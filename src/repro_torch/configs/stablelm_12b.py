"""stablelm-12b -- [hf:stabilityai/stablelm-2-12b family; hf].

Assigned cell: [dense] 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352. head_dim = 5120/32 = 160.
"""

from repro_torch.config import ModelConfig, register_model

FULL = ModelConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    head_dim=160,
    rope_theta=10_000.0,
)

REDUCED = ModelConfig(
    name="stablelm-12b-reduced",
    family="dense",
    n_layers=2,
    d_model=80,
    n_heads=4,
    n_kv_heads=2,
    d_ff=192,
    vocab_size=512,
    head_dim=20,
    rope_theta=10_000.0,
)

register_model(FULL, reduced=REDUCED)
