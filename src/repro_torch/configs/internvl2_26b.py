"""internvl2-26b -- InternViT-6B + InternLM2-20B backbone [arXiv:2404.16821; hf].

Assigned cell: [vlm] 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.

The modality frontend (InternViT) is a STUB: ``batch_struct`` /
``make_batch`` provide precomputed patch embeddings of shape
(batch, n_patches, d_model) that replace the leading token positions. Only
the LM backbone is modeled/lowered.
"""

from repro_torch.config import ModelConfig, register_model

FULL = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    head_dim=128,
    rope_theta=1_000_000.0,
    n_patches=256,
)

REDUCED = ModelConfig(
    name="internvl2-26b-reduced",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    head_dim=16,
    rope_theta=10_000.0,
    n_patches=8,
)

register_model(FULL, reduced=REDUCED)
