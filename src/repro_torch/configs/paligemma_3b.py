"""paligemma-3b [vlm] — arXiv:2407.07726.

18L d_model=2048 8H (GQA kv=1, MQA) d_ff=16384 vocab=257216; gemma-style
decoder over a SigLIP patch prefix.  The SigLIP tower is a STUB —
input_specs() provides precomputed patch embeddings (B, 256, 2048).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab_size=257216,
    head_dim=256,
    norm="rmsnorm",
    act="geglu",
    tie_embeddings=True,
    n_prefix=256,  # 224px / 14 patch = 16x16 patches
)
