"""minicpm3-4b [dense, MLA] — hf:openbmb/MiniCPM3-4B.

62L d_model=2560 40H (GQA kv=40) d_ff=6400 vocab=73448; Multi-head Latent
Attention with the published low-rank dims (q_lora 768, kv_lora 256,
qk_nope 64, qk_rope 32, v 64).
"""

from repro_torch.configs.base import ArchConfig, MLASpec

CONFIG = ArchConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    head_dim=96,  # qk_nope + qk_rope
    act="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
    mla=MLASpec(q_lora_rank=768, kv_lora_rank=256, qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64),
)
