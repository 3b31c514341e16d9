"""deepseek-moe-16b [moe] — arXiv:2401.06066.

28L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400; fine-grained MoE:
2 shared + 64 routed experts, top-6, first layer dense (d_ff 10944).
"""

from repro_torch.configs.base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,  # the dense first layer's FFN width
    vocab_size=102400,
    head_dim=128,
    norm="rmsnorm",
    act="swiglu",
    moe=MoESpec(n_routed=64, n_shared=2, top_k=6, d_expert=1408, n_dense_layers=1),
)
