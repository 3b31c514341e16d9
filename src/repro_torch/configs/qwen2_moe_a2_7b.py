"""qwen2-moe-a2.7b [moe] — hf:Qwen/Qwen1.5-MoE-A2.7B.

24L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=151936; 4 shared (gated)
+ 60 routed experts, top-4.  60 % 16 != 0, so experts are padded to 64
(masked routing) for EP over the 16-way model axis.
"""

from repro_torch.configs.base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5632,  # shared-expert aggregate width (4x1408)
    vocab_size=151936,
    head_dim=128,
    norm="rmsnorm",
    act="swiglu",
    moe=MoESpec(
        n_routed=60, n_shared=4, top_k=4, d_expert=1408, n_dense_layers=0, shared_gate=True
    ),
)
