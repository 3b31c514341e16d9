"""zamba2-2.7b [hybrid] — arXiv:2411.15242.

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64;
Mamba2 backbone with a SHARED attention+MLP block applied every 6 layers
(the Zamba2 shared-block design; per-invocation LoRA deltas are omitted —
recorded as a simplification in DESIGN.md).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,       # shared attention block heads
    n_kv_heads=32,
    d_ff=10240,       # shared block MLP width
    vocab_size=32000,
    head_dim=80,
    norm="rmsnorm",
    act="swiglu",
    ssm_state=64,
    ssm_expand=2,
    attn_every=6,
)
