"""rwkv6-3b [ssm] — Finch, arXiv:2404.05892.

32L d_model=2560 (attention-free) d_ff=8960 vocab=65536; data-dependent
decay WKV recurrence, head size 64 (40 heads).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="rwkv",
    n_layers=32,
    d_model=2560,
    n_heads=40,       # d_model / head size 64
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    ssm_state=64,     # RWKV head size
    norm="layernorm",
    act="relu2",      # channel-mix uses squared ReLU
)
