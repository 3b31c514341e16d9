"""whisper-tiny [audio] — arXiv:2212.04356.

4L d_model=384 6H (GQA kv=6) d_ff=1536 vocab=51865; encoder-decoder; the
conv frontend is a STUB — input_specs() provides precomputed frame
embeddings (B, 1500, 384).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,          # decoder layers
    n_enc_layers=4,      # encoder layers
    enc_seq=1500,        # 30s of audio at 10ms hop / 2 (conv stride)
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    head_dim=64,
    norm="layernorm",
    act="gelu",
    rope_theta=0.0,      # whisper uses learned/sinusoidal positions, no RoPE
)
