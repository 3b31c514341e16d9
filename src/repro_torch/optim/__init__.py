from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.compression import compress_grads, decompress_grads

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "compress_grads",
    "decompress_grads",
]
