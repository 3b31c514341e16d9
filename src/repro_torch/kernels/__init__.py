"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions,
and the by-device dispatch between them (:mod:`.ops`)."""
