"""The paper's primary contribution: DEEP-ER I/O + resiliency stack.

``core/tasks.py`` and ``core/offload.py`` wait for a later slice of
ROADMAP.md."""

from repro_torch.core.scr import SCRManager, Strategy, CheckpointRecord, FabricSpec, EXTOLL, TPU_ICI
from repro_torch.core.nam import NAMDevice, make_nam
from repro_torch.core import parity

__all__ = [
    "SCRManager",
    "Strategy",
    "CheckpointRecord",
    "FabricSpec",
    "EXTOLL",
    "TPU_ICI",
    "NAMDevice",
    "make_nam",
    "parity",
]
