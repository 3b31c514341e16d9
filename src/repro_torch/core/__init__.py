"""The paper's primary contribution: DEEP-ER I/O + resiliency stack, and
``core/offload.py``, the Cluster/Booster split over mesh sub-grids."""

from repro_torch.core.scr import SCRManager, Strategy, CheckpointRecord, FabricSpec, EXTOLL, TPU_ICI
from repro_torch.core.nam import NAMDevice, make_nam
from repro_torch.core.tasks import TaskRuntime, TaskError, TaskStats
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
    "TaskRuntime",
    "TaskError",
    "TaskStats",
    "parity",
]
