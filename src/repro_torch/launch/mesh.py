"""Production mesh builders.

Counterpart of ``repro/launch/mesh.py``: the same shapes and axis names,
returned as the port's :class:`repro_torch.distributed.mesh.Mesh` of
process ranks.  Functions, not module-level constants, and building a
mesh touches no device and no process group (its groups are made at
first use, inside a world of that many ranks).
"""

from __future__ import annotations

from repro_torch.distributed.mesh import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 chips per pod; 2 pods = 512 chips multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_test_mesh(*, multi_pod: bool = False) -> Mesh:
    """Small mesh for CI-scale tests (a world of 4 or 8 ranks)."""
    shape = (2, 2, 2) if multi_pod else (2, 2)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)
