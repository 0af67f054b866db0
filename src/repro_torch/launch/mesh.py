"""Production mesh definition (a function, not a module constant), as a
mesh of ``meta`` devices: the dry run needs its axis names and extents,
never a device, so building it touches no device state."""
from __future__ import annotations

from ..core.distributed import make_mesh


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 devices per pod; 2 pods = 512 devices multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device="meta")


def make_test_mesh(n_data: int = 2, n_model: int = 4):
    """Small mesh for the tests."""
    return make_mesh((n_data, n_model), ("data", "model"), device="meta")


def batch_axes(batch: int, mesh) -> tuple:
    """Greedy batch-dim sharding: use pod/data axes whose sizes divide B."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    out = []
    rem = batch
    for name in ("pod", "data"):
        if name in sizes and rem % sizes[name] == 0:
            out.append(name)
            rem //= sizes[name]
    return tuple(out)
