"""The partitioned per-device program of a dry-run cell: the port's
counterpart of what ``jax.jit(..., in_shardings=...)`` and ``NamedSharding``
do for the JAX package's count.

A count of a cell with shardings runs its step on DTensors over a fake
process group whose world size is the mesh's device count (256 single-pod,
512 multi-pod): each argument is a DTensor of the cell's spec, made with
``DTensor.from_local`` over its rank-0 ``meta`` shard.  DTensor's sharding
propagation then picks each op's placements and dispatches the local op on
the local shards, and the redistributions it needs as ``_c10d_functional``
collectives, which the fake group completes without contacting any rank.
So a dispatch mode that lets DTensor desugar first (``dryrun._Count``)
sees the per-device program: every op at its local shapes and every
collective with its group.

    with fake_group(mesh) as dmesh:
        dargs = distribute(args, shardings, dmesh, mesh)
        ...

``fake_group`` destroys the group on exit, so no default group outlives a
count: the sharded backend and the card runs never use ``torch.distributed``.
"""
from __future__ import annotations

import contextlib
import logging
import math

import torch


def mesh_shape(mesh) -> tuple:
    return tuple(int(s) for s in mesh.devices.shape)


@contextlib.contextmanager
def fake_group(mesh):
    """A fake process group of ``mesh``'s device count (rank 0) and a
    ``DeviceMesh`` of its shape and axis names; destroyed on exit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    # registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised: a "
                           "partitioned count brings up its own fake group")
    shape = mesh_shape(mesh)
    # DTensor's notes on its own collective choices (a CPU mesh's
    # all-to-all as an all-gather, sequential all-reduces) are not the
    # count's concern
    log = logging.getLogger("torch.distributed.tensor")
    level = log.level
    log.setLevel(logging.ERROR)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield init_device_mesh("cpu", shape,
                               mesh_dim_names=tuple(mesh.axis_names))
    finally:
        dist.destroy_process_group()
        log.setLevel(level)


def _axes(part) -> tuple:
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


def placements(spec: tuple, ndim: int, axis_names) -> list:
    """One leaf's spec (``models.module.spec_tree``: one entry per tensor
    dimension, a mesh-axis name, a tuple of names or None; missing trailing
    entries are None) as DTensor placements: ``Shard(dim)`` on each named
    mesh dimension, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's "
                         f"{ndim} dimensions")
    out = [Replicate() for _ in axis_names]
    names = list(axis_names)
    for dim, part in enumerate(spec):
        for ax in _axes(part):
            if ax not in names:
                raise ValueError(f"spec {spec} names {ax!r}, not an axis of "
                                 f"the mesh {tuple(names)}")
            i = names.index(ax)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec} uses mesh axis {ax!r} twice")
            out[i] = Shard(dim)
    return out


def local_shape(shape, spec: tuple, mesh) -> tuple:
    """The rank-0 shard's shape of a tensor of ``shape`` under ``spec`` on
    ``mesh``; a dimension its axes do not divide is refused, as the JAX
    lowering refuses it."""
    sizes = dict(zip(mesh.axis_names, mesh_shape(mesh)))
    out = list(shape)
    for dim, part in enumerate(tuple(spec)):
        n = math.prod(sizes[a] for a in _axes(part))
        if out[dim] % n:
            raise ValueError(
                f"dimension {dim} of shape {tuple(shape)} ({out[dim]}) does "
                f"not divide evenly over mesh axes {_axes(part)} ({n} "
                "devices)")
        out[dim] //= n
    return tuple(out)


def local_nbytes(t: torch.Tensor, spec: tuple, mesh) -> int:
    return math.prod(local_shape(t.shape, spec, mesh)) * t.element_size()


def distribute(args, shardings, dmesh, mesh):
    """``args`` (trees of ``meta`` tensors: dicts, tuples, NamedTuples) as
    DTensors over ``dmesh``, each leaf placed by its spec in the parallel
    ``shardings`` tree (a leaf's spec is a tuple; ``()`` replicates)."""
    from torch.distributed.tensor import DTensor

    def walk(a, s):
        if isinstance(a, torch.Tensor):
            local = torch.empty(local_shape(a.shape, s, mesh), dtype=a.dtype,
                                device="meta")
            return DTensor.from_local(
                local, dmesh, placements(s, a.dim(), mesh.axis_names),
                run_check=False, shape=a.shape, stride=a.stride())
        if isinstance(a, dict):
            return {k: walk(v, s[k]) for k, v in a.items()}
        if isinstance(a, tuple) and hasattr(a, "_fields"):
            return type(a)(*(walk(v, x) for v, x in zip(a, s)))
        if isinstance(a, (tuple, list)):
            return type(a)(walk(v, x) for v, x in zip(a, s))
        return a

    return walk(args, shardings)


def to_local(tree):
    """A tree's DTensors as their local shards."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, DTensor):
        return tree.to_local()
    if isinstance(tree, dict):
        return {k: to_local(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_local(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_local(v) for v in tree)
    return tree
