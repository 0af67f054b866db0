"""Minimal functional module system with logical axis names (no nn layers).

Params are nested dicts of tensors.  ``Ctx`` collects, during init, a
parallel tree of *logical axis names* per parameter; ``spec_for_axes`` maps
those through a rules table (MaxText-style) to mesh-axis names.  The model
functions take the param tree; ``ParamModule`` wraps one as an
``nn.Module`` whose ``named_parameters()`` are the tree's paths joined by
``.``, so a tree carried across from the JAX package loads with
``load_state_dict``.

Random streams: each ``Ctx`` owns a seed; parameter ``n`` of a scope is
drawn from a ``torch.Generator`` on the target device seeded with
``fold(seed, n)``, and a child scope's seed is ``fold(seed, crc32(name))``
-- stable across processes (a ``str`` hash is salted per process).  The
streams are torch's, not ``jax.random``'s, so parity with the JAX package
comes from carrying its weights across (``repro_torch.convert``).  On the
``meta`` device (the dry run's shapes, ``launch/cells.py``) a parameter is
an empty meta tensor and nothing is drawn: no generator lives there.
"""
from __future__ import annotations

import hashlib
import zlib
from typing import Callable

import numpy as np
import torch
from torch import nn

from ..device import resolve_device


# ---------------------------------------------------------------------------
# Initializers: f(generator, shape, dtype) -> tensor on the generator's device
# ---------------------------------------------------------------------------
def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, device=gen.device,
                       dtype=torch.float32)


def normal_init(scale: float = 0.02):
    def f(gen, shape, dtype):
        return (scale * _normal(gen, shape)).to(dtype)
    return f


def fan_in_init():
    def f(gen, shape, dtype):
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = 1.0 / np.sqrt(max(1, fan_in))
        return (float(scale) * _normal(gen, shape)).to(dtype)
    return f


def zeros_init():
    return lambda gen, shape, dtype: torch.zeros(tuple(shape), dtype=dtype,
                                                 device=gen.device)


def ones_init():
    return lambda gen, shape, dtype: torch.ones(tuple(shape), dtype=dtype,
                                                device=gen.device)


# ---------------------------------------------------------------------------
# Init context
# ---------------------------------------------------------------------------
def fold(seed: int, data: int) -> int:
    """A 63-bit seed from (seed, data), the same in every process."""
    h = hashlib.blake2b(f"{int(seed)}:{int(data)}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


class Ctx:
    """Parameter collection context.  ``ctx.param(name, shape, axes)`` creates
    the tensor and records its logical axes at the same tree path."""

    def __init__(self, seed: int, params: dict | None = None,
                 axes: dict | None = None, dtype=torch.float32, device=None):
        self._seed = int(seed)
        self._n = 0
        self.params = params if params is not None else {}
        self.axes = axes if axes is not None else {}
        self.dtype = dtype
        self.device = resolve_device(device)

    def _next_generator(self) -> torch.Generator:
        self._n += 1
        gen = torch.Generator(device=self.device)
        gen.manual_seed(fold(self._seed, self._n))
        return gen

    def param(self, name: str, shape: tuple, axes: tuple,
              init: Callable | None = None, dtype=None):
        if len(shape) != len(axes):
            raise ValueError(f"{name}: shape {shape} vs axes {axes}")
        if self.device.type == "meta":
            arr = torch.empty(tuple(shape), dtype=dtype or self.dtype,
                              device=self.device)
        else:
            init = init or normal_init()
            arr = init(self._next_generator(), shape, dtype or self.dtype)
        self.params[name] = arr
        self.axes[name] = axes
        return arr

    def scope(self, name: str) -> "Ctx":
        sub_p = self.params.setdefault(name, {})
        sub_a = self.axes.setdefault(name, {})
        return Ctx(fold(self._seed, zlib.crc32(name.encode())), sub_p, sub_a,
                   self.dtype, self.device)


def init_with_axes(init_fn, seed: int, *args, dtype=torch.float32,
                   device=None, **kw):
    """Run ``init_fn(ctx, *args)`` on ``device`` (None = the CUDA device)
    and return (params, axes)."""
    ctx = Ctx(seed, dtype=dtype, device=device)
    with torch.no_grad():
        init_fn(ctx, *args, **kw)
    return ctx.params, ctx.axes


# ---------------------------------------------------------------------------
# Logical axis rules -> mesh-axis names
# ---------------------------------------------------------------------------
# Default rules for the production mesh:
#   batch-like axes  -> data (+pod) parallelism
#   big contraction / head / expert / vocab / table axes -> tensor ("model")
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": None,
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "expert_mlp": None,
    "layers": None,
    "table": "model",   # recsys embedding rows
    "feat": None,
    "stats": None,
    "hidden": None,
}


def spec_for_axes(axes: tuple, rules: dict) -> tuple:
    """Each logical axis's mesh axis (a name, a tuple of names, or None)."""
    return tuple(rules.get(a, None) if a is not None else None for a in axes)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def spec_tree(axes_tree, mesh, rules: dict | None = None):
    """The axes tree mapped to partition specs on ``mesh``: each leaf's
    tuple of mesh axes, one entry per dimension (a name, a tuple of names
    or None), with every axis the mesh lacks dropped -- the port's
    ``PartitionSpec``, as ``jax.sharding.PartitionSpec`` reads as a
    tuple."""
    rules = {**DEFAULT_RULES, **(rules or {})}
    avail = set(mesh.axis_names)

    def fix(part):
        if part is None:
            return None
        if isinstance(part, tuple):
            kept = tuple(s for s in part if s in avail)
            # one axis left reads as its name, as a PartitionSpec reads it
            return kept if len(kept) > 1 else (kept[0] if kept else None)
        return part if part in avail else None

    def walk(node):
        if _is_axes(node):
            return tuple(fix(s) for s in spec_for_axes(node, rules))
        return {k: walk(v) for k, v in node.items()}

    return walk(axes_tree)


# The port has no ``NamedSharding``: a spec names its mesh axes and the
# caller holds the mesh, so the JAX package's two mappings are one here.
logical_to_sharding = spec_tree


def constrain(x, mesh, *axes, rules: dict | None = None):
    """Sharding constraint by logical axes (``with_sharding_constraint``):
    the identity off-mesh.  A DTensor -- the dry run's partitioned count,
    ``launch/partition.py`` -- is redistributed to the placements the
    axes' spec names on ``mesh``; a plain tensor on a mesh of ``meta``
    devices (an unpartitioned count) stays as it is.  The port runs its
    models on one device, so a mesh of real devices is refused."""
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        from ..launch.partition import placements
        spec = spec_tree({"x": tuple(axes)}, mesh, rules)["x"]
        return x.redistribute(x.device_mesh, placements(
            spec, x.dim(), mesh.axis_names))
    if all(torch.device(d).type == "meta" for d in np.ravel(mesh.devices)):
        return x
    raise NotImplementedError(
        "the port runs its models on one device: pass mesh=None")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def param_count(params) -> int:
    return sum(int(np.prod(p.shape)) for p in _leaves(params))


def param_bytes(params) -> int:
    return sum(int(np.prod(p.shape)) * p.element_size()
               for p in _leaves(params))


# ---------------------------------------------------------------------------
# The param tree as an nn.Module
# ---------------------------------------------------------------------------
class ParamModule(nn.Module):
    """An ``nn.Module`` over a nested dict of tensors: each dict becomes a
    child module, each tensor a parameter (``requires_grad=False``: a
    served model builds no autograd graph; the train step,
    ``training/step.py``, takes its gradients over detached leaves of the
    tree), so ``named_parameters()`` are the tree's paths joined by ``.``.
    ``tree()`` gives the nested dict back for the model functions."""

    def __init__(self, params: dict):
        super().__init__()
        for name, v in params.items():
            if isinstance(v, dict):
                self.add_module(name, ParamModule(v))
            else:
                self.register_parameter(
                    name, nn.Parameter(v, requires_grad=False))

    def tree(self) -> dict:
        out = {name: p for name, p in self._parameters.items()}
        for name, m in self._modules.items():
            out[name] = m.tree()
        return out
