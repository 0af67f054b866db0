"""The multi-pod dry run on the H100's constants, over ``meta`` tensors:
each cell's partitioned per-device program on the production mesh.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--mesh single|multi|both] [--out dryrun_results.json] [--skip-favor]
        [--device cuda|cpu] [--seed 0]

The counterpart of the JAX package's lower-and-compile: each cell's step
(``cells.py``) runs once on ``meta`` tensors -- nothing is allocated and no
device is touched -- under a counting dispatch mode (``_Count``).  A cell
with shardings runs partitioned: its arguments are DTensors of its specs on
a fake process group of the mesh's device count (``partition.py``), so the
count sees rank 0's program -- every op at its local shapes and every
collective DTensor dispatches -- as the JAX package reads XLA's partitioned
per-device program.  favor-anns' meta cells are the JAX package's
``shard_map`` steps: the single controller runs every mesh cell's program,
charges the collectives where data crosses cells
(``core.distributed.count_collectives``), and its totals are divided by
the device count.  Every output that lands off ``meta`` is recorded with
its op, shape, bytes and calling line (``off_meta_ops``;
``torch.utils.checkpoint`` in torch 2.11 makes one empty host tensor, 0
bytes, per checkpointed layer), and ``off_meta_bytes`` sums them: the dry
run allocates nothing when it is 0 and no card is named.

  * FLOPs are ``torch.utils.flop_counter``'s formulas (the matmul-like ops:
    ``mm``, ``bmm``, ``addmm``, attention; elementwise ops count none),
    plus an all-reduce's adds, as XLA's cost analysis counts them;
  * bytes are the inputs plus outputs of every op that is not a view,
    unfused: an upper bound beside XLA's count of a fused program (an
    indexing op is charged its whole source tensor, as XLA's cost model
    charges a gather its whole operand);
  * collectives are charged their ring link bytes per device
    (``analysis.ring_link_bytes``) over their group's size, by kind
    (``roofline.collectives``) and by site (``count.collectives_at``: the
    kind, group, calling line and DTensor op of the heaviest);
  * where DTensor would replicate an op XLA splits -- a scatter-add, a
    gather or scatter-add along a sharded dimension, a (log-)softmax along
    one, a batched matmul with strided batch shards, an argmax -- the count
    splits it as XLA does (``count.split_by_rule``); an op DTensor cannot
    place at all runs with its inputs replicated on the last mesh
    dimensions it needs (``count.replicated_ops``): listed, never silent;
  * temporaries are the peak live bytes of the program's storages beyond
    its arguments and outputs (``memory.temp_size_in_bytes``), the
    arguments those the step reads (XLA drops the others), at their local
    shapes;
  * a kernel wrapper's call is charged its analytic work instead of its
    own torch ops (``kernels.counted``: each input read once, each output
    written once, the kernel table's FLOPs), on every device; each
    record lists those charges (``count.kernels``).

A cell that cannot be partitioned (a dimension its axes do not divide, an
op no placement fits) is ``ok: false`` with its traceback: nothing falls
back to an even division of an unpartitioned count.  Each record names its
mesh and how it was partitioned (``partition``).

One cell is counted on real tensors: favor-anns' ``serve_graph``, whose
Python loops read device values.  Its record counts one mesh cell's block
-- the per-device program, on synthetic data from ``--seed`` -- on
``--device`` (the card unless ``cpu`` is given; without a card the record
is ``ok: false`` with the device error), and its per-device terms are that
count, with the estimate's and the merge's collectives added for the
production mesh's ``model`` axis.  It also states the block's rows and
queries, the waves run, the peak memory on the card, and the bytes of each
part of the step (``count.parts``) and of its heaviest ops
(``count.top_ops``).

The count runs every layer of the step (a Python loop, not a scan counted
once), so the JAX package's depth probes have no counterpart here.  The
record keeps the JAX package's fields: ``lower_s`` times building the cell
(and making a block's data), ``compile_s`` the counted run, ``memory`` the
step's argument, output and temporary bytes per device.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref
from dataclasses import dataclass, field

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map
from torch.utils.flop_counter import flop_registry

from .. import kernels
from ..configs import all_specs
from ..core import distributed as dist_core
from ..device import resolve_device
from ..roofline import analysis as RA
from . import cells as C
from . import partition as PT
from .mesh import make_production_mesh


def _tensors(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _writes_first_arg(func) -> bool:
    args = func._schema.arguments
    return bool(args) and args[0].alias_info is not None and \
        args[0].alias_info.is_write


def _caller() -> str:
    """The innermost frame of this package (``file:line``) on the stack:
    the call that made an op's output."""
    for f in reversed(traceback.extract_stack()[:-2]):
        if _PKG in f.filename and not f.filename.endswith("dryrun.py"):
            return f"{f.filename.split(_PKG)[-1]}:{f.lineno}"
    return "outside repro_torch"


_PKG = f"repro_torch{os.sep}"

# the parts of the favor-anns graph step a count gives bytes to: the
# innermost function of this package on the stack that names one
_PARTS = {"estimate": "estimate", "_descend": "descent",
          "_seen_bits": "visited", "_visit_bits": "visited",
          "_merge_pool": "pools", "stage_loop": "wave",
          "_graph_traverse": "traversal", "_merge_topk": "shard merge"}


def _part() -> str:
    f = sys._getframe(2)
    while f is not None:
        part = _PARTS.get(f.f_code.co_name)
        if part is not None and _PKG in f.f_code.co_filename:
            return part
        f = f.f_back
    return "other"


# the collectives DTensor dispatches, by op name -> the kind
# ``analysis.parse_collectives`` names it; their operand is the first
# argument (a tensor, or a list of them for the coalesced forms) and their
# group the last string argument
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
# collective-library ops that move nothing between devices
_NO_CHARGE = {"wait_tensor", "_wrap_tensor_autograd"}
_COMM_NAMESPACES = {"_c10d_functional", "c10d_functional", "_dtensor", "c10d"}


def _group_size(name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


def _in_cpu_alltoall() -> bool:
    """Whether DTensor's Shard -> Shard redistribution is on the stack: on
    a CPU mesh it runs as an all-gather and a local chunk (gloo has no
    all-to-all), where a card's group runs one all-to-all."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name == "shard_dim_alltoall":
            return True
        f = f.f_back
    return False


def _on_cpu(device) -> bool:
    return device is not None and torch.device(device).type == "cpu"


def _touches_meta(args, kwargs) -> bool:
    """Whether an op reads a ``meta`` tensor or makes one."""
    device = kwargs.get("device")
    return (device is not None and torch.device(device).type == "meta") or \
        any(isinstance(t, torch.Tensor) and t.device.type == "meta"
            for t in tree_flatten((args, kwargs))[0])


class _Live:
    """The live bytes of a count's storages: each output's storage is
    held from the op that made it until its last reference goes
    (``weakref.finalize``), so ``peak`` is the program's peak live bytes;
    ``used`` holds the storages a counted op read."""

    def __init__(self):
        self.bytes = 0
        self.peak = 0
        self._held: dict = {}
        self.used: set = set()

    def hold(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = st._cdata
        if key not in self._held:
            nb = st.nbytes()
            self._held[key] = nb
            self.bytes += nb
            self.peak = max(self.peak, self.bytes)
            weakref.finalize(st, self._free, key)
        return key

    def _free(self, key) -> None:
        self.bytes -= self._held.pop(key, 0)

    def use(self, t: torch.Tensor) -> None:
        self.used.add(t.untyped_storage()._cdata)


class _Count(TorchDispatchMode):
    """The counting mode: FLOPs (``torch.utils.flop_counter``'s formulas,
    an op without one counted through its decomposition, as
    ``FlopCounterMode`` counts), the bytes read and written by every op
    that is not a view, each collective's ring link bytes, the kernel
    wrappers' analytic charges (``charge``: {name: {calls, flops,
    bytes}}), and the live bytes (``live``).

    DTensor ops are left to DTensor (``NotImplemented``), so the mode sees
    the per-device program DTensor dispatches: the local ops at their
    local shapes and the collectives; DTensor's own shape propagation (on
    fake tensors) and host bookkeeping are not counted.  The ops of
    ``_RULES`` are split as XLA's partitioner splits them where their
    placements fit (``split``).  An op DTensor cannot place runs with its
    inputs replicated on the last mesh dimensions it needs, or whole -- an
    in-place result scattered back to its placements -- and is listed
    (``replicated``), as XLA's partitioner replicates an op it cannot
    split.  Nothing of a failed attempt is charged.

    With ``note_off_meta``, each output that is not on ``meta``:
    {device: [{op, shape, dtype, bytes, at, count}]}, one entry per (op,
    shape, dtype, caller); with ``parts``, the bytes of each part
    (``_PARTS``) and of each (part, op)."""

    def __init__(self, *, note_off_meta: bool = True, parts: bool = False):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0
        self.off_meta: dict = {}
        self.note_off_meta = note_off_meta
        self.parts = {} if parts else None
        self.ops: dict = {}
        self.kernels: dict = {}
        self.colls: list = []       # (kind, link bytes, programs, site)
        self.replicated: dict = {}
        self.split: dict = {}
        self.live = _Live()
        self.meta_factories = False
        self._pass = False
        self._inside = 0
        self._ops: list = []        # the DTensor ops being dispatched

    # -- charges from outside the dispatcher -------------------------------
    def charge(self, name: str, flops: float, nbytes: float, inputs=(),
               out=None) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.flops += flops
        self.bytes += nbytes
        for t in _tensors(inputs):
            self.live.use(t)
        for t in _tensors(out):
            self.live.hold(t)

    def collective(self, kind: str, operand_bytes: float, g: int,
                   programs: int = 1) -> None:
        """One collective of ``kind`` over a group of ``g`` on an operand
        of ``operand_bytes``, in each of ``programs`` device programs."""
        if g <= 1:
            return
        op = f" in {self._ops[-1]}" if self._ops else ""
        self.colls.append((kind, RA.ring_link_bytes(kind, operand_bytes, g),
                           programs, f"{kind} g={g} at {_caller()}{op}"))

    def collectives(self) -> tuple[dict, dict, dict]:
        """{kind: count}, {kind: link bytes} and {site: link bytes} of the
        collectives charged, each in every program it ran in."""
        counts, by_op, sites = {}, {}, {}
        for kind, link, programs, site in self.colls:
            counts[kind] = counts.get(kind, 0) + programs
            by_op[kind] = by_op.get(kind, 0.0) + programs * link
            sites[site] = sites.get(site, 0.0) + programs * link
        return counts, by_op, sites

    # -- the dispatcher ----------------------------------------------------
    def _note_off_meta(self, func, t: torch.Tensor) -> None:
        key = (str(func), tuple(t.shape), str(t.dtype), _caller())
        per_dev = self.off_meta.setdefault(str(t.device), {})
        if key not in per_dev:
            per_dev[key] = {"op": key[0], "shape": list(key[1]),
                            "dtype": key[2], "bytes": _nbytes(t),
                            "at": key[3], "count": 0}
        per_dev[key]["count"] += 1

    def _outputs(self, func, outs) -> None:
        for t in outs:
            if self.note_off_meta and t.device.type != "meta":
                self._note_off_meta(func, t)
            self.live.hold(t)

    def _comm(self, func, args, kwargs):
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        kind = _COLLECTIVES.get(name)
        if kind is None and name not in _NO_CHARGE:
            raise NotImplementedError(f"the count has no charge for {func}")
        if kind is not None:
            operands = _tensors(args[0])
            for t in operands:
                self.live.use(t)
            g = _group_size([a for a in args if isinstance(a, str)][-1])
            if kind == "all-gather" and _in_cpu_alltoall():
                kind = "all-to-all"
            if kind == "all-reduce" and g > 1:
                # one add an element, as XLA's cost analysis counts it
                self.flops += sum(t.numel() for t in operands)
            self.collective(kind, float(sum(_nbytes(t) for t in operands)),
                            g)
        self._outputs(func, [t for t in tree_flatten(out)[0]
                             if isinstance(t, torch.Tensor)])
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, FakeTensor) for t in types):
            return func(*args, **kwargs)      # DTensor's shape propagation
        if any(issubclass(t, DTensor) for t in types):
            if self._pass:
                self._pass = False
                return NotImplemented
            return self._dtensor_op(func, args, kwargs)
        if any(t is not torch.Tensor for t in types):
            return NotImplemented             # e.g. a collective's wrapper
        if func.namespace in _COMM_NAMESPACES:
            return self._comm(func, args, kwargs)
        if self._inside:
            if not _touches_meta(args, kwargs):
                # DTensor's own bookkeeping on the host, not the program
                return func(*args, **kwargs)
        elif self.meta_factories and _on_cpu(kwargs.get("device")) and \
                not any(isinstance(t, torch.Tensor)
                        for t in tree_flatten((args, kwargs))[0]):
            # a factory given a DTensor's device (its mesh's type, "cpu"):
            # the program's tensors live on meta
            kwargs = {**kwargs, "device": torch.device("meta")}
        if func is not torch.ops.prim.device.default:
            with _Flops(self):
                out = func.decompose(*args, **kwargs)
            if out is NotImplemented:
                out = func(*args, **kwargs)
                self._flops(func, out, args, kwargs)
        else:
            out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in outs):
            return out
        if not _is_view(func):
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            for t in ins:
                self.live.use(t)
            nb = sum(_nbytes(t) for t in ins + outs)
            self.bytes += nb
            if self.parts is not None:
                part = _part()
                self.parts[part] = self.parts.get(part, 0) + nb
                key = f"{part}: {func}"
                self.ops[key] = self.ops.get(key, 0) + nb
        self._outputs(func, outs)
        return out

    def _flops(self, func, out, args, kwargs) -> None:
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)

    def _dtensor_op(self, func, args, kwargs):
        """Let DTensor dispatch ``func`` with this mode on (the next time it
        sees the op it passes it on).  An op of ``_RULES`` is split by the
        rule where its placements fit.  Where DTensor cannot partition an
        op, its inputs are replicated on the last mesh dimension, then the
        last two, ..., until it can; an in-place op is replicated whole."""
        self._ops.append(func._overloadpacket.__name__)
        try:
            return self._dispatch(func, args, kwargs)
        finally:
            self._ops.pop()

    def _dispatch(self, func, args, kwargs):
        rule = _RULES.get(func)
        if rule is not None:
            out = rule(self, func, args, kwargs)
            if out is not None:
                self.split[str(func)] = self.split.get(str(func), 0) + 1
                return out
        if _writes_first_arg(func) and not isinstance(args[0], DTensor):
            # an in-place op on a plain tensor: DTensor cannot write it
            return self._replicated(func, args, kwargs)
        out = self._attempt(func, args, kwargs)
        if out is not _FAILED:
            return out
        if not _writes_first_arg(func):
            mesh = _mesh_of(args, kwargs)
            for k in range(1, mesh.ndim):
                out = self._attempt(func, args, kwargs, replicate=k)
                if out is not _FAILED:
                    name = (f"{func} on " + ", ".join(
                        mesh.mesh_dim_names[mesh.ndim - k:]))
                    self.replicated[name] = self.replicated.get(name, 0) + 1
                    return out
        return self._replicated(func, args, kwargs)

    def _attempt(self, func, args, kwargs, replicate: int = 0):
        """DTensor's dispatch of ``func``, its inputs first replicated on
        the last ``replicate`` mesh dimensions; ``_FAILED`` (nothing of the
        attempt charged) where DTensor has no placement for it."""
        from torch.distributed.tensor import Replicate
        undo = (self.flops, self.bytes, len(self.colls))
        inplace = _writes_first_arg(func) and isinstance(args[0], DTensor)
        if inplace:
            spec, local = args[0]._spec, args[0]._local_tensor
        try:
            if replicate:
                def rep(a):
                    if not isinstance(a, DTensor):
                        return a
                    keep = a.device_mesh.ndim - replicate
                    with self._dtensor():
                        return a.redistribute(a.device_mesh, [
                            *a.placements[:keep],
                            *[Replicate()] * replicate])
                args, kwargs = tree_map(rep, (args, kwargs))
            self._pass = True
            self._inside += 1
            try:
                with self:
                    out = func(*args, **kwargs)
            finally:
                self._pass = False
                self._inside -= 1
            if not inplace or args[0]._spec.placements == spec.placements:
                return out
            # an in-place op DTensor placed anew: its target keeps its own
            # placements and shard, and the op runs replicated
            args[0]._spec, args[0]._local_tensor = spec, local
        except (RuntimeError, NotImplementedError) as e:
            if "Sharding propagation failed" not in str(e) and \
                    "sharding strategy" not in str(e):
                raise
        self.flops, self.bytes = undo[:2]
        del self.colls[undo[2]:]
        return _FAILED

    @contextlib.contextmanager
    def _dtensor(self):
        """DTensor's own work (redistributions, wrapping) under this mode:
        its collectives and local ops counted, its host bookkeeping not."""
        self._inside += 1
        try:
            with self:
                yield
        finally:
            self._inside -= 1

    def _replicated(self, func, args, kwargs):
        """``func`` where DTensor has no placement for it: a scatter-add
        split as XLA splits one (``_scatter_add``), else every DTensor
        input redistributed to ``Replicate``, the op on the whole tensors,
        and an in-place result scattered back to its placements."""
        from torch.distributed.tensor import Replicate
        flat = tree_flatten((args, kwargs))[0]
        mesh = next(a.device_mesh for a in flat if isinstance(a, DTensor))
        rep = [Replicate()] * mesh.ndim
        name = str(func)
        self.replicated[name] = self.replicated.get(name, 0) + 1

        def whole(a):
            if not isinstance(a, DTensor):
                return a
            with self._dtensor():
                local = a.redistribute(mesh, rep).to_local()
                wait = getattr(local, "wait", None)
                return wait() if callable(wait) else local

        wargs, wkwargs = tree_map(whole, (args, kwargs))
        with self:
            out = func(*wargs, **wkwargs)
        if _writes_first_arg(func):
            target = args[0]
            if isinstance(target, DTensor):
                with self._dtensor():
                    back = DTensor.from_local(
                        out, mesh, rep, run_check=False).redistribute(
                            mesh, target.placements).to_local()
                    target._local_tensor.copy_(back)
            return target
        with self._dtensor():
            return tree_map(lambda o: DTensor.from_local(o, mesh, rep,
                                                         run_check=False)
                            if isinstance(o, torch.Tensor) else o, out)

    def _scatter_add(self, func, args, kwargs):
        """``index_add(self, dim, index, source)`` (and an accumulating
        ``index_put`` of one index) split as XLA's partitioner splits a
        scatter-add.  On each mesh dimension ``self`` is replicated or
        sharded along ``dim``, ``index`` (1-D) replicated or sharded, and
        ``source`` replicated, sharded along ``dim`` with the index, or a
        partial sum.  Each device adds the rows its index shard names that
        fall in its slice of ``self`` (the others masked) into zeros, one
        all-reduce over the mesh dimensions of a sharded index or a partial
        source sums the results, and they are added to ``self``.  None where
        the placements do not fit."""
        if _mesh_of(args, kwargs).size() == 1:
            return None     # nothing to split
        from torch.distributed.tensor import Replicate, Shard
        import torch.distributed._functional_collectives as funcol
        if func in _INDEX_PUT:
            target, indices, source = args[:3]
            accumulate = (args[3] if len(args) > 3 else
                          kwargs.get("accumulate", False))
            if not accumulate or len(indices) != 1:
                return None
            dim, index, args, kwargs = 0, indices[0], args[:4], {}
        else:
            target, dim, index, source = args[:4]
        if len(args) > 4 or kwargs or index.dim() != 1:
            return None
        mesh = _mesh_of(args, {})
        dim = dim % source.dim()
        rep = [Replicate()] * mesh.ndim

        def dt(a):
            return a if isinstance(a, DTensor) else DTensor.from_local(
                a, mesh, rep, run_check=False)

        with self._dtensor():
            target_d, index_d, source_d = dt(target), dt(index), dt(source)
        tp, ip, sp = (target_d.placements, index_d.placements,
                      source_d.placements)
        rows_over, summed, src_want = [], [], []
        for m in range(mesh.ndim):
            if tp[m] == Shard(dim) and ip[m].is_replicate():
                rows_over.append(m)           # masked to the local rows
                src_want.append(Replicate())
            elif not tp[m].is_replicate():
                return None
            elif ip[m] == Shard(0):
                summed.append(m)              # partial sums of the shards
                src_want.append(Shard(dim))
            elif not ip[m].is_replicate():
                return None
            elif sp[m].is_partial():
                summed.append(m)
                src_want.append(sp[m])
            else:
                src_want.append(Replicate())
        n = math.prod(mesh.size(m) for m in rows_over)
        if target.shape[dim] % n:
            return None
        with self._dtensor():
            src = source_d.redistribute(mesh, src_want).to_local()
            idx = index_d.to_local()
        base = target_d.to_local()
        rows = base.shape[dim]
        with self:
            idx = idx.long()
            if rows_over:
                # rank 0's slice of ``dim`` starts at row 0
                ok = (idx >= 0) & (idx < rows)
                shape = [1] * src.dim()
                shape[dim] = -1
                src = torch.where(ok.reshape(shape), src, 0)
                idx = torch.clamp(idx, 0, rows - 1)
            part = torch.zeros_like(base).index_add_(dim, idx, src)
            if summed:
                part = funcol.wait_tensor(funcol.all_reduce(
                    part, "sum", _group_over(mesh, summed)))
            if _writes_first_arg(func):
                base.add_(part)
                return target
            out = base + part
        with self._dtensor():
            return DTensor.from_local(out, mesh, tp, run_check=False)

    def _sharded_dim(self, func, args, kwargs):
        """``gather(self, dim, index)`` / ``scatter_add(self, dim, index,
        src)`` with ``self`` sharded along ``dim`` on some mesh dimensions
        and ``index`` (and ``src``) replicated there, as XLA splits them:
        each device takes the indices that fall in its slice of ``dim``
        (the others masked), so a gather's result is a partial sum over
        those mesh dimensions and a scatter-add's stays sharded.  None
        where the placements do not fit."""
        if _mesh_of(args, kwargs).size() == 1:
            return None     # nothing to split
        from torch.distributed.tensor import Partial, Replicate, Shard
        scatter = func in _SCATTER
        if len(args) != (4 if scatter else 3) or kwargs:
            return None
        base, dim, index = args[:3]
        if not isinstance(base, DTensor) or base.dim() != index.dim():
            return None
        mesh, dim = base.device_mesh, dim % base.dim()
        over = [m for m, p in enumerate(base.placements) if p == Shard(dim)]
        n = math.prod(mesh.size(m) for m in over)
        if not over or base.shape[dim] % n or any(
                not (p.is_replicate() or (isinstance(p, Shard) and
                                          p.dim != dim))
                for m, p in enumerate(base.placements) if m not in over):
            return None
        want = [Replicate() if m in over else p
                for m, p in enumerate(base.placements)]
        rep = [Replicate()] * mesh.ndim

        def local(a):
            with self._dtensor():
                if not isinstance(a, DTensor):
                    a = DTensor.from_local(a, mesh, rep, run_check=False)
                return a.redistribute(mesh, want).to_local()

        idx = local(index)
        src = local(args[3]) if scatter else None
        rows = base.shape[dim] // n
        with self:
            # rank 0's slice of ``dim`` starts at row 0
            ok = (idx >= 0) & (idx < rows)
            li = torch.clamp(idx, 0, rows - 1)
            if scatter:
                masked = torch.where(ok, src, 0)
                if _writes_first_arg(func):
                    base.to_local().scatter_add_(dim, li, masked)
                    return base
                out = torch.scatter_add(base.to_local(), dim, li, masked)
                place = base.placements
            else:
                out = torch.where(ok, torch.gather(base.to_local(), dim, li),
                                  0)
                place = [Partial() if m in over else p
                         for m, p in enumerate(want)]
        with self._dtensor():
            return DTensor.from_local(out, mesh, place, run_check=False)


    def _softmax(self, func, args, kwargs):
        """(log-)softmax and their backward along a dimension sharded on
        some mesh dimensions, as XLA splits them: the row max and sum (the
        backward's row sum) all-reduced over those mesh dimensions, every
        other op local; the result keeps the input's placements.  None
        where the placements do not fit."""
        if _mesh_of(args, kwargs).size() == 1:
            return None     # nothing to split
        import torch.distributed._functional_collectives as funcol
        from torch.distributed.tensor import Replicate, Shard
        backward = func in _SOFTMAX_BACKWARD
        x = args[1] if backward else args[0]
        dim = args[2] if backward else args[1]
        if kwargs or not isinstance(x, DTensor):
            return None
        mesh, dim = x.device_mesh, dim % x.dim()
        over = [m for m, p in enumerate(x.placements) if p == Shard(dim)]
        if not over or any(p.is_partial() for p in x.placements):
            return None
        ins = [x]
        if backward:
            # the gradient as the output is placed (a replicated one is
            # sliced locally)
            with self._dtensor():
                g = args[0]
                if not isinstance(g, DTensor):
                    g = DTensor.from_local(g, mesh, [Replicate()] * mesh.ndim,
                                           run_check=False)
                ins = [g.redistribute(mesh, x.placements), x]
        group = _group_over(mesh, over)

        def reduce(t, op):
            return funcol.wait_tensor(funcol.all_reduce(t, op, group))

        log = func in (torch.ops.aten._log_softmax.default,
                       torch.ops.aten._log_softmax_backward_data.default)
        with self:
            if backward:
                g, out = (a.to_local() for a in ins)
                if log:
                    row = reduce(torch.sum(g, dim, keepdim=True), "sum")
                    res = g - torch.exp(out) * row
                else:
                    row = reduce(torch.sum(g * out, dim, keepdim=True),
                                 "sum")
                    res = out * (g - row)
                res = res.to(args[3])
            else:
                xl = x.to_local()
                if args[2]:
                    xl = xl.float()
                z = xl - reduce(torch.amax(xl, dim, keepdim=True), "max")
                row = reduce(torch.sum(torch.exp(z), dim, keepdim=True),
                             "sum")
                res = z - torch.log(row) if log else torch.exp(z) / row
        with self._dtensor():
            return DTensor.from_local(res, mesh, x.placements,
                                      run_check=False)


    def _bmm(self, func, args, kwargs):
        """A batched matmul whose operands are, on each mesh dimension,
        either replicated or sharded on their batch dimension (a plain or
        a strided shard, the layouts a merged batch dimension takes): run
        per device on its batch shard, a replicated operand sliced to it
        locally, as XLA keeps a batch dimension sharded.  DTensor would
        all-gather a strided operand to match a replicated one.  None
        where the placements do not fit."""
        if _mesh_of(args, kwargs).size() == 1:
            return None     # nothing to split
        if kwargs or len(args) != 2 or not all(
                isinstance(a, DTensor) for a in args):
            return None
        mesh = args[0].device_mesh
        place = []
        for m in range(mesh.ndim):
            ps = [a.placements[m] for a in args]
            if any(p.is_partial() for p in ps):
                return None
            batch = [p for p in ps if not p.is_replicate()]
            if any(getattr(p, "dim", None) != 0 for p in batch):
                return None
            place.append(batch[0] if batch else ps[0])
        if all(a.placements == tuple(place) for a in args):
            return None                       # DTensor's own case
        n = math.prod(mesh.size(m) for m, p in enumerate(place)
                      if not p.is_replicate())
        if args[0].shape[0] % n:
            return None
        # rank 0's batch shard: the first rows of each operand's shard
        rows = args[0].shape[0] // n
        with self:
            out = torch.bmm(*(a.to_local().narrow(0, 0, rows)
                              for a in args))
        shape = (args[0].shape[0], *out.shape[1:])
        with self._dtensor():
            return DTensor.from_local(out, mesh, place, run_check=False,
                                      shape=shape,
                                      stride=_contiguous_stride(shape))


    def _arg_reduction(self, func, args, kwargs):
        """``argmax`` / ``argmin`` along a dimension no mesh dimension
        shards: the local op on each shard (DTensor runs ``max.dim`` for it,
        which also writes the values).  None where the placements do not
        fit."""
        from torch.distributed.tensor import Shard
        x = args[0]
        dim = args[1] if len(args) > 1 else kwargs.get("dim")
        keep = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
        if dim is None or any(p.is_partial() for p in x.placements):
            return None
        dim = dim % x.dim()
        if any(isinstance(p, Shard) and p.dim == dim for p in x.placements):
            return None
        if any(not (p.is_replicate() or isinstance(p, Shard))
               for p in x.placements):
            return None
        with self:
            out = func(x.to_local(), dim, keep)
        place = [p if p.is_replicate() or keep or p.dim < dim
                 else Shard(p.dim - 1) for p in x.placements]
        with self._dtensor():
            return DTensor.from_local(out, x.device_mesh, place,
                                      run_check=False)


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _mesh_of(args, kwargs):
    return next(a.device_mesh for a in tree_flatten((args, kwargs))[0]
                if isinstance(a, DTensor))


def _group_over(mesh, dims: list):
    """The process group of the devices that differ from rank 0 only on
    mesh dimensions ``dims``: one dimension's group, the whole world, or
    a new group of those ranks."""
    import torch.distributed as dist
    if len(dims) == 1:
        return mesh.get_group(dims[0])
    if len(dims) == mesh.ndim:
        return dist.group.WORLD
    ranks = mesh.mesh
    for m in reversed(range(mesh.ndim)):
        if m not in dims:
            ranks = ranks.select(m, 0)
    key = tuple(ranks.flatten().tolist())
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(list(key))
    return _GROUPS[key]


_GROUPS: dict = {}
_INDEX_PUT = {torch.ops.aten.index_put_.default,
              torch.ops.aten.index_put.default}
_SCATTER = {torch.ops.aten.scatter_add.default,
            torch.ops.aten.scatter_add_.default}
_SOFTMAX_BACKWARD = {torch.ops.aten._log_softmax_backward_data.default,
                     torch.ops.aten._softmax_backward_data.default}
# the ops the count splits itself where their placements fit (DTensor would
# replicate them): scatter-adds into a replicated tensor, gathers,
# scatter-adds and (log-)softmax along a sharded dimension
_RULES = {**{op: _Count._scatter_add for op in (
    torch.ops.aten.index_add_.default, torch.ops.aten.index_add.default,
    *_INDEX_PUT)},
    **{op: _Count._sharded_dim for op in (
        torch.ops.aten.gather.default, *_SCATTER)},
    torch.ops.aten.bmm.default: _Count._bmm,
    torch.ops.aten.argmax.default: _Count._arg_reduction,
    torch.ops.aten.argmin.default: _Count._arg_reduction,
    **{op: _Count._softmax for op in (
        torch.ops.aten._log_softmax.default, torch.ops.aten._softmax.default,
        *_SOFTMAX_BACKWARD)}}
_FAILED = object()


class _Flops(TorchDispatchMode):
    """``_Count``'s FLOPs of an op's decomposition (its bytes are the op's
    own)."""

    def __init__(self, count: _Count):
        super().__init__()
        self.count = count

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is not torch.ops.prim.device.default:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        self.count._flops(func, out, args, kwargs)
        return out


@dataclass
class Count:
    """One counted run: its ``Cost`` (the kernels' analytic FLOPs and bytes
    included), the outputs off ``meta`` (a meta run's), the kernels'
    charges, the bytes by part and by (part, op) (when asked), the step's
    output (local shards for a partitioned count), and the ops DTensor ran
    replicated ({op: calls})."""
    cost: RA.Cost
    off_meta: dict
    kernels: dict
    parts: dict | None
    ops: dict | None
    out: object
    replicated: dict = field(default_factory=dict)
    sites: dict = field(default_factory=dict)
    split: dict = field(default_factory=dict)


def _local_bytes(args, used: set, specs=None, mesh=None) -> int:
    """The bytes of the tensors of ``args`` whose storage is in ``used``
    (an argument nothing reads is dropped, as ``jax.jit`` drops it), each
    at its local shape under ``specs`` on ``mesh`` when given."""
    if specs is None:
        return sum(_nbytes(t) for t in _tensors(args)
                   if t.untyped_storage()._cdata in used)

    def walk(a, s):
        if isinstance(a, torch.Tensor):
            return (PT.local_nbytes(a, s, mesh)
                    if a.untyped_storage()._cdata in used else 0)
        if isinstance(a, dict):
            return sum(walk(v, s[k]) for k, v in a.items())
        if isinstance(a, (tuple, list)):
            return sum(walk(v, x) for v, x in zip(a, s))
        return 0

    return walk(args, specs)


def _run(step_fn, args, mode: _Count):
    with mode, kernels.count_kernels(mode.charge), \
            dist_core.count_collectives(mode.collective):
        return step_fn(*args)


def count(step_fn, args, *, meta: bool = True, parts: bool = False,
          shardings=None, mesh=None, shard_specs=None,
          out_specs=None) -> Count:
    """Run ``step_fn(*args)`` once under the counting mode; ``meta=False``
    for real tensors (no record of outputs off ``meta``), ``parts`` to
    split the bytes by part of the step.

    With ``shardings`` (a spec tree parallel to ``args``) the count is of
    the partitioned per-device program on ``mesh``: the arguments become
    DTensors over a fake group of the mesh's device count
    (``partition.fake_group``), and every FLOP, byte, collective and live
    byte is rank 0's.  With ``shard_specs`` the step is a single
    controller's run of every mesh cell's program (favor-anns' meta
    cells): its totals cover every program, and its argument and output
    bytes are one cell's, each at its local shape under its spec
    (``out_specs`` for the outputs)."""
    mode = _Count(note_off_meta=meta, parts=parts)
    if shardings is None:
        arg_keys = {mode.live.hold(t) for t in _tensors(args)}
        start = mode.live.bytes
        out = _run(step_fn, args, mode)
        local_out = out
        arg_bytes = _local_bytes(args, mode.live.used, shard_specs, mesh)
    else:
        with PT.fake_group(mesh) as dmesh, implicit_replication():
            dargs = PT.distribute(args, shardings, dmesh, mesh)
            local_args = PT.to_local(dargs)
            arg_keys = {mode.live.hold(t) for t in _tensors(local_args)}
            start = mode.live.bytes
            mode.meta_factories = True
            out = _run(step_fn, dargs, mode)
            local_out = PT.to_local(out)
            arg_bytes = _local_bytes(local_args, mode.live.used)
            del dargs, local_args, out
    # temporaries: the peak's bytes beyond the arguments and the outputs
    # that are not arguments updated in place
    fresh = {}
    for t in _tensors(local_out):
        st = t.untyped_storage()
        if st._cdata not in arg_keys:
            fresh[st._cdata] = st.nbytes()
    temp = max(0, mode.live.peak - start - sum(fresh.values()))
    counts, by_op, sites = mode.collectives()
    if out_specs is None:
        out_bytes = sum(_nbytes(t) for t in _tensors(local_out))
    else:
        out_bytes = _local_bytes(local_out, {
            t.untyped_storage()._cdata for t in _tensors(local_out)},
            out_specs, mesh)
    cost = RA.Cost(flops=float(mode.flops),
                   bytes_accessed=float(mode.bytes),
                   argument_bytes=arg_bytes, output_bytes=out_bytes,
                   coll_link_bytes=float(sum(by_op.values())),
                   collectives={"counts": counts, "by_op": by_op},
                   temp_bytes=temp)
    return Count(cost, {d: list(ops.values())
                        for d, ops in mode.off_meta.items()},
                 mode.kernels, mode.parts, mode.ops if parts else None,
                 local_out, mode.replicated, sites, mode.split)


def count_step(step_fn, args) -> tuple[RA.Cost, dict]:
    """Run ``step_fn(*args)`` once under the counting mode.  Returns its
    ``Cost`` and the outputs that landed anywhere but ``meta`` ({device:
    [{op, shape, dtype, bytes, at, count}]}; empty when the step allocated
    nothing)."""
    c = count(step_fn, args)
    return c.cost, c.off_meta


BLOCK_NOTE = ("one mesh cell on synthetic data: a random graph's wave "
              "count is not a production one")


def count_block(cell, device=None, seed: int = 0, data_device=None):
    """Make ``cell``'s block (``cells.Block``) on ``device`` (the card
    unless given; raises without one) from ``seed`` and count its step on
    those real tensors.  Returns (the record's fields, the ``Count``, the
    ``Block``)."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    t0 = time.perf_counter()
    block = cell.block(dev, seed, data_device)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    made_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    c = count(block.step_fn, block.args, meta=False, parts=True)
    if cuda:
        torch.cuda.synchronize(dev)
    count_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    top = sorted(c.ops.items(), key=lambda kv: -kv[1])[:8]
    fields = {"lower_s": made_s, "compile_s": count_s,
              "block": {**block.info, **block.facts(), "device": str(dev),
                        "seed": seed, "peak_memory_bytes": peak},
              "count": {"kernels": c.kernels, "parts": c.parts,
                        "top_ops": dict(top)}}
    return fields, c, block


def block_collectives(cost: RA.Cost, queries: int, k: int, g: int):
    """``cost`` with the collectives one device program of the favor-anns
    graph cell runs over a ``model`` axis of ``g`` -- the estimate's
    all-reduces and the merge's all-gathers at the block's ``queries`` and
    ``k`` (``core.distributed.serve_collectives``) -- added: a block runs
    on a 1 x 1 mesh, where they move nothing."""
    counts = dict(cost.collectives["counts"])
    by_op = dict(cost.collectives["by_op"])
    link = cost.coll_link_bytes
    if g > 1:
        for kind, operand in dist_core.serve_collectives(queries, k,
                                                         estimate=True):
            b = RA.ring_link_bytes(kind, operand, g)
            counts[kind] = counts.get(kind, 0) + 1
            by_op[kind] = by_op.get(kind, 0.0) + b
            link += b
    return dataclasses.replace(cost, coll_link_bytes=link,
                               collectives={"counts": counts,
                                            "by_op": by_op})


def _top(sites: dict, n: int = 8) -> dict:
    """The ``n`` collective sites that move the most link bytes."""
    return dict(sorted(sites.items(), key=lambda kv: -kv[1])[:n])


def off_meta_bytes(off_meta: dict) -> int:
    """The bytes of every output ``count_step`` saw land off ``meta``."""
    return sum(e["bytes"] * e["count"] for ops in off_meta.values()
               for e in ops)


def run_cell(arch: str, shape: str, multi_pod: bool, *, builder=None,
             device=None, seed: int = 0, keep: dict | None = None) -> dict:
    """Build one (arch x shape x mesh) cell and count its per-device
    program on the production mesh; return the record.

    A cell with shardings is counted partitioned: its step on DTensors of
    its specs over a fake process group of the mesh's device count
    (``count(..., shardings=)``).  A single controller's cell (favor-anns'
    meta cells, the JAX package's ``shard_map`` steps) runs every mesh
    cell's program and charges the collectives where data crosses cells;
    its totals are divided by the device count.  A cell with a ``block``
    is counted on real tensors instead: one mesh cell's block on
    ``device`` from ``seed`` (``count_block``), with its collectives added
    for the mesh's ``model`` axis.  A cell that cannot be partitioned is
    ``ok: false`` with its traceback.  ``keep``, a dict, receives the
    ``Count`` (and a block cell's ``Block``)."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = math.prod(mesh.devices.shape)
    mesh_name = "x".join(str(s) for s in mesh.devices.shape)
    axes = ", ".join(f"{a}={n}" for a, n in zip(mesh.axis_names,
                                                 mesh.devices.shape))
    g = dict(zip(mesh.axis_names, mesh.devices.shape)).get("model", 1)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "ok": False}
    try:
        t0 = time.perf_counter()
        cell = (builder or C.build_cell)(arch, shape, mesh)
        rec["lower_s"] = time.perf_counter() - t0
        if cell.block is not None:
            rec["partition"] = (
                f"partitioned ({axes}): one mesh cell counted on real "
                f"tensors, the per-device program of one of the {n_dev} "
                "blocks; per-device terms are that count, not divided; "
                f"its collectives added for model={g}")
            fields, c, block = count_block(cell, device, seed)
            if keep is not None:
                keep["block"] = block
            fields["lower_s"] += rec["lower_s"]
            rec.update(fields)
            c.cost = block_collectives(c.cost, fields["block"]["queries"],
                                       fields["block"]["k"], g)
            n_per, programs = 1, 1
            mf = fields["block"]["model_flops"]
            rec["note"] = f"{cell.note}; {BLOCK_NOTE}"
        else:
            t0 = time.perf_counter()
            if cell.in_shardings is None:
                rec["partition"] = (
                    f"partitioned ({axes}): a single controller runs the "
                    f"program of each of the {n_dev} mesh cells; per-device "
                    f"terms are the count / {n_dev}; collectives charged "
                    "where data crosses mesh cells")
                c = count(cell.step_fn, cell.args,
                          shard_specs=cell.shard_specs,
                          out_specs=cell.out_specs, mesh=mesh)
                programs = n_dev
            else:
                rec["partition"] = (f"partitioned ({axes}): DTensor, fake "
                                    f"group of {n_dev}")
                c = count(cell.step_fn, cell.args,
                          shardings=cell.in_shardings, mesh=mesh)
                programs = 1
            rec["compile_s"] = time.perf_counter() - t0
            rec["off_meta_ops"] = c.off_meta
            rec["count"] = {"kernels": c.kernels,
                            "replicated_ops": c.replicated,
                            "split_by_rule": c.split,
                            "collectives_at": _top(c.sites)}
            n_per, mf = n_dev, cell.model_flops
            rec["note"] = cell.note
        if keep is not None:
            keep["count"] = c
        rec["memory"] = RA.memory_analysis_dict(c.cost)
        rec["roofline"] = RA.analyze(c.cost, n_per, mf, programs).to_dict()
        rec["ok"] = True
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--skip-favor", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where a cell counted on real tensors runs "
                         "(default: the card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    todo = []
    for arch, spec in all_specs(include_favor=not args.skip_favor).items():
        if args.arch and arch != args.arch:
            continue
        for cell in spec.cells:
            if args.shape and cell.name != args.shape:
                continue
            todo.append((arch, cell.name, C.skip_reason(arch, cell.name)))

    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results if r.get("ok")}

    for arch, shape, skip in todo:
        for multi in meshes:
            mesh_name = "2x16x16" if multi else "16x16"
            if (arch, shape, mesh_name) in done:
                print(f"[skip-done] {arch} x {shape} x {mesh_name}")
                continue
            if skip:
                rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                       "ok": True, "skipped": skip}
                print(f"[SKIP] {arch} x {shape}: {skip}")
            else:
                print(f"[run ] {arch} x {shape} x {mesh_name} ...", flush=True)
                rec = run_cell(arch, shape, multi, device=args.device,
                               seed=args.seed)
                if rec["ok"]:
                    r = rec["roofline"]
                    waves = (f" waves={rec['block']['waves']}"
                             if "block" in rec else "")
                    print(f"   ok build={rec['lower_s']:.1f}s "
                          f"count={rec['compile_s']:.1f}s "
                          f"bottleneck={r['bottleneck']} "
                          f"tc={r['t_compute_s']:.4f} tm={r['t_memory_s']:.4f} "
                          f"tx={r['t_collective_s']:.4f} "
                          f"roofline_frac={r['roofline_frac']:.3f}{waves}",
                          flush=True)
                else:
                    print(f"   FAIL {rec['error']}", flush=True)
            results = [r for r in results
                       if (r["arch"], r["shape"], r["mesh"]) !=
                       (arch, shape, mesh_name)]
            results.append(rec)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    n_ok = sum(1 for r in results if r.get("ok"))
    print(f"\n{n_ok}/{len(results)} cells ok -> {args.out}")


if __name__ == "__main__":
    main()
