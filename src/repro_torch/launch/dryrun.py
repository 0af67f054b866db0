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

  * FLOPs are ``torch.utils.flop_counter``'s formulas for the
    matmul-like ops (``mm``, ``bmm``, ``addmm``, attention) and XLA's cost
    analysis rules for the rest (``xla_flops``: an elementwise op one an
    element, a transcendental none, a reduction one an input element it
    folds, an all-reduce's adds), with XLA's fusion duplication modelled
    (``_Count._fused``); each record splits them by class
    (``count.flops_by``);
  * bytes are the inputs plus outputs of every op that is not a view,
    unfused: an upper bound beside XLA's count of a fused program (an
    indexing op is charged its whole source tensor, as XLA's cost model
    charges a gather its whole operand);
  * collectives are charged their ring link bytes per device
    (``analysis.ring_link_bytes``) over their group's size, by kind
    (``roofline.collectives``) and by site (``count.collectives_at``: the
    kind, group, calling line and DTensor op of the heaviest);
  * where DTensor would replicate an op XLA splits, or place it
    otherwise -- a scatter-add, a gather or scatter-add along a sharded
    dimension, a (log-)softmax along one, a batched matmul (batch, row,
    column and contraction shards, plain or strided; an expert FFN
    resharded onto its experts), rows taken from a sharded table, a
    pointwise op or a copy on a partial sum (all-reduced first), a view
    that splits a head dimension finer than its KV groups or flattens a
    sharded inner dimension, ``detach_``, an argmax -- the count
    splits it as XLA does (``count.split_by_rule``); the rules also fix
    one placement where torch versions' DTensor differ
    (``launch/pinned.py`` pins two cells' counts); an op DTensor cannot
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
# innermost function of this package on the stack that names one; a
# ``stable_topk`` is named by its caller (the wave's pool merges, the
# shards' merge), elsewhere it counts as its caller's
_PARTS = {"estimate": "estimate", "_descend": "descent",
          "_seen_bits": "visited", "_visit_bits": "visited",
          "stage_loop": "wave", "_graph_traverse": "traversal"}
_TOPK_PARTS = {"stage_loop": "pools", "_per_block": "shard merge"}


def _part() -> str:
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_name
        part = (_TOPK_PARTS.get(f.f_back.f_code.co_name)
                if name == "stable_topk" and f.f_back is not None
                else _PARTS.get(name))
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
    ``FlopCounterMode`` counts, and ``xla_flops`` for the leaves without
    a formula), the bytes read and written by every op
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
        self.flops_by: dict = {}    # class -> FLOPs (``xla_flops``)
        self._chain: dict = {}      # storage -> [chain FLOPs an element,
        #                              uses, charged again]
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
        self.flops_by["kernels"] = self.flops_by.get("kernels", 0.0) + flops
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
                adds = sum(t.numel() for t in operands)
                self.flops += adds
                self.flops_by["collective"] = \
                    self.flops_by.get("collective", 0.0) + adds
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
            f, cls = formula(*args, **kwargs, out_val=out), "matmul"
        else:
            f, cls = xla_flops(func, args, kwargs, out)
        if f:
            self.flops += f
            self.flops_by[cls] = self.flops_by.get(cls, 0.0) + f
        if not _is_view(func):
            dup = self._fused(func, out, args, kwargs)
            if dup:
                self.flops += dup
                self.flops_by["fusion"] = self.flops_by.get("fusion",
                                                            0.0) + dup

    def _fused(self, func, out, args, kwargs) -> float:
        """XLA's fusion duplicates an elementwise chain into each of its
        consumers instead of writing its result once, and its cost analysis
        charges every copy.  Each output of an elementwise op carries the
        FLOPs an element of the chain that made it (its own plus those of
        its inputs of its size); its first consumer is free, each later one
        (and a softmax, which reads its input in its max and its exp
        fusions) is charged the chain again.  A softmax's output carries
        its input's chain and its own subtract and divide.  Returns the
        FLOPs charged again."""
        name = func._overloadpacket.__name__
        o = _first(out)
        n = _numel(o)
        dup, carried, seen = 0.0, 0.0, set()
        for t in tree_flatten((args, kwargs))[0]:
            if not isinstance(t, torch.Tensor):
                continue
            key = t.untyped_storage()._cdata
            c = self._chain.get(key)
            if c is None or key in seen:
                continue
            seen.add(key)
            c[1] += 2 if name in _SOFTMAX else 1
            if c[1] > 1 and not c[2]:
                dup += c[0] * t.numel()
                c[2] = True
            if t.numel() == n:
                carried += c[0]
        own = _chain_flops(func, args, kwargs, out)
        if own is not None and o is not None and n and (own or carried):
            key = o.untyped_storage()._cdata
            if key not in self._chain:
                weakref.finalize(o.untyped_storage(), self._chain.pop, key,
                                 None)
            self._chain[key] = [own + carried, 0, False]
        return dup

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
        rule = _RULES.get(func) or (
            _Count._pointwise if torch.Tag.pointwise in func.tags else None)
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
        if func in _VIEWS:
            out = self._reshard_view(func, args, kwargs)
            if out is not _FAILED:
                name = f"{func} (resharded)"
                self.split[name] = self.split.get(name, 0) + 1
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
        mark = self._mark()
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
        self._rewind(mark)
        return _FAILED

    def _mark(self) -> tuple:
        return self.flops, self.bytes, len(self.colls), dict(self.flops_by)

    def _rewind(self, mark: tuple) -> None:
        """Forget every charge made since ``mark``."""
        self.flops, self.bytes = mark[:2]
        del self.colls[mark[2]:]
        self.flops_by = mark[3]

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

    def _flatten_view(self, func, args, kwargs):
        """A view that flattens a run of dimensions whose sharded dimension
        is not the run's first (heads merged into a batch, a weight's heads
        into its feature dimension): the merged dimension a plain shard of
        the same size, moving nothing.  Torch 2.13's DTensor makes it a
        strided shard, which 2.11's can neither make nor redistribute; the
        count takes one placement for both (each device holds the same
        number of rows; which rows does not change a count).  The split of
        a dimension that several mesh dimensions shard (such a merged one
        split back) gives each mesh dimension the first factor its size
        divides, where DTensor would put them all on the first factor.
        None where the view moves no such shard or is not a run of
        flattens and splits."""
        from torch.distributed.tensor import Shard
        if _mesh_of(args, kwargs).size() == 1:
            return None     # nothing to split
        x = args[0]
        if not isinstance(x, DTensor) or len(args) != 2 or kwargs or any(
                _shard_dim(p) is not None and type(p) is not Shard
                for p in x.placements):
            return None
        src, mesh = tuple(x.shape), x.device_mesh
        dst = tuple(_full_shape(args[1], math.prod(src)))
        groups = _view_groups(src, dst)
        if groups is None:
            return None
        place, moved = list(x.placements), False
        left = {}                  # a split dimension's factors still free
        for m, p in enumerate(x.placements):
            d = _shard_dim(p)
            a, b = next((g for g in groups if d in g[0]), ((), ()))
            if len(a) >= 2 and len(b) == 1 and d != a[0]:
                place[m] = Shard(b[0])
                moved = True
            elif len(a) == 1 and len(b) >= 2 and sum(
                    _shard_dim(q) == d for q in x.placements) > 1:
                # a dimension several mesh dimensions shard, split: each
                # takes the first factor (in order) its size divides
                rest = left.setdefault(d, {k: dst[k] for k in b})
                k = next((k for k in b if rest[k] % mesh.size(m) == 0),
                         None)
                if k is None:
                    return None
                rest[k] //= mesh.size(m)
                place[m] = Shard(k)
                moved = True
        if not moved:
            return None
        local = list(dst)
        for m, p in enumerate(place):
            d = _shard_dim(p)
            if d is not None:
                if local[d] % mesh.size(m):
                    return None
                local[d] //= mesh.size(m)
        with self:
            out = func(x.to_local(), local)
        with self._dtensor():
            return DTensor.from_local(out, mesh, place, run_check=False,
                                      shape=dst,
                                      stride=_contiguous_stride(dst))

    def _pointwise(self, func, args, kwargs):
        """A pointwise op (or a copy) with a partial-sum input: the partial
        all-reduced first, as XLA all-reduces a row-parallel product before
        a norm, a residual add or a copy.  Torch 2.13's DTensor
        reduce-scatters it onto a dimension of its own choosing where
        2.11's all-reduces; the count takes XLA's.  None where the op keeps
        the sum partial in every version (a sum or difference of partial
        sums, a partial times or over a scalar), is in place, or nothing is
        partial."""
        from torch.distributed.tensor import Replicate
        ins = [a for a in tree_flatten((args, kwargs))[0]
               if isinstance(a, DTensor)]
        if not ins or ins[0].device_mesh.size() == 1 or \
                _writes_first_arg(func) or not any(
                p.is_partial() for a in ins for p in a.placements):
            return None
        name = func._overloadpacket.__name__
        if (name in ("add", "sub") and len({a.placements for a in ins}) == 1
                and all(p.is_partial() for p in ins[0].placements)) or (
                name in ("mul", "div", "neg") and len(ins) == 1):
            return None
        mark = self._mark()

        def whole(a):
            if not isinstance(a, DTensor) or not any(
                    p.is_partial() for p in a.placements):
                return a
            with self._dtensor():
                return a.redistribute(a.device_mesh, [
                    Replicate() if p.is_partial() else p
                    for p in a.placements])

        out = self._attempt(func, *tree_map(whole, (args, kwargs)))
        if out is _FAILED:
            self._rewind(mark)
            return None
        return out

    def _detach_(self, func, args, kwargs):
        """``detach_`` of a DTensor: its local tensor's, in place.  Torch
        2.11's DTensor has no strategy for it and its redistribution
        dispatches ``detach_`` again."""
        x = args[0]
        if not isinstance(x, DTensor) or len(args) != 1 or kwargs:
            return None
        with self:
            func(x._local_tensor)
        return x

    def _reshard_view(self, func, args, kwargs):
        """A view DTensor cannot place: it splits a dimension sharded finer
        than its first factor (a head dimension split into KV groups on a
        model axis larger than the group count).  The shard moves (an
        all-to-all) to the first dimension the view keeps whole that takes
        it (the batch: a later flatten merges it as its leading dimension,
        which every torch's DTensor shards alike), and the view runs there,
        so each device keeps its share of the work, as XLA's partitioner
        keeps it; DTensor would replicate the view and everything after
        it.  ``_FAILED`` where no kept dimension takes the shard."""
        from torch.distributed.tensor import Shard
        x, shape = args[0], list(args[1])
        if not isinstance(x, DTensor) or len(args) != 2 or kwargs:
            return _FAILED
        mesh = x.device_mesh
        kept = []
        for i, (a, b) in enumerate(zip(x.shape, shape)):
            if a != b:
                break
            kept.append(i)
        place = list(x.placements)
        for m, p in enumerate(place):
            if type(p) is not Shard or p.dim in kept:
                continue
            free = [d for d in kept
                    if x.shape[d] % (mesh.size(m) * math.prod(
                        mesh.size(k) for k, q in enumerate(place)
                        if _shard_dim(q) == d)) == 0]
            if not free:
                return _FAILED
            place[m] = Shard(free[0])
        with self._dtensor():
            x = x.redistribute(mesh, place)
        out = self._attempt(func, (x, args[1]), kwargs)
        return out

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
            if not accumulate or len(indices) != 1 or indices[0] is None \
                    or indices[0].dtype == torch.bool:
                return None
            dim, index, args, kwargs = 0, indices[0], args[:4], {}
            if index.dim() > 1 and isinstance(index, DTensor) and \
                    isinstance(source, DTensor):
                # an index of several dimensions (an embedding's gradient):
                # the index and the source's leading dimensions flattened
                with self._dtensor():
                    source = source.reshape(-1, *source.shape[index.dim():])
                    index = index.reshape(-1)
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
        rows_over, summed, src_want, src_over = [], [], [], []
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
            elif type(sp[m]) is Shard and sp[m].dim == dim:
                # the source's rows split, the index whole: each device adds
                # the rows it holds under their slice of the index
                summed.append(m)
                src_over.append(m)
                src_want.append(sp[m])
            else:
                src_want.append(Replicate())
        n = math.prod(mesh.size(m) for m in rows_over)
        if target.shape[dim] % n or source.shape[dim] % math.prod(
                mesh.size(m) for m in src_over):
            return None
        with self._dtensor():
            src = source_d.redistribute(mesh, src_want).to_local()
            idx = index_d.to_local()
        base = target_d.to_local()
        rows = base.shape[dim]
        with self:
            idx = idx.long()
            if src_over:
                # rank 0's rows of the source are its first ones
                idx = idx.narrow(0, 0, src.shape[dim])
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
        """A batched matmul ``a (B, M, K) @ b (B, K, N)`` split as XLA's
        partitioner splits a dot, mesh dimension by mesh dimension (plain
        and strided shards alike -- the layouts a merged dimension takes):

          * the batch sharded by either operand: both run on their batch
            shard, a replicated operand sliced to it locally, an operand
            sharded on another dimension resharded onto the batch first (an
            all-to-all: an expert-parallel FFN, its weights split by expert
            and its dispatched tokens by feature);
          * ``a``'s rows or ``b``'s columns sharded: kept, the other operand
            whole (all-gathered where it is sharded on the contraction and
            is the smaller);
          * the contraction sharded by one operand: the other sliced to it
            locally, the product a partial sum.

        DTensor would all-gather a strided or row-sharded operand to match
        the other, or shard the contraction of an expert FFN and all-reduce
        the product.  None where an operand is a partial sum, where both
        already agree, or where the placements fit none of these."""
        from torch.distributed.tensor import Partial, Replicate, Shard
        if _mesh_of(args, kwargs).size() == 1:
            return None     # nothing to split
        if kwargs or len(args) != 2 or not all(
                isinstance(a, DTensor) for a in args):
            return None
        a, b = args
        mesh = a.device_mesh
        if a.placements == b.placements:
            return None                       # DTensor's own case
        want = [list(a.placements), list(b.placements)]
        out, batch, contract = [], [], []
        small = [_nbytes(a) <= _nbytes(b), _nbytes(b) < _nbytes(a)]
        for m in range(mesh.ndim):
            pa, pb = a.placements[m], b.placements[m]
            if pa.is_partial() or pb.is_partial():
                return None
            da, db = _shard_dim(pa), _shard_dim(pb)
            if 0 in (da, db):
                bp = pa if da == 0 else pb
                for j, (q, d) in enumerate(((pa, da), (pb, db))):
                    if d is not None and q != bp:
                        if type(bp) is not Shard:
                            return None
                        want[j][m] = bp
                batch.append(m)
                out.append(bp)
            elif da is None and db is None:
                out.append(Replicate())
            elif da == 1 and (db is None or (db == 1 and small[1])):
                want[1][m] = Replicate()
                out.append(pa)
            elif db == 2 and (da is None or (da == 2 and small[0])):
                want[0][m] = Replicate()
                out.append(pb)
            elif da == 1 and db == 2:
                want[int(small[1])][m] = Replicate()
                out.append(pb if small[0] else pa)
            elif (da, db) in ((2, None), (None, 1)) or (
                    da == 2 and db == 1 and pa == pb):
                contract.append(m)
                out.append(Partial())
            else:
                return None
        nb = math.prod(mesh.size(m) for m in batch)
        nk = math.prod(mesh.size(m) for m in contract)
        if a.shape[0] % nb or a.shape[2] % nk:
            return None
        if [list(a.placements), list(b.placements)] != want:
            with self._dtensor():
                a, b = (t.redistribute(mesh, w) for t, w in zip((a, b), want))
        rows, k = a.shape[0] // nb, a.shape[2] // nk
        with self:
            # rank 0's batch and contraction shards are the first ones
            out_l = torch.bmm(a.to_local().narrow(0, 0, rows).narrow(2, 0, k),
                              b.to_local().narrow(0, 0, rows).narrow(1, 0, k))
        shape = (a.shape[0], a.shape[1], b.shape[2])
        with self._dtensor():
            return DTensor.from_local(out_l, mesh, out, run_check=False,
                                      shape=shape,
                                      stride=_contiguous_stride(shape))

    def _take_rows(self, func, args, kwargs):
        """``index(self, [index])`` / ``index_select(self, 0, index)``: rows
        of ``self`` taken by an integer index, split on each mesh dimension
        as XLA splits a gather:

          * the index sharded (``self`` replicated): each device takes the
            rows its index shard names, the result sharded as the index;
          * ``self``'s rows sharded (the index replicated), ``self`` a
            float tensor: each device takes the rows that fall in its slice
            (the others zero), the result a partial sum (a vocab-sharded
            embedding lookup);
          * ``self`` sharded on another dimension: the result sharded on
            that dimension (after the index's).

        Torch 2.11's and 2.13's DTensor place these differently (2.11
        replicates the index or all-gathers the table); the rule fixes
        one placement for both.  None where the placements do not fit."""
        from torch.distributed.tensor import Partial, Replicate, Shard
        if _mesh_of(args, kwargs).size() == 1:
            return None     # nothing to split
        if func is torch.ops.aten.index_select.default:
            if len(args) != 3 or kwargs or args[1] != 0:
                return None
            base, index = args[0], args[2]
        else:
            if len(args) != 2 or kwargs or len(args[1]) != 1 or \
                    args[1][0] is None:
                return None
            base, index = args[0], args[1][0]
        if not isinstance(base, DTensor) or index.dtype == torch.bool:
            return None
        mesh = base.device_mesh
        if not isinstance(index, DTensor):
            with self._dtensor():
                index = DTensor.from_local(index, mesh,
                                           [Replicate()] * mesh.ndim,
                                           run_check=False)
        place, masked = [], []
        for m, (pb, pi) in enumerate(zip(base.placements, index.placements)):
            db, di = _shard_dim(pb), _shard_dim(pi)
            if pb.is_partial() or pi.is_partial():
                return None
            if db is None:
                place.append(pi)
            elif di is not None or type(pb) is not Shard:
                return None
            elif db == 0:
                if not base.dtype.is_floating_point:
                    return None           # ids and positions: DTensor's
                masked.append(m)
                place.append(Partial())
            else:
                place.append(Shard(index.dim() + db - 1))
        rows = base.shape[0] // math.prod(mesh.size(m) for m in masked)
        if base.shape[0] % math.prod(mesh.size(m) for m in masked):
            return None
        with self:
            li, lb = index.to_local(), base.to_local()
            if masked:
                # rank 0's slice of the rows starts at row 0
                ok = (li >= 0) & (li < rows)
                li = torch.clamp(li, 0, rows - 1)
            out = func(lb, 0, li) if len(args) == 3 else func(lb, [li])
            if masked:
                out = torch.where(ok.reshape(*ok.shape, *[1] * (
                    out.dim() - ok.dim())), out, 0)
        shape = (*index.shape, *base.shape[1:])
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


def _full_shape(shape, numel: int) -> list:
    """A view's target shape with its -1 resolved."""
    shape = list(shape)
    if -1 in shape:
        rest = math.prod(n for n in shape if n != -1)
        shape[shape.index(-1)] = numel // rest if rest else 0
    return shape


def _view_groups(src, dst):
    """A reshape of ``src`` to ``dst`` as runs [(source dims, target
    dims)] of equal size, size-1 dimensions left out -- each run a
    flatten, a split or one dimension kept -- or None where a run is both
    (or a size is 0)."""
    if 0 in src or 0 in dst or math.prod(src) != math.prod(dst):
        return None
    si = [k for k, n in enumerate(src) if n != 1]
    di = [k for k, n in enumerate(dst) if n != 1]
    groups, i, j = [], 0, 0
    while i < len(si) and j < len(di):
        a, b, pa, pb = [si[i]], [di[j]], src[si[i]], dst[di[j]]
        i, j = i + 1, j + 1
        while pa != pb:
            if pa < pb:
                pa *= src[si[i]]
                a.append(si[i])
                i += 1
            else:
                pb *= dst[di[j]]
                b.append(di[j])
                j += 1
        if len(a) > 1 and len(b) > 1:
            return None
        groups.append((a, b))
    return groups


def _shard_dim(p):
    """The tensor dimension a plain or strided shard splits; None for a
    replicated or partial placement."""
    return None if p.is_replicate() or p.is_partial() else p.dim


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
_VIEWS = {torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default,
          torch.ops.aten.reshape.default}
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
    **{op: _Count._flatten_view for op in _VIEWS},
    torch.ops.aten.detach_.default: _Count._detach_,
    torch.ops.aten.index.Tensor: _Count._take_rows,
    torch.ops.aten.index_select.default: _Count._take_rows,
    torch.ops.aten._to_copy.default: _Count._pointwise,
    torch.ops.aten.argmax.default: _Count._arg_reduction,
    torch.ops.aten.argmin.default: _Count._arg_reduction,
    **{op: _Count._softmax for op in (
        torch.ops.aten._log_softmax.default, torch.ops.aten._softmax.default,
        *_SOFTMAX_BACKWARD)}}
_FAILED = object()


# XLA's ``HloCostAnalysis`` rules for what ``flop_registry`` leaves out, by
# aten op: an elementwise op is one FLOP an output element (a compare, a
# select and a convert included); a transcendental (exp, log, tanh,
# logistic, sqrt, rsqrt, sin, cos, power, ...) none -- XLA counts those
# apart; a reduction one an input element it folds away (input elements
# less output elements); a scatter-add one an update; a sort n ceil(log2 n);
# data movement (views, copies, slices, gathers, concatenation, padding,
# fills) none.  A fused op is charged the HLO it lowers to in the JAX
# package: softmax max, subtract, exp, sum, divide; its backward multiply,
# sum, subtract, multiply; ``x ** e`` for an integer e XLA's square-and-
# multiply chain.
_EW1 = {
    "add", "add_", "sub", "sub_", "rsub", "mul", "mul_", "div", "div_",
    "neg", "abs", "where", "maximum", "minimum", "clamp", "clamp_",
    "clamp_min", "clamp_max", "eq", "ne", "lt", "le", "gt", "ge",
    "logical_and", "logical_or", "logical_not", "logical_xor",
    "bitwise_and", "bitwise_or", "bitwise_not", "bitwise_xor", "sign",
    "reciprocal", "masked_fill", "masked_fill_", "relu", "silu", "floor",
    "ceil", "round", "trunc", "remainder", "fmod", "square", "isnan",
    "isinf", "isfinite", "nan_to_num", "heaviside"}
_TRANSCENDENTAL = {
    "exp", "exp2", "log", "log2", "log10", "log1p", "expm1", "tanh",
    "sigmoid", "sin", "cos", "tan", "sqrt", "rsqrt", "erf", "erfinv",
    "atan", "atan2", "asin", "acos", "sinh", "cosh", "asinh", "acosh",
    "atanh"}
# an output element's FLOPs for a fused elementwise op (its JAX lowering)
_EW_FUSED = {"tanh_backward": 3, "sigmoid_backward": 3, "silu_backward": 5,
             "threshold_backward": 1}
_REDUCE = {"sum", "amax", "amin", "max", "min", "prod", "any", "all",
           "argmax", "argmin", "nansum"}


def _numel(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else 0


def _first(x):
    return next((t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)),
                None)


def _int_pow(e: int) -> int:
    """The multiplies (and a divide for e < 0) of XLA's ``integer_pow``."""
    if e == 0:
        return 0
    m = abs(e)
    return (m.bit_length() - 1) + (bin(m).count("1") - 1) + (e < 0)


_SOFTMAX = {"_softmax", "_log_softmax"}


def _chain_flops(func, args, kwargs, out) -> float | None:
    """An elementwise op's own FLOPs an output element (a softmax's
    subtract and divide), or None for an op whose result XLA writes once: a
    matmul, a reduction, data movement, and a transcendental, which XLA's
    fusion does not duplicate."""
    name = func._overloadpacket.__name__
    if name in _SOFTMAX:
        return 2.0
    if name in _TRANSCENDENTAL:
        return None
    if name in _EW1 or name in _EW_FUSED or name in ("pow", "_to_copy"):
        n = _numel(_first(out))
        f, cls = xla_flops(func, args, kwargs, out)
        if name == "_to_copy" and not cls:
            return None                       # a copy, not a convert
        return f / n if n else 0.0
    return None


def xla_flops(func, args, kwargs, out) -> tuple[float, str]:
    """The FLOPs XLA's cost analysis charges the HLO an aten op without a
    ``flop_registry`` formula lowers to, and their class ("elementwise",
    "reduction" or "" for none)."""
    name = func._overloadpacket.__name__
    o, x = _first(out), _first(args)
    n, i = _numel(o), _numel(x)
    if name in _EW1:
        return float(n), "elementwise"
    if name in _EW_FUSED:
        return float(_EW_FUSED[name] * n), "elementwise"
    if name in ("_to_copy", "copy_"):
        src = args[1] if name == "copy_" else x
        same = isinstance(src, torch.Tensor) and o is not None and \
            src.dtype == o.dtype
        return (0.0, "") if same else (float(n), "elementwise")
    if name == "pow":
        e = args[1] if len(args) > 1 else kwargs.get("exponent")
        if isinstance(e, (int, float)) and float(e).is_integer() and \
                isinstance(x, torch.Tensor):
            return float(_int_pow(int(e)) * n), "elementwise"
        return 0.0, ""
    if name in _TRANSCENDENTAL:
        return 0.0, ""
    if name in _REDUCE:
        return float(max(i - n, 0)), "reduction"
    if name in ("mean", "nanmean"):
        return float(max(i - n, 0) + n), "reduction"
    if name in ("_softmax", "_log_softmax"):
        # max and sum reduce, subtract, divide (log: subtract the log-sum)
        rows = i // max(x.shape[args[1]] if x.dim() else 1, 1)
        return float(2 * (i - rows) + 2 * i), "reduction"
    if name in ("_softmax_backward_data", "_log_softmax_backward_data"):
        g = args[0]
        rows = i // max(g.shape[args[2]] if g.dim() else 1, 1)
        soft = name == "_softmax_backward_data"
        return float((i - rows) + (3 if soft else 2) * i), "reduction"
    if name == "logsumexp":
        return float(2 * (i - n) + i + n), "reduction"
    if name in ("cumsum", "cumprod"):
        return float(i), "reduction"
    if name in ("scatter_add", "scatter_add_", "index_add", "index_add_",
                "scatter_reduce", "scatter_reduce_"):
        src = args[3] if len(args) > 3 else kwargs.get("source",
                                                       kwargs.get("src"))
        return float(_numel(src)), "reduction"
    if name in ("index_put", "index_put_"):
        acc = args[3] if len(args) > 3 else kwargs.get("accumulate", False)
        return (float(_numel(args[2])), "reduction") if acc else (0.0, "")
    if name in ("sort", "argsort"):
        return float(i * max(math.ceil(math.log2(i)), 0) if i > 1 else 0), \
            "reduction"
    return 0.0, ""


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
    flops_by: dict = field(default_factory=dict)


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
                 local_out, mode.replicated, sites, mode.split, mode.flops_by)


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
                        "top_ops": dict(top), "flops_by": c.flops_by}}
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
            rec["count"] = {"kernels": c.kernels, "flops_by": c.flops_by,
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
