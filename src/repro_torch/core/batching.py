"""Shape-stable sub-batch execution: bucket padding from router to kernels.

The selector (paper section 4.1) splits every serve batch into graph/brute
sub-batches whose sizes are data dependent.  This module pins every backend
entry point to a small, fixed set of power-of-two bucket shapes:

  BatchSpec      -- frozen policy: pow-2 bucket sizes between ``min_bucket``
                    and ``max_bucket`` plus the pad-row content policy.
                    Carried on ``SearchOptions.batch``; ``None`` disables
                    padding.
  pad_to_bucket  -- pad queries + stacked filter programs (+ optional p_hat)
                    up to the bucket size.  Pad rows carry an ALWAYS-FALSE
                    filter program (no disjunct live, infeasible intervals)
                    and a False entry in the returned validity mask, so they
                    match nothing and every backend/kernel drops them
                    without touching real rows -- results stay bit-identical
                    to the unpadded path.
  unpad          -- strip the pad rows off result arrays.
  ShapeRegistry  -- ledger of the distinct shapes that reached a backend
                    entry point and of the padding overhead paid.
  warmup         -- drive every (route, bucket) entry point once with an
                    all-pad batch.

The port's kernels are not specialised by shape, so a "compiled shape" here
is the (route, bucket, ``route_key(opts)``) triple that reached a backend
entry point; ``warmup`` builds the kernels at first use and warms the
caching allocator for each bucket.  Everything here is host-side policy:
the device-side contract is only the ``valid`` mask the backend's search
methods and the kernel wrappers accept.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import filters as F
from ..device import to_host

PAD_POLICIES = ("zero", "repeat")


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


@dataclass(frozen=True)
class BatchSpec:
    """Frozen bucket-padding policy for one options instance.

    min_bucket/max_bucket bound the pow-2 bucket set (both must themselves
    be powers of two); batches above ``max_bucket`` round up to a multiple
    of it.  ``pad_policy`` picks the pad *query* rows: "zero" rows (default)
    or "repeat" of the last real row -- pad *filter* rows are always the
    always-false program, so the choice never affects results.
    """
    min_bucket: int = 8
    max_bucket: int = 512
    pad_policy: str = "zero"

    def __post_init__(self):
        for name in ("min_bucket", "max_bucket"):
            v = getattr(self, name)
            if not _is_pow2(v):
                raise ValueError(f"BatchSpec.{name} must be a power of two "
                                 f">= 1, got {v}")
        if self.min_bucket > self.max_bucket:
            raise ValueError(f"BatchSpec.min_bucket ({self.min_bucket}) must "
                             f"be <= max_bucket ({self.max_bucket})")
        if self.pad_policy not in PAD_POLICIES:
            raise ValueError(f"BatchSpec.pad_policy must be one of "
                             f"{PAD_POLICIES}, got {self.pad_policy!r}")

    def buckets(self) -> tuple[int, ...]:
        """The full bucket ladder, min_bucket, 2*min_bucket, ..., max_bucket."""
        out = []
        b = self.min_bucket
        while b <= self.max_bucket:
            out.append(b)
            b *= 2
        return tuple(out)

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n (above max_bucket: next multiple of it)."""
        if n < 1:
            raise ValueError(f"bucket_for needs n >= 1, got {n}")
        for b in self.buckets():
            if n <= b:
                return b
        return -(-n // self.max_bucket) * self.max_bucket


def false_program_rows(programs: dict, pad: int) -> dict:
    """``pad`` always-false stacked program rows shaped like ``programs``.

    No disjunct is live (valid == 0) and the interval constraints are
    infeasible (flo=+inf > fhi=-inf), matching compile_filter's dead-row
    convention, so the rows match no DB row under any evaluator.  Any other
    key riding on the dict is zero-filled.
    """
    fills = {"flo": float("inf"), "fhi": float("-inf")}
    out = {}
    for k, v in programs.items():
        shape = (pad,) + tuple(v.shape[1:])
        fill = fills.get(k)
        out[k] = (torch.zeros(shape, dtype=v.dtype, device=v.device)
                  if fill is None else
                  torch.full(shape, fill, dtype=v.dtype, device=v.device))
    return out


def _cat_programs(programs: dict, pad: int) -> dict:
    rows = false_program_rows(programs, pad)
    return {k: torch.cat([v, rows[k]]) for k, v in programs.items()}


def pad_programs(spec: BatchSpec, programs: dict):
    """Pad a stacked program dict alone to its bucket.

    Returns ``(programs, valid)`` with ``valid`` a host (bucket,) bool mask
    that is True exactly on the original rows.
    """
    n = int(programs["valid"].shape[0])
    bucket = spec.bucket_for(n)
    valid = np.arange(bucket) < n
    if bucket == n:
        return programs, valid
    return _cat_programs(programs, bucket - n), valid


def pad_to_bucket(spec: BatchSpec, queries, programs: dict, p_hat=None):
    """Pad one sub-batch up to its bucket size.

    queries (n, d) and the stacked program dict gain ``bucket - n`` pad rows
    (always-false programs; query content per ``spec.pad_policy``); the
    optional per-query ``p_hat`` is zero-padded.  Returns
    ``(queries, programs, p_hat, valid)``; strip results with ``unpad``.
    """
    n = int(queries.shape[0])
    bucket = spec.bucket_for(n)
    valid = np.arange(bucket) < n
    if bucket == n:
        return queries, programs, p_hat, valid
    pad = bucket - n
    if spec.pad_policy == "repeat":
        qpad = queries[-1:].expand(pad, -1)
    else:
        qpad = queries.new_zeros((pad,) + tuple(queries.shape[1:]))
    queries = torch.cat([queries, qpad])
    programs = _cat_programs(programs, pad)
    if p_hat is not None:
        p_hat = np.concatenate([np.asarray(p_hat, np.float32),
                                np.zeros((pad,), np.float32)])
    return queries, programs, p_hat, valid


def unpad(n: int, *arrays):
    """Strip pad rows: slice every array back to its first ``n`` rows."""
    out = tuple(a[:n] for a in arrays)
    return out[0] if len(out) == 1 else out


# ---------------------------------------------------------------------------
# Shape accounting
# ---------------------------------------------------------------------------
def route_key(kind: str, opts) -> tuple:
    """The static identity of one backend entry point: shapes recorded under
    different keys run under different option sets."""
    if opts is None or kind == "estimate":
        return ()  # the estimate is SearchConfig-independent
    cfg = opts.search_config()
    if kind == "brute":
        return (cfg, opts.use_pq, opts.rerank)
    return (cfg,)


class ShapeRegistry:
    """Ledger of distinct (kind, batch-shape, static-config) triples that
    reached a backend entry point, plus the padding overhead paid.

    A new triple is a "compile event": the first call of that entry point at
    that bucket (kernel build and allocator warm-up at first use); repeat
    triples reuse them.
    """

    def __init__(self):
        self._shapes: dict[tuple, int] = {}
        self.compile_events = 0
        self.pad_rows = 0
        self.real_rows = 0

    def record(self, kind: str, size: int, real: int, opts=None) -> bool:
        """Note one backend call; True when its shape is new."""
        key = (kind, int(size)) + route_key(kind, opts)
        new = key not in self._shapes
        self._shapes[key] = self._shapes.get(key, 0) + 1
        if new:
            self.compile_events += 1
        self.pad_rows += int(size) - int(real)
        self.real_rows += int(real)
        return new

    @property
    def compiled_shapes(self) -> int:
        return len(self._shapes)

    def sizes_by_kind(self) -> dict[str, tuple[int, ...]]:
        """kind -> sorted distinct batch sizes seen."""
        out: dict[str, set] = {}
        for (kind, size, *_rest) in self._shapes:
            out.setdefault(kind, set()).add(size)
        return {k: tuple(sorted(v)) for k, v in out.items()}

    def reset_rows(self) -> None:
        """Zero the pad/real row counters (the shape set survives)."""
        self.pad_rows = 0
        self.real_rows = 0

    def stats(self) -> dict:
        total = self.pad_rows + self.real_rows
        return {
            "compiled_shapes": self.compiled_shapes,
            "compile_events": self.compile_events,
            "calls": sum(self._shapes.values()),
            "pad_rows": self.pad_rows,
            "real_rows": self.real_rows,
            "pad_overhead": self.pad_rows / total if total else 0.0,
            "sizes": self.sizes_by_kind(),
        }


def record(registry, kind: str, size: int, real: int, opts=None) -> None:
    """Registry-optional convenience used by router.execute / warmup."""
    if registry is not None:
        registry.record(kind, size, real, opts)


# ---------------------------------------------------------------------------
# Explicit warm-up
# ---------------------------------------------------------------------------
def warmup(backend, opts, *, buckets=None, registry=None) -> tuple[int, ...]:
    """Drive every (estimate / graph / brute, bucket) entry point now.

    All-pad batches -- zero queries, always-false programs, an all-False
    validity mask and p_hat = 0 -- reach exactly the entry points live
    traffic hits once ``opts.batch`` bucket-pads the sub-batches: the
    kernels are built at first use and the allocator holds each bucket's
    buffers.  Returns the bucket ladder warmed.  Graph lanes with a False
    mask never expand, so warm-up costs set-up, not search time.

    ``opts.batch`` must be set (unpadded traffic runs raw data-dependent
    shapes); routes excluded by ``opts.force`` are skipped.
    """
    if opts.batch is None:
        raise ValueError(
            "warmup() needs SearchOptions.batch set: unpadded traffic runs "
            "raw data-dependent shapes that never match the warmed "
            "buckets (pass batch=BatchSpec(...) on the options)")
    spec = opts.batch
    bucket_list = (spec.buckets() if buckets is None
                   else tuple(int(b) for b in buckets))
    dev = backend.device
    dim = int(backend.dim)
    fp = F.compile_filter(F.FalseFilter(), backend.schema)
    for b in bucket_list:
        queries = torch.zeros((b, dim), dtype=torch.float32, device=dev)
        stacked = F.stack_programs([fp] * b)
        stacked["imask"] = stacked["imask"].astype(np.int64)
        progs = {k: torch.as_tensor(v, device=dev) for k, v in stacked.items()}
        valid = np.zeros((b,), bool)
        record(registry, "estimate", b, 0)
        to_host(backend.estimate(progs, valid=valid))
        if opts.force != "brute":
            record(registry, "graph", b, 0, opts)
            out = backend.search_graph(queries, progs, np.zeros((b,),
                                                                np.float32),
                                       opts, valid=valid)
            to_host(out["ids"])
        if opts.force != "graph":
            record(registry, "brute", b, 0, opts)
            bid, _ = backend.search_brute(queries, progs, opts, valid=valid)
            to_host(bid)
    return bucket_list
