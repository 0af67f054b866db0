"""Roofline analysis of the port's dry run (``launch/dryrun.py``).

Three terms per (arch x shape x mesh), all in seconds, on the H100
constants of ``hw``:

    compute    = FLOPs / (peak bf16 FLOP/s)               [per device]
    memory     = bytes / HBM bandwidth                    [per device]
    collective = collective link bytes / NVLink link rate [per device]

The JAX package reads FLOPs and bytes from XLA's ``cost_analysis()`` of
the compiled per-device program and parses the collectives out of its
optimized HLO text.  The port compiles nothing: ``analyze`` reads the dry
run's own count of the per-device program (``Cost``: FLOPs from
``torch.utils.flop_counter``'s formulas, each op's input plus output bytes,
unfused, so an upper bound beside XLA's fused count, and each collective's
link bytes).  A partitioned count (DTensor on a fake process group,
``launch/partition.py``) is one device's program already; a single
controller's count of every mesh cell's program (favor-anns) is divided by
its ``programs``.  The collectives are charged where they are dispatched
(``ring_link_bytes``), by the ring formulas ``parse_collectives`` (pure
text, copied from the JAX package) applies to HLO text, per collective op:

    all-reduce      2 * (g-1)/g * bytes(operand)
    all-gather      (g-1)/g * bytes(result)
    reduce-scatter  (g-1)/g * bytes(operand)
    all-to-all      (g-1)/g * bytes(operand)
    collective-permute  bytes(operand)

with g the replica-group size (the op's process group's size).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

from . import hw

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

_SHAPE_RE = re.compile(r"(bf16|f64|f32|f16|f8e4m3fn|f8e5m2|s64|u64|s32|u32|"
                       r"s16|u16|s8|u8|pred|c64|c128)\[([0-9,]*)\]")
_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
        "collective-permute")
_GROUPS_RE = re.compile(r"replica_groups=(\{\{.*?\}\}|\[\d+,\d+\]<=\[\d+\])")


def _shape_bytes(text: str) -> int:
    """Sum byte sizes of every typed shape in a fragment (handles tuples)."""
    total = 0
    for m in _SHAPE_RE.finditer(text):
        dt, dims = m.group(1), m.group(2)
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _group_size(attr: str | None, default: int) -> int:
    if not attr:
        return default
    if attr.startswith("[{") or attr.startswith("{{"):
        first = attr.split("}")[0]
        return max(1, first.count(",") + 1)
    m = re.match(r"\[(\d+),(\d+)\]<=\[(\d+)\]", attr)
    if m:
        return int(m.group(2))
    return default


@dataclass
class CollectiveStats:
    counts: dict = field(default_factory=dict)
    link_bytes: float = 0.0
    raw_bytes: float = 0.0
    by_op: dict = field(default_factory=dict)


def parse_collectives(hlo_text: str, n_devices: int,
                      loop_multipliers: dict | None = None) -> CollectiveStats:
    """Scan optimized HLO for collectives; returns per-device link bytes.

    Optimized-HLO lines print only the RESULT shape inline, so link bytes are
    derived from the output:  all-reduce/all-to-all/permute outputs equal the
    operand, all-gather outputs are the gathered (g x) tensor, reduce-scatter
    outputs are the scattered (1/g) tensor.  Substring matching (no complex
    regex: HLO lines are megabytes and catastrophic backtracking is real).
    """
    st = CollectiveStats()
    for line in hlo_text.splitlines():
        op = None
        for cand in _OPS:
            i = line.find(" " + cand)
            if i >= 0:
                nxt = line[i + 1 + len(cand):]
                if nxt.startswith("(") or nxt.startswith("-start("):
                    op = cand
                    break
        if op is None:
            continue
        line = line.strip()
        lhs = line.split(" = ", 1)
        if len(lhs) != 2:
            continue
        # result may be a bare shape `f32[...] all-reduce(` or a TUPLE
        # `(f32[...], f32[...]) all-reduce(` -- take everything left of the op
        out_b = _shape_bytes(lhs[1].split(" " + op, 1)[0])
        if not out_b:
            continue
        gm = _GROUPS_RE.search(line)
        g = _group_size(gm.group(1) if gm else None, n_devices)
        if g <= 1:
            continue
        frac = (g - 1) / g
        if op == "all-reduce":
            link = 2.0 * frac * out_b
            raw = out_b
        elif op == "all-gather":
            link = frac * out_b           # operand = out/g; ring moves (g-1)/g out
            raw = out_b / g
        elif op == "reduce-scatter":
            link = (g - 1) * out_b        # operand = out*g
            raw = out_b * g
        elif op == "all-to-all":
            link = frac * out_b
            raw = out_b
        else:  # collective-permute
            link = float(out_b)
            raw = out_b
        st.counts[op] = st.counts.get(op, 0) + 1
        st.by_op[op] = st.by_op.get(op, 0.0) + link
        st.link_bytes += link
        st.raw_bytes += raw
    return st


def ring_link_bytes(kind: str, operand_bytes: float, g: int) -> float:
    """The link bytes one device moves for one collective of ``kind`` on
    an operand of ``operand_bytes`` over a group of ``g``: the ring
    formulas of ``parse_collectives``, written for the operand (an
    all-gather's result is g operands)."""
    if g <= 1:
        return 0.0
    frac = (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * frac * operand_bytes
    if kind == "all-gather":
        return frac * g * operand_bytes
    if kind in ("reduce-scatter", "all-to-all"):
        return frac * operand_bytes
    if kind == "collective-permute":
        return float(operand_bytes)
    raise ValueError(f"unknown collective {kind!r}")


@dataclass
class Cost:
    """The dry run's count of one step: FLOPs, bytes read and written by
    every op (views excluded), collective link bytes and the collectives
    ({"counts": {kind: n}, "by_op": {kind: link bytes}}) -- totals over the
    ``programs`` device programs the count ran (1 for a partitioned count
    or one block) -- and one device's argument, output and temporary
    bytes."""
    flops: float
    bytes_accessed: float
    argument_bytes: int
    output_bytes: int
    coll_link_bytes: float = 0.0
    collectives: dict = field(default_factory=lambda: {"counts": {},
                                                       "by_op": {}})
    temp_bytes: int | None = None


@dataclass
class Roofline:
    flops: float                # per-device flops
    hbm_bytes: float            # per-device bytes accessed
    coll_link_bytes: float      # per-device collective link bytes
    n_devices: int
    collectives: dict
    model_flops: float = 0.0    # 6ND (train) / 2ND (inference), GLOBAL

    @property
    def t_compute(self) -> float:
        return self.flops / hw.PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / hw.HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_link_bytes / hw.NVLINK_LINK_BW

    @property
    def bottleneck(self) -> str:
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    @property
    def useful_flops_frac(self) -> float:
        """MODEL_FLOPS / (per-device flops x devices)."""
        total = self.flops * self.n_devices
        return self.model_flops / total if total else 0.0

    @property
    def roofline_frac(self) -> float:
        """Fraction of the dominant-term bound that is useful model compute:
        (model_flops / devices / peak) / max(t_compute, t_memory, t_coll)."""
        t_bound = max(self.t_compute, self.t_memory, self.t_collective)
        if t_bound <= 0 or self.model_flops <= 0:
            return 0.0
        t_ideal = self.model_flops / self.n_devices / hw.PEAK_FLOPS_BF16
        return t_ideal / t_bound

    def to_dict(self) -> dict:
        return {
            "flops_per_dev": self.flops, "hbm_bytes_per_dev": self.hbm_bytes,
            "coll_link_bytes": self.coll_link_bytes,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_frac": self.useful_flops_frac,
            "roofline_frac": self.roofline_frac,
            "collectives": self.collectives,
        }


def analyze(cost: Cost, n_devices: int, model_flops: float = 0.0,
            programs: int = 1) -> Roofline:
    """The roofline of one step's ``Cost`` on ``n_devices``: the count's
    per-device terms as given, its totals divided by the ``programs`` it
    covers (a single controller's count of every mesh cell's program)."""
    coll = cost.collectives
    return Roofline(flops=cost.flops / programs,
                    hbm_bytes=cost.bytes_accessed / programs,
                    coll_link_bytes=cost.coll_link_bytes / programs,
                    n_devices=n_devices,
                    collectives={
                        "counts": {k: v / programs if v % programs else
                                   v // programs
                                   for k, v in coll["counts"].items()},
                        "by_op": {k: v / programs
                                  for k, v in coll["by_op"].items()}},
                    model_flops=model_flops)


def memory_analysis_dict(cost: Cost) -> dict:
    """``memory_analysis``' fields the count knows, per device: the
    arguments the step reads, its outputs and its temporaries (the peak
    live bytes beyond both)."""
    out = {"argument_size_in_bytes": cost.argument_bytes,
           "output_size_in_bytes": cost.output_bytes}
    if cost.temp_bytes is not None:
        out["temp_size_in_bytes"] = cost.temp_bytes
    return out
