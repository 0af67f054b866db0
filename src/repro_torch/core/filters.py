"""Filter algebra and the DNF "filter program" compiler.

The paper (Section 2.1.2) supports four predicate families over scalar
attributes -- Equality, Inclusion, Range, Logic (AND/OR/NOT) -- and FAVOR is
*filter-agnostic*: any predicate must be evaluable during search without
touching the index structure.

Predicates are compiled once per query into a dense **filter program** -- a
fixed-width disjunctive normal form whose conjunctions are (per-int-column
bitmask, per-float-column interval) tests.  Evaluation is branch-free tensor
arithmetic, so it runs as torch ops on any device and inside the CUDA kernels
(``repro_torch/csrc``), batched over queries, with the predicate as *data*
rather than *code*.  The compiler, signatures and attribute table are numpy on
the host; the three evaluators take torch tensors.

Columns:
  * ``bool`` / ``int`` columns: small ordinal vocabulary (< 32); conjunction
    constraint is an allowed-value bitmask (uint32).  Equality -> one bit,
    Inclusion -> several bits, Range -> a run of bits, NOT -> complement.
  * ``float`` columns: conjunction constraint is a closed interval
    ``[lo, hi]``; NOT(Range) splits into two disjuncts with nextafter-strict
    bounds.

The compiler lowers the AST to negation normal form and distributes AND over
OR to DNF, erroring out above ``max_width`` (default 8) rather than silently
truncating.
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

INT_KINDS = ("bool", "int")
MAX_INT_VOCAB = 32


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ColumnSpec:
    name: str
    kind: str  # "bool" | "int" | "float"
    vocab: int | None = None  # required for int; bool -> 2

    def __post_init__(self):
        if self.kind not in ("bool", "int", "float"):
            raise ValueError(f"unknown column kind {self.kind!r}")
        if self.kind == "bool":
            object.__setattr__(self, "vocab", 2)
        if self.kind == "int":
            if self.vocab is None:
                raise ValueError(f"int column {self.name!r} needs a vocab size")
            if self.vocab > MAX_INT_VOCAB:
                raise ValueError(
                    f"int column {self.name!r} vocab {self.vocab} > {MAX_INT_VOCAB}; "
                    "declare it as a float (ordered) column instead"
                )


@dataclass(frozen=True)
class Schema:
    columns: tuple[ColumnSpec, ...]

    def __post_init__(self):
        names = [c.name for c in self.columns]
        if len(set(names)) != len(names):
            raise ValueError("duplicate column names")

    @property
    def int_columns(self) -> tuple[ColumnSpec, ...]:
        return tuple(c for c in self.columns if c.kind in INT_KINDS)

    @property
    def float_columns(self) -> tuple[ColumnSpec, ...]:
        return tuple(c for c in self.columns if c.kind == "float")

    def int_index(self, name: str) -> int:
        for i, c in enumerate(self.int_columns):
            if c.name == name:
                return i
        raise KeyError(name)

    def float_index(self, name: str) -> int:
        for i, c in enumerate(self.float_columns):
            if c.name == name:
                return i
        raise KeyError(name)

    def column(self, name: str) -> ColumnSpec:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(name)


# Paper section 6.1.2: every vector carries one bool, one int in U{0..9} and one
# float in U[0,100].
def paper_schema(n_bool: int = 1, n_int: int = 1, n_float: int = 1,
                 int_vocab: int = 10) -> Schema:
    cols: list[ColumnSpec] = []
    for i in range(n_bool):
        cols.append(ColumnSpec(f"b{i}", "bool"))
    for i in range(n_int):
        cols.append(ColumnSpec(f"i{i}", "int", int_vocab))
    for i in range(n_float):
        cols.append(ColumnSpec(f"f{i}", "float"))
    return Schema(tuple(cols))


# ---------------------------------------------------------------------------
# Filter AST
# ---------------------------------------------------------------------------
class Filter:
    def __and__(self, other: "Filter") -> "Filter":
        return And(self, other)

    def __or__(self, other: "Filter") -> "Filter":
        return Or(self, other)

    def __invert__(self) -> "Filter":
        return Not(self)


@dataclass(frozen=True)
class TrueFilter(Filter):
    pass


@dataclass(frozen=True)
class FalseFilter(Filter):
    pass


@dataclass(frozen=True)
class Equality(Filter):
    column: str
    value: float | int | bool


@dataclass(frozen=True)
class Inclusion(Filter):
    column: str
    values: tuple

    def __init__(self, column: str, values: Sequence):
        object.__setattr__(self, "column", column)
        object.__setattr__(self, "values", tuple(values))


@dataclass(frozen=True)
class Range(Filter):
    """Closed interval lo <= a <= hi (either bound may be None = unbounded)."""

    column: str
    lo: float | None = None
    hi: float | None = None


@dataclass(frozen=True)
class And(Filter):
    children: tuple

    def __init__(self, *children: Filter):
        object.__setattr__(self, "children", tuple(children))


@dataclass(frozen=True)
class Or(Filter):
    children: tuple

    def __init__(self, *children: Filter):
        object.__setattr__(self, "children", tuple(children))


@dataclass(frozen=True)
class Not(Filter):
    child: Filter


# ---------------------------------------------------------------------------
# Conjunction representation used during compilation
# ---------------------------------------------------------------------------
@dataclass
class _Conj:
    imask: np.ndarray  # (m_i,) uint32 allowed-value bitmasks
    flo: np.ndarray  # (m_f,) float32
    fhi: np.ndarray  # (m_f,) float32

    def copy(self) -> "_Conj":
        return _Conj(self.imask.copy(), self.flo.copy(), self.fhi.copy())

    def feasible(self) -> bool:
        return bool(np.all(self.imask != 0) and np.all(self.flo <= self.fhi))


def _full_conj(schema: Schema) -> _Conj:
    m_i = len(schema.int_columns)
    m_f = len(schema.float_columns)
    imask = np.zeros((m_i,), np.uint32)
    for j, c in enumerate(schema.int_columns):
        imask[j] = np.uint32((1 << c.vocab) - 1)
    flo = np.full((m_f,), -np.inf, np.float32)
    fhi = np.full((m_f,), np.inf, np.float32)
    return _Conj(imask, flo, fhi)


def _int_bits(values: Sequence[int], vocab: int, column: str) -> np.uint32:
    mask = np.uint32(0)
    for v in values:
        v = int(v)
        if not (0 <= v < vocab):
            raise ValueError(f"value {v} out of vocab [0,{vocab}) for column {column!r}")
        mask |= np.uint32(1) << np.uint32(v)
    return mask


def _strict_below(x: float) -> float:
    return float(np.nextafter(np.float32(x), np.float32(-np.inf)))


def _strict_above(x: float) -> float:
    return float(np.nextafter(np.float32(x), np.float32(np.inf)))


def _leaf_conjs(f: Filter, schema: Schema, negated: bool) -> list[_Conj]:
    """Compile a (possibly negated) leaf to a list of conjunctions (a DNF)."""
    if isinstance(f, TrueFilter):
        return [] if negated else [_full_conj(schema)]
    if isinstance(f, FalseFilter):
        return [_full_conj(schema)] if negated else []

    if isinstance(f, Equality):
        col = schema.column(f.column)
        if col.kind in INT_KINDS:
            j = schema.int_index(f.column)
            bits = _int_bits([int(f.value)], col.vocab, f.column)
            c = _full_conj(schema)
            c.imask[j] = ~bits & c.imask[j] if negated else bits
            return [c]
        j = schema.float_index(f.column)
        v = float(f.value)
        if not negated:
            c = _full_conj(schema)
            c.flo[j], c.fhi[j] = v, v
            return [c]
        lo_c, hi_c = _full_conj(schema), _full_conj(schema)
        lo_c.fhi[j] = _strict_below(v)
        hi_c.flo[j] = _strict_above(v)
        return [lo_c, hi_c]

    if isinstance(f, Inclusion):
        col = schema.column(f.column)
        if col.kind not in INT_KINDS:
            # float inclusion == OR of equalities
            dnf: list[_Conj] = []
            for v in f.values:
                dnf.extend(_leaf_conjs(Equality(f.column, v), schema, False))
            if negated:
                raise ValueError("NOT(Inclusion) on float columns is not supported; "
                                 "use Range complements")
            return dnf
        j = schema.int_index(f.column)
        bits = _int_bits(f.values, col.vocab, f.column)
        c = _full_conj(schema)
        full = c.imask[j]
        c.imask[j] = (~bits & full) if negated else bits
        return [c]

    if isinstance(f, Range):
        col = schema.column(f.column)
        lo = -math.inf if f.lo is None else float(f.lo)
        hi = math.inf if f.hi is None else float(f.hi)
        if col.kind in INT_KINDS:
            j = schema.int_index(f.column)
            vals = [v for v in range(col.vocab) if lo <= v <= hi]
            bits = _int_bits(vals, col.vocab, f.column)
            c = _full_conj(schema)
            full = c.imask[j]
            c.imask[j] = (~bits & full) if negated else bits
            return [c]
        j = schema.float_index(f.column)
        if not negated:
            c = _full_conj(schema)
            c.flo[j], c.fhi[j] = lo, hi
            return [c]
        out = []
        if lo > -math.inf:
            c = _full_conj(schema)
            c.fhi[j] = _strict_below(lo)
            out.append(c)
        if hi < math.inf:
            c = _full_conj(schema)
            c.flo[j] = _strict_above(hi)
            out.append(c)
        return out

    raise TypeError(f"not a leaf filter: {f!r}")


def _conj_and(a: _Conj, b: _Conj) -> _Conj:
    return _Conj(a.imask & b.imask, np.maximum(a.flo, b.flo), np.minimum(a.fhi, b.fhi))


def _to_dnf(f: Filter, schema: Schema, negated: bool, max_width: int) -> list[_Conj]:
    if isinstance(f, Not):
        return _to_dnf(f.child, schema, not negated, max_width)
    if isinstance(f, And) or isinstance(f, Or):
        is_and = isinstance(f, And) != negated  # de Morgan
        child_dnfs = [_to_dnf(c, schema, negated, max_width) for c in f.children]
        if not is_and:
            out = [c for d in child_dnfs for c in d]
        else:
            out = [_full_conj(schema)]
            for d in child_dnfs:
                out = [_conj_and(a, b) for a in out for b in d]
                out = [c for c in out if c.feasible()]
                if len(out) > 4 * max_width:
                    raise ValueError(
                        f"filter DNF exceeds width {max_width}; simplify the predicate")
        out = [c for c in out if c.feasible()]
        if len(out) > 4 * max_width:
            raise ValueError(f"filter DNF exceeds width {max_width}")
        return out
    return [c for c in _leaf_conjs(f, schema, negated) if c.feasible()]


# ---------------------------------------------------------------------------
# Compiled program
# ---------------------------------------------------------------------------
@dataclass
class FilterProgram:
    """Fixed-width DNF as dense numpy arrays (one query).

    valid : (W,)  float32 in {0,1} -- disjunct is live
    imask : (W, m_i) uint32        -- per-int-column allowed-value bitmask
    flo   : (W, m_f) float32       -- per-float-column interval low
    fhi   : (W, m_f) float32       -- per-float-column interval high
    """

    valid: np.ndarray
    imask: np.ndarray
    flo: np.ndarray
    fhi: np.ndarray

    @property
    def width(self) -> int:
        return int(self.valid.shape[0])


def compile_filter(f: Filter, schema: Schema, width: int = 8) -> FilterProgram:
    conjs = _to_dnf(f, schema, False, max_width=width)
    if len(conjs) > width:
        raise ValueError(f"filter needs DNF width {len(conjs)} > {width}")
    m_i = len(schema.int_columns)
    m_f = len(schema.float_columns)
    valid = np.zeros((width,), np.float32)
    imask = np.zeros((width, m_i), np.uint32)
    flo = np.full((width, m_f), np.inf, np.float32)   # infeasible padding
    fhi = np.full((width, m_f), -np.inf, np.float32)
    for w, c in enumerate(conjs):
        valid[w] = 1.0
        imask[w] = c.imask
        flo[w] = c.flo
        fhi[w] = c.fhi
    return FilterProgram(valid, imask, flo, fhi)


# ---------------------------------------------------------------------------
# Canonical signatures (serving-side cache keys)
#
# Two predicates that compile to the same *set* of DNF conjunctions are
# semantically identical, whatever the AST looked like: the compiler already
# normalizes double negation (NNF) and associativity/commutativity of AND is
# elementwise (bitmask-&, interval-intersect), so only the disjunct *order*
# and duplicate/subsumed disjuncts distinguish equivalent programs.  The
# canonical form therefore drops dead rows, drops rows subsumed by another
# row, sorts the survivors bytewise and hashes them -- a stable 128-bit key
# that every cache layer (selectivity, candidate, semantic) can share.
# Signature equality is *sound* (equal signature => equal predicate on every
# row); it is deliberately not complete (e.g. two overlapping ranges that
# union to a third are not merged).
# ---------------------------------------------------------------------------
SIGNATURE_VERSION = 1  # bump when the canonical byte layout changes


def _canon_rows(valid, imask, flo, fhi) -> list[bytes]:
    """Canonical serialized conjunctions of one program (see module note).

    Runs once per query per cache operation on the serving hot path, so the
    subsumption test is vectorized over all W^2 row pairs instead of a
    Python pair loop.
    """
    valid = np.asarray(valid)
    imask = np.asarray(imask, np.uint32)
    # -0.0 normalization: -0.0 and 0.0 compare equal but serialize
    # differently; force the canonical zero before taking bytes
    flo = np.asarray(flo, np.float32) + 0.0
    fhi = np.asarray(fhi, np.float32) + 0.0
    live = np.nonzero(valid > 0)[0]
    if live.size == 0:
        return []
    im, lo, hi = imask[live], flo[live], fhi[live]
    # cover[v, w] -- row v covers row w: superset bitmask on every int
    # column AND containing interval on every float column; mutual cover is
    # row identity, strict cover marks w subsumed (Or(a, a), Or(a, And(a,b)))
    cover = np.ones((live.size, live.size), bool)
    if im.shape[1]:
        cover &= ((im[:, None, :] & im[None, :, :]) == im[None, :, :]).all(-1)
    if lo.shape[1]:
        cover &= (lo[:, None, :] <= lo[None, :, :]).all(-1)
        cover &= (hi[:, None, :] >= hi[None, :, :]).all(-1)
    strict = cover & ~cover.T     # covers w without being covered back
    keep = ~strict.any(axis=0)
    rows = {im[w].tobytes() + lo[w].tobytes() + hi[w].tobytes()
            for w in np.nonzero(keep)[0]}
    return sorted(rows)


def program_signature(program) -> str:
    """Stable hex signature of one program's canonical DNF.

    ``program`` is a FilterProgram or a dict with 1-query arrays
    (valid (W,), imask (W, m_i), flo/fhi (W, m_f)).
    """
    if isinstance(program, FilterProgram):
        valid, imask = program.valid, program.imask
        flo, fhi = program.flo, program.fhi
    else:
        valid, imask = program["valid"], program["imask"]
        flo, fhi = program["flo"], program["fhi"]
    h = hashlib.blake2b(digest_size=16)
    m_i = int(np.asarray(imask).shape[-1])
    m_f = int(np.asarray(flo).shape[-1])
    h.update(f"favor-sig-v{SIGNATURE_VERSION}:{m_i}:{m_f}".encode())
    for row in _canon_rows(valid, imask, flo, fhi):
        h.update(b"|")
        h.update(row)
    return h.hexdigest()


def filter_signature(f: Filter, schema: Schema, width: int = 8) -> str:
    """Canonical signature of a filter AST: semantically equivalent
    reorderings (commuted AND/OR children, double negation, duplicate
    disjuncts) hash identically, so cache entries are shared across them."""
    return program_signature(compile_filter(f, schema, width))


def batch_signatures(programs: dict) -> list[str]:
    """Per-query signatures of a stacked (B, W, ...) program dict."""
    valid = np.asarray(programs["valid"])
    imask = np.asarray(programs["imask"])
    flo = np.asarray(programs["flo"])
    fhi = np.asarray(programs["fhi"])
    return [program_signature({"valid": valid[b], "imask": imask[b],
                               "flo": flo[b], "fhi": fhi[b]})
            for b in range(valid.shape[0])]


def stack_programs(programs: Sequence[FilterProgram]) -> dict[str, np.ndarray]:
    """Stack per-query programs into batched arrays (B, ...)."""
    width = max(p.width for p in programs)

    def pad(p: FilterProgram) -> FilterProgram:
        if p.width == width:
            return p
        pw = width - p.width
        return FilterProgram(
            np.pad(p.valid, (0, pw)),
            np.pad(p.imask, ((0, pw), (0, 0))),
            np.pad(p.flo, ((0, pw), (0, 0)), constant_values=np.inf),
            np.pad(p.fhi, ((0, pw), (0, 0)), constant_values=-np.inf),
        )

    ps = [pad(p) for p in programs]
    return {
        "valid": np.stack([p.valid for p in ps]),
        "imask": np.stack([p.imask for p in ps]),
        "flo": np.stack([p.flo for p in ps]),
        "fhi": np.stack([p.fhi for p in ps]),
    }


# ---------------------------------------------------------------------------
# Evaluation (torch tensors; numpy inputs are converted)
#
# Bit tests run in int64: ``imask`` holds uint32 bitmasks, which torch's
# int32 cannot carry, and a shift amount outside [0, 32) -- the -1 ints of
# pad rows -- must give bit 0, as the uint32 shift of the numpy/XLA
# evaluators does; torch leaves such shifts undefined, so they are gated.
# ---------------------------------------------------------------------------
def _as_tensor(x, device=None):
    if isinstance(x, torch.Tensor):
        return x
    x = np.asarray(x)
    if x.dtype == np.uint32:
        x = x.astype(np.int64)
    return torch.as_tensor(x, device=device)


def _program_tensors(program, device=None):
    if isinstance(program, FilterProgram):
        program = {"valid": program.valid, "imask": program.imask,
                   "flo": program.flo, "fhi": program.fhi}
    return tuple(_as_tensor(program[k], device)
                 for k in ("valid", "imask", "flo", "fhi"))


def _bit_test(imask, ints):
    """imask (..., m_i) bitmasks, ints broadcastable (..., m_i) values ->
    bool (...,): every column's value bit is set."""
    sh = ints.to(torch.int64)
    inb = (sh >= 0) & (sh < 32)
    bit = (imask.to(torch.int64) >> sh.clamp(0, 31)) & 1
    return ((bit == 1) & inb).all(dim=-1)


def eval_program(program, attrs_int, attrs_float):
    """Evaluate one filter program over attribute rows.

    program     : dict/FilterProgram with valid (W,), imask (W,m_i),
                  flo/fhi (W,m_f)
    attrs_int   : (N, m_i) int32   (bool columns stored as 0/1)
    attrs_float : (N, m_f) float32
    returns     : (N,) bool tensor
    """
    attrs_int = _as_tensor(attrs_int)
    attrs_float = _as_tensor(attrs_float, attrs_int.device)
    valid, imask, flo, fhi = _program_tensors(program, attrs_int.device)

    ok = (valid[:, None] > 0).expand(valid.shape[0], attrs_int.shape[0])
    if imask.shape[-1]:
        ok = ok & _bit_test(imask[:, None, :], attrs_int[None, :, :])
    if flo.shape[-1]:
        af = attrs_float[None, :, :]
        fok = (af >= flo[:, None, :]) & (af <= fhi[:, None, :])
        ok = ok & fok.all(dim=-1)
    return ok.any(dim=0)


def eval_program_batched(programs, attrs_int, attrs_float):
    """Batched programs (B, W, ...) over rows -> (B, N) bool mask."""
    valid, imask, flo, fhi = (programs[k] for k in
                              ("valid", "imask", "flo", "fhi"))
    b, w = valid.shape
    ok = (valid[:, :, None] > 0).expand(b, w, attrs_int.shape[0])
    if imask.shape[-1]:
        ok = ok & _bit_test(imask[:, :, None, :], attrs_int[None, None, :, :])
    if flo.shape[-1]:
        af = attrs_float[None, None, :, :]
        fok = (af >= flo[:, :, None, :]) & (af <= fhi[:, :, None, :])
        ok = ok & fok.all(dim=-1)
    return ok.any(dim=1)  # (B, N)


def eval_program_gathered(programs, ints, floats):
    """Batched programs over per-query gathered rows.

    programs : dict with valid (B, W), imask (B, W, m_i), flo/fhi (B, W, m_f)
    ints     : (B, M, m_i) -- M rows gathered *per query* (graph neighbors)
    floats   : (B, M, m_f)
    returns  : (B, M) bool mask
    """
    valid, imask, flo, fhi = (programs[k] for k in
                              ("valid", "imask", "flo", "fhi"))
    b, w = valid.shape
    ok = (valid[:, :, None] > 0).expand(b, w, ints.shape[1])
    if imask.shape[-1]:
        ok = ok & _bit_test(imask[:, :, None, :], ints[:, None, :, :])
    if flo.shape[-1]:
        af = floats[:, None, :, :]
        fok = (af >= flo[:, :, None, :]) & (af <= fhi[:, :, None, :])
        ok = ok & fok.all(dim=-1)
    return ok.any(dim=1)  # (B, M)


def eval_filter_python(f: Filter, row: dict) -> bool:
    """Direct AST interpreter over one attribute row (property-test oracle)."""
    if isinstance(f, TrueFilter):
        return True
    if isinstance(f, FalseFilter):
        return False
    if isinstance(f, Equality):
        return row[f.column] == f.value
    if isinstance(f, Inclusion):
        return row[f.column] in f.values
    if isinstance(f, Range):
        lo = -math.inf if f.lo is None else f.lo
        hi = math.inf if f.hi is None else f.hi
        return lo <= row[f.column] <= hi
    if isinstance(f, And):
        return all(eval_filter_python(c, row) for c in f.children)
    if isinstance(f, Or):
        return any(eval_filter_python(c, row) for c in f.children)
    if isinstance(f, Not):
        return not eval_filter_python(f.child, row)
    raise TypeError(f"unknown filter {f!r}")


# ---------------------------------------------------------------------------
# Attribute table
# ---------------------------------------------------------------------------
@dataclass
class AttributeTable:
    schema: Schema
    ints: np.ndarray    # (N, m_i) int32
    floats: np.ndarray  # (N, m_f) float32

    def __post_init__(self):
        assert self.ints.ndim == 2 and self.floats.ndim == 2
        assert self.ints.shape[1] == len(self.schema.int_columns)
        assert self.floats.shape[1] == len(self.schema.float_columns)
        assert self.ints.shape[0] == self.floats.shape[0]

    @property
    def n(self) -> int:
        return int(self.ints.shape[0])

    def row(self, i: int) -> dict:
        out = {}
        for j, c in enumerate(self.schema.int_columns):
            v = int(self.ints[i, j])
            out[c.name] = bool(v) if c.kind == "bool" else v
        for j, c in enumerate(self.schema.float_columns):
            out[c.name] = float(self.floats[i, j])
        return out

    def take(self, idx: np.ndarray) -> "AttributeTable":
        return AttributeTable(self.schema, self.ints[idx], self.floats[idx])


def random_attributes(schema: Schema, n: int, seed: int = 0) -> AttributeTable:
    """Paper section 6.1.2 attribute generation: bool equiprobable, int uniform
    over the vocab, float uniform over [0, 100]."""
    rng = np.random.default_rng(seed)
    ints = np.zeros((n, len(schema.int_columns)), np.int32)
    for j, c in enumerate(schema.int_columns):
        ints[:, j] = rng.integers(0, c.vocab, size=n, dtype=np.int32)
    floats = rng.uniform(0.0, 100.0, size=(n, len(schema.float_columns))).astype(np.float32)
    return AttributeTable(schema, ints, floats)


# Paper section 6.1.1 canonical experiment filters ---------------------------
def paper_filters(schema: Schema, rng: np.random.Generator | None = None) -> dict[str, Filter]:
    """The six filtering scenarios of section 6.1.1 (selectivities in parens)."""
    rng = rng or np.random.default_rng(0)
    bcol = schema.int_columns[0].name            # bool col (b0)
    icol = [c for c in schema.int_columns if c.kind == "int"][0].name
    fcol = schema.float_columns[0].name
    eq_bool = Equality(bcol, True)               # 50%
    eq_int = Equality(icol, int(rng.integers(0, 10)))  # 10%
    inclusion = Inclusion(icol, sorted(rng.choice(10, size=3, replace=False).tolist()))  # 30%
    lo10 = float(rng.uniform(0, 90))
    range10 = Range(fcol, lo10, lo10 + 10.0)     # 10%
    lo50 = float(rng.uniform(0, 50))
    range50 = Range(fcol, lo50, lo50 + 50.0)     # 50%
    logic = And(eq_int, range50)                 # ~5%
    return {
        "equality_bool": eq_bool,
        "equality_int": eq_int,
        "inclusion": inclusion,
        "range_10": range10,
        "range_50": range50,
        "logic": logic,
    }
