"""Port parity, host modules: the DNF compiler, the torch filter evaluators,
the HNSW build, the exclusion distance and the selectivity estimate must be
bit-identical to the JAX package on the same numpy inputs."""
from dataclasses import dataclass, fields
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import exclusion as r_excl  # noqa: E402
from repro.core import filters as RF  # noqa: E402
from repro.core import hnsw as r_hnsw  # noqa: E402
from repro.core import selector as r_sel  # noqa: E402
from repro_torch.core import exclusion as p_excl  # noqa: E402
from repro_torch.core import filters as PF  # noqa: E402
from repro_torch.core import hnsw as p_hnsw  # noqa: E402
from repro_torch.core import selector as p_sel  # noqa: E402
from repro_torch.core.router import compile_programs  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the other
    test workers on the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _filters(F):
    """The six paper filters plus And/Or/Not/True/False cases, built from
    either package's AST classes."""
    out = dict(F.paper_filters(F.paper_schema()))
    out.update({
        "not_range": F.Not(F.Range("f0", 30.0, 80.0)),
        "or_mixed": F.Or(F.Equality("b0", False), F.Inclusion("i0", [1, 5, 9])),
        "and_or": F.And(F.Or(F.Equality("i0", 2), F.Equality("i0", 7)),
                        F.Range("f0", None, 50.0)),
        "not_and": F.Not(F.And(F.Equality("b0", True), F.Range("f0", 10, 12))),
        "float_eq": F.Equality("f0", 42.0),
        "not_float_eq": F.Not(F.Equality("f0", 42.0)),
        "int_range": F.Range("i0", 2, 6),
        "tiny": F.And(F.Equality("i0", 3), F.Range("f0", 10, 12)),
        "true": F.TrueFilter(),
        "false": F.FalseFilter(),
    })
    return out


NAMES = sorted(_filters(RF))


@pytest.mark.parametrize("name", NAMES)
def test_compile_filter_identical(name):
    rf, pf = _filters(RF)[name], _filters(PF)[name]
    rp = RF.compile_filter(rf, RF.paper_schema())
    pp = PF.compile_filter(pf, PF.paper_schema())
    for key in ("valid", "imask", "flo", "fhi"):
        a, b = getattr(rp, key), getattr(pp, key)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (RF.program_signature(rp) == PF.program_signature(pp))


def test_stack_programs_and_signatures_identical():
    rs = RF.stack_programs([RF.compile_filter(f, RF.paper_schema(), 8)
                            for f in _filters(RF).values()])
    ps = PF.stack_programs([PF.compile_filter(f, PF.paper_schema(), 8)
                            for f in _filters(PF).values()])
    for key in rs:
        np.testing.assert_array_equal(rs[key], ps[key])
    assert RF.batch_signatures(rs) == PF.batch_signatures(ps)


# ---------------------------------------------------------------------------
# compile_stacked / compile_programs: byte for byte the reference's
# stack_programs([compile_filter(...)]), and the same errors
# ---------------------------------------------------------------------------
_COLS = (("b0", "bool", 2), ("i0", "int", 10), ("i1", "int", 32),
         ("f0", "float", None), ("f1", "float", None))
# real bounds: signed zeros, subnormals that round to 0 / the least
# subnormal, float32's largest, beyond its range, infinities and NaN
_REALS = (0.0, -0.0, 1.5, 42.0, 42.00000001, -7.25, 1e-46, -1e-46, 7e-46,
          3.4028235e38, 1e39, -1e39, np.inf, -np.inf, np.nan)


def _schema(F):
    return F.Schema(tuple(F.ColumnSpec(*c) for c in _COLS))


@dataclass(frozen=True)
class _Opaque:
    """Not a filter of either package: both compilers refuse it."""
    name: str = "opaque"


def _build(F, spec):
    """A filter of package ``F`` from a nested tuple spec."""
    if isinstance(spec, _Opaque):
        return spec
    op, *args = spec
    if op in ("And", "Or"):
        return getattr(F, op)(*(_build(F, a) for a in args))
    if op == "Not":
        return F.Not(_build(F, args[0]))
    return getattr(F, op)(*args)


def _leaf_spec(rng):
    name, kind, vocab = _COLS[rng.integers(len(_COLS))]
    reals = lambda: _REALS[rng.integers(len(_REALS))]  # noqa: E731
    if kind == "float":
        value = reals() if rng.random() < 0.5 else float(rng.uniform(-5, 105))
    else:   # an int (or a bool, or a real that int() truncates) in vocab
        value = (int(rng.integers(vocab)) if rng.random() < 0.8
                 else [True, False, 2.9][rng.integers(3)])
    bound = lambda: (None if rng.random() < 0.2 else  # noqa: E731
                     reals() if rng.random() < 0.4 else
                     float(rng.uniform(-5, 105 if kind == "float" else vocab)))
    leaf = rng.integers(5)
    if leaf == 0:
        return ("Equality", name, value)
    if leaf == 1:
        n = int(rng.integers(1, 4))
        vals = ([reals() for _ in range(n)] if kind == "float" else
                sorted(rng.choice(vocab, size=min(n, vocab), replace=False).tolist()))
        return ("Inclusion", name, vals)
    if leaf == 2:
        return ("Range", name, bound(), bound())
    return (("TrueFilter",), ("FalseFilter",))[leaf - 3]


def _tree_spec(rng, depth):
    if depth == 0 or rng.random() < 0.3:
        leaf = _leaf_spec(rng)
        return ("Not", leaf) if rng.random() < 0.4 else leaf
    op = ("And", "Or", "Not")[rng.integers(3)]
    if op == "Not":
        return ("Not", _tree_spec(rng, depth - 1))
    return (op,) + tuple(_tree_spec(rng, depth - 1)
                         for _ in range(int(rng.integers(1, 4))))


def _corpus():
    """Every leaf kind on every column kind, plain and negated, then
    seeded And / Or / Not trees over them."""
    rng = np.random.default_rng(30)
    specs = []
    for name, kind, vocab in _COLS:
        vals = list(_REALS) if kind == "float" else [0, vocab - 1, True]
        for v in vals:
            specs.append(("Equality", name, v))
        specs.append(("Inclusion", name, vals[:3]))
        for lo in (None,) + _REALS:
            for hi in (None, 5.0, np.inf, 1e39, np.nan, -0.0):
                specs.append(("Range", name, lo, hi))
    specs += [("Not", s) for s in specs]
    # an AND's bounds meeting at -0.0 and 0.0, in both orders
    for z1, z2 in ((-0.0, 0.0), (0.0, -0.0)):
        specs += [("And", ("Range", "f0", z1, 5.0), ("Range", "f0", z2, 5.0)),
                  ("And", ("Range", "f1", -5.0, z1), ("Range", "f1", -5.0, z2)),
                  ("And", ("Equality", "f0", z1), ("Range", "f0", z2, z2))]
    specs += [_tree_spec(rng, 3) for _ in range(400)]
    return specs


_WIDE = ("Or",) + tuple(("Equality", "f0", float(v)) for v in range(9))
_ERRORS = {
    "out_of_vocab": [("Equality", "i0", 10), ("Equality", "i0", -1),
                     ("Inclusion", "i0", [3, 12]), ("Equality", "b0", 2),
                     ("Equality", "i0", np.nan), ("Equality", "zz", 1)],
    "dnf_wider_than_width": [_WIDE,
                             ("Or",) + (_WIDE,) * 4,  # 36 > 4 * 8
                             ("Not", ("And",) + tuple(
                                 ("Not", s) for s in _WIDE[1:]))],
    "and_step_above_4w": [("And", _WIDE[:6], ("Or",) + tuple(
        ("Equality", "f1", float(v)) for v in range(7)))],   # 35 > 32
    "not_float_inclusion": [("Not", ("Inclusion", "f0", [1.0, 2.0])),
                            ("Not", ("Inclusion", "f1", [np.nan]))],
    "unknown_leaf": [_Opaque(), ("And", ("Equality", "i0", 1), _Opaque())],
}


def _mix_specs(mix):
    from portbench import traffic
    from portbench.program import to_filter
    tr = traffic.load(Path(__file__).parents[1] / "portbench" / "traffic"
                      / f"{mix}.json")
    specs, _ = traffic.draw_batch(tr, 1000, np.random.default_rng(2**31 + 30))
    # the program's own filters, rebuilt as nested tuple specs
    def spec(f):
        name = type(f).__name__
        if name in ("And", "Or"):
            return (name,) + tuple(spec(c) for c in f.children)
        if name == "Not":
            return (name, spec(f.child))
        return (name,) + tuple(getattr(f, k.name) for k in fields(f))
    return [spec(to_filter(s)) for s in specs]


def _outcome(fn):
    try:
        with np.errstate(over="ignore", invalid="ignore"):
            return fn()
    except Exception as e:  # noqa: BLE001 -- the outcome under test
        return (type(e), str(e))


def _same_bytes(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].view(np.uint8).tobytes() == want[k].view(np.uint8).tobytes(), k


CASES = ([f"corpus.w{w}" for w in (1, 4, 8)]
         + ["lowsel.b1000", "paper-graph.b10000"] + sorted(_ERRORS))


@pytest.mark.parametrize("case", CASES)
def test_compile_stacked_identical(case):
    """The port's compile_stacked and router.compile_programs give the
    reference's stacked programs byte for byte, and each filter the
    reference refuses raises the same exception and message."""
    rs, ps = _schema(RF), _schema(PF)
    width = int(case[-1]) if case.startswith("corpus") else 8
    specs = (_corpus() if case.startswith("corpus") else _ERRORS.get(case)
             or _mix_specs(case))
    ok_r, ok_p, n_err = [], [], 0
    for s in specs:
        rf, pf = _build(RF, s), _build(PF, s)
        want = _outcome(lambda: RF.compile_filter(rf, rs, width))
        if isinstance(want, tuple):
            n_err += 1
            assert _outcome(lambda: PF.compile_stacked([pf], ps, width)) == want
            assert _outcome(lambda: PF.compile_filter(pf, ps, width)) == want
            assert _outcome(lambda: compile_programs(
                [PF.TrueFilter(), pf], ps, 2, width, device="cpu")) == want
        else:
            ok_r.append(rf)
            ok_p.append(pf)
    if case in _ERRORS:
        assert n_err == len(specs)
        return
    assert len(ok_p) > len(specs) // 2
    want = _outcome(lambda: RF.stack_programs(
        [RF.compile_filter(f, rs, width) for f in ok_r]))
    _same_bytes(_outcome(lambda: PF.compile_stacked(ok_p, ps, width)), want)
    got = _outcome(lambda: compile_programs(ok_p, ps, len(ok_p), width,
                                            device="cpu"))
    assert got["imask"].dtype == torch.int64
    _same_bytes({k: v.numpy() for k, v in got.items()},
                dict(want, imask=want["imask"].astype(np.int64)))


def _attrs(schema_r, schema_p, n, seed):
    """Same attribute rows for both packages, plus pad rows (ints -1,
    floats NaN) as prefbf.pad_db writes them."""
    a = RF.random_attributes(schema_r, n, seed=seed)
    b = PF.random_attributes(schema_p, n, seed=seed)
    np.testing.assert_array_equal(a.ints, b.ints)
    np.testing.assert_array_equal(a.floats, b.floats)
    ints = np.concatenate([a.ints, np.full((3, a.ints.shape[1]), -1, np.int32)])
    flts = np.concatenate([a.floats,
                           np.full((3, a.floats.shape[1]), np.nan, np.float32)])
    return ints, flts


SCHEMAS = {
    "paper": dict(n_bool=1, n_int=1, n_float=1),
    "no_float": dict(n_bool=1, n_int=2, n_float=0),
    "no_int": dict(n_bool=0, n_int=0, n_float=2),
}


def _schema_filters(F, kind):
    s = F.paper_schema(**SCHEMAS[kind])
    if kind == "paper":
        return s, list(_filters(F).values())
    if kind == "no_float":
        return s, [F.Equality("b0", True), F.Inclusion("i1", [0, 4]),
                   F.Not(F.Range("i0", 3, 5)), F.TrueFilter(),
                   F.Or(F.Equality("i0", 9), F.Equality("b0", False))]
    return s, [F.Range("f0", 20.0, 70.0), F.Not(F.Range("f1", None, 40.0)),
               F.TrueFilter(), F.And(F.Range("f0", 10, 90), F.Range("f1", 5, 50))]


@pytest.mark.parametrize("kind", sorted(SCHEMAS))
def test_evaluators_bit_identical(kind):
    rs, rfl = _schema_filters(RF, kind)
    ps, pfl = _schema_filters(PF, kind)
    ints, flts = _attrs(rs, ps, 300, seed=4)
    r_progs = [RF.compile_filter(f, rs) for f in rfl]
    p_progs = [PF.compile_filter(f, ps) for f in pfl]
    ti, tf = torch.as_tensor(ints), torch.as_tensor(flts)
    for rp, pp in zip(r_progs, p_progs):
        want = RF.eval_program(rp, ints, flts)
        got = PF.eval_program(pp, ti, tf)
        np.testing.assert_array_equal(got.numpy(), want)
        assert not got[-3:].any() or not (rp.imask.size or rp.flo.size)
    rst = RF.stack_programs(r_progs)
    pst = compile_programs(pfl, ps, len(pfl), device="cpu")
    want_b = RF.eval_program_batched(rst, ints, flts)
    got_b = PF.eval_program_batched(pst, ti, tf)
    np.testing.assert_array_equal(got_b.numpy(), want_b)
    # gathered: per-query neighbor rows, pad rows included
    rng = np.random.default_rng(1)
    nb = rng.integers(0, ints.shape[0], size=(len(pfl), 7))
    want_g = RF.eval_program_gathered(rst, ints[nb], flts[nb])
    got_g = PF.eval_program_gathered(pst, ti[nb], tf[nb])
    np.testing.assert_array_equal(got_g.numpy(), want_g)


def test_bit_test_out_of_range_shift_is_zero():
    """ints of -1 and >= 32 select no bit (the full mask 0xFFFFFFFF too)."""
    imask = torch.tensor([[0xFFFFFFFF]], dtype=torch.int64)
    ints = torch.tensor([[-1], [32], [33], [31], [0]], dtype=torch.int32)
    got = PF._bit_test(imask[:, None, :], ints[None, :, :])[0]
    assert got.tolist() == [False, False, False, True, True]


def test_build_hnsw_identical():
    rng = np.random.default_rng(5)
    vecs = rng.normal(size=(500, 8)).astype(np.float32)
    ri = r_hnsw.build_hnsw(vecs, r_hnsw.HnswParams(M=6, efc=32, seed=9))
    pi = p_hnsw.build_hnsw(vecs, p_hnsw.HnswParams(M=6, efc=32, seed=9))
    assert len(ri.levels) == len(pi.levels)
    for a, b in zip(ri.levels, pi.levels):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ri.node_level, pi.node_level)
    assert ri.entry_point == pi.entry_point
    assert ri.max_level == pi.max_level
    assert ri.delta_d == pi.delta_d
    np.testing.assert_array_equal(ri.norms, pi.norms)


@pytest.mark.parametrize("strategy", ["lo", "mid", "mid_norm"])
def test_exclusion_distance_identical(strategy):
    p = np.array([0.0, 1e-5, 0.004, 0.01, 0.05, 0.3, 0.5, 0.99, 1.0],
                 np.float32)
    want = np.asarray(r_excl.exclusion_distance(
        jnp.asarray(p), 128, 0.731, k=10, strategy=strategy, xp=jnp))
    got = p_excl.exclusion_distance(torch.as_tensor(p), 128, 0.731, k=10,
                                    strategy=strategy, xp=torch)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        p_excl.exclusion_distance(p.astype(np.float64), 128, 0.731,
                                  strategy=strategy),
        r_excl.exclusion_distance(p.astype(np.float64), 128, 0.731,
                                  strategy=strategy))


def test_estimate_batched_identical():
    rs, ps = RF.paper_schema(), PF.paper_schema()
    ints, flts = _attrs(rs, ps, 1000, seed=8)
    rfl, pfl = list(_filters(RF).values()), list(_filters(PF).values())
    rst = {k: jnp.asarray(v) for k, v in RF.stack_programs(
        [RF.compile_filter(f, rs) for f in rfl]).items()}
    pst = compile_programs(pfl, ps, len(pfl), device="cpu")
    want = np.asarray(r_sel.estimate_batched(rst, jnp.asarray(ints),
                                             jnp.asarray(flts)))
    got = p_sel.estimate_batched(pst, torch.as_tensor(ints),
                                 torch.as_tensor(flts))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(p_sel.route(got, 0.01),
                                  r_sel.route(want, 0.01))


@pytest.fixture(scope="module")
def baseline_graphs():
    """Each package's own HNSW over the same rows and params (pinned
    identical by test_build_hnsw_identical)."""
    rng = np.random.default_rng(12)
    vecs = rng.normal(size=(1200, 12)).astype(np.float32)
    ri = r_hnsw.build_hnsw(vecs, r_hnsw.HnswParams(M=8, efc=40, seed=3))
    pi = p_hnsw.build_hnsw(vecs, p_hnsw.HnswParams(M=8, efc=40, seed=3))
    return ri, pi, rng.normal(size=(6, 12)).astype(np.float32)


@pytest.mark.parametrize("kind", ["acorn-two_hop", "acorn-one_hop",
                                  "postfilter"])
def test_baseline_search_identical(baseline_graphs, kind):
    """The ACORN-1-style and post-filter baselines give the reference's
    ids, dists and SearchStats, exactly, at about 1 %, 10 % and 50 %
    selectivity."""
    import dataclasses
    from repro.core import refimpl as r_ref
    from repro_torch.core import refimpl as p_ref
    ri, pi, qs = baseline_graphs
    rng = np.random.default_rng(31)
    found = {}
    for sel in (0.01, 0.1, 0.5):
        mask = rng.random(ri.n) < sel
        found[sel] = 0
        for q in qs:
            if kind == "postfilter":
                want = r_ref.postfilter_search(ri, q, mask, 10, 48)
                got = p_ref.postfilter_search(pi, q, mask, 10, 48)
            else:
                two = kind == "acorn-two_hop"
                want = r_ref.acorn_search(ri, q, mask, 10, 48, two_hop=two)
                got = p_ref.acorn_search(pi, q, mask, 10, 48, two_hop=two)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
            assert got[1].dtype == want[1].dtype
            assert dataclasses.asdict(got[2]) == dataclasses.asdict(want[2])
            found[sel] += len(want[0])
    # a post-filtered beam of 48 may hold no target at 1 %
    assert found[0.1] > 0 and found[0.5] > 0, found
