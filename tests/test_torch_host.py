"""Port parity, host modules: the DNF compiler, the torch filter evaluators,
the HNSW build, the exclusion distance and the selectivity estimate must be
bit-identical to the JAX package on the same numpy inputs."""
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
