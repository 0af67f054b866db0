"""Port parity, end to end: ``FavorIndex.query`` of the port against the JAX
package's on the shared ``small_index``, and index files moving between the
two packages.

Bars: p_hat and the route identical row for row; brute-route rows at the
kernel bar (distances 1e-5, ids identical outside ties); graph-route rows at
the search bar (recall within 0.02 of the reference's, >= 90 % identical)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import FavorIndex as RIndex  # noqa: E402
from repro.core import SearchOptions as ROpts  # noqa: E402
from repro.core import filters as RF  # noqa: E402
from repro.core import refimpl  # noqa: E402
from repro_torch.convert import from_reference_arrays  # noqa: E402
from repro_torch.core import FavorIndex as PIndex  # noqa: E402
from repro_torch.core import SearchOptions as POpts  # noqa: E402
from repro_torch.core import filters as PF  # noqa: E402
from repro_torch.parity import topk_mismatch  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the other
    test workers on the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PER_SCENARIO = 5


def _mixed(F, schema):
    """The six paper scenarios plus a < 1 % filter, PER_SCENARIO queries
    each."""
    flts = list(F.paper_filters(schema).values())
    flts.append(F.And(F.Equality("i0", 3), F.Range("f0", 10, 12)))
    return [f for f in flts for _ in range(PER_SCENARIO)]


def _port_of(ref, **kw):
    idx = ref.index
    return from_reference_arrays(
        vectors=idx.vectors, levels=idx.levels, node_level=idx.node_level,
        entry_point=idx.entry_point, delta_d=idx.delta_d, params=idx.params,
        ints=ref.attrs.ints, floats=ref.attrs.floats, schema=ref.schema,
        device="cpu", **kw)


@pytest.fixture(scope="module")
def batch(small_dataset):
    vecs, _, schema = small_dataset
    rflt = _mixed(RF, schema)
    pflt = _mixed(PF, PF.paper_schema())
    rng = np.random.default_rng(21)
    qs = rng.normal(size=(len(rflt), vecs.shape[1])).astype(np.float32)
    return qs, rflt, pflt


def test_query_matches_reference(small_index, small_dataset, batch):
    vecs, attrs, schema = small_dataset
    qs, rflt, pflt = batch
    port = _port_of(small_index, norms=small_index.index.norms)
    ref = small_index.query(qs, rflt, ROpts(k=10, ef=96))
    got = port.query(qs, pflt, POpts(k=10, ef=96))
    np.testing.assert_array_equal(got.p_hat, ref.p_hat)
    np.testing.assert_array_equal(got.routed_brute, ref.routed_brute)
    brute = ref.routed_brute
    assert brute.any() and (~brute).any()     # both routes ran
    m = topk_mismatch(ref.ids[brute], ref.dists[brute], got.ids[brute],
                      got.dists[brute])
    assert m["dist_mismatch"] == 0 and m["id_mismatch"] == 0, m
    g = ~brute
    assert (ref.ids[g] == got.ids[g]).all(axis=1).mean() >= 0.9
    masks = [RF.eval_program(RF.compile_filter(f, schema), attrs.ints,
                             attrs.floats) for f in rflt]
    rec = {}
    for name, res in (("ref", ref), ("port", got)):
        rec[name] = np.mean([
            refimpl.recall_at_k(res.ids[i], refimpl.bruteforce_filtered(
                vecs, masks[i], qs[i], 10)[0], 10)
            for i in np.nonzero(g)[0]])
    assert rec["port"] >= rec["ref"] - 0.02, rec
    np.testing.assert_array_equal(got.hops[brute], 0)
    assert (got.hops[g] > 0).all() and got.elapsed_s > 0


def test_reference_saved_index_loads_into_port(small_index, tmp_path):
    path = str(tmp_path / "ref")
    small_index.save(path)
    port = PIndex.load(path, device="cpu")
    ref = RIndex.load(path)
    for a, b in zip(ref.index.levels, port.index.levels):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.index.vectors, ref.index.vectors)
    np.testing.assert_array_equal(port.index.norms, ref.index.norms)
    np.testing.assert_array_equal(port.sample_idx, ref.sample_idx)
    assert port.delta_d == ref.delta_d
    assert port.index.entry_point == ref.index.entry_point
    assert [(c.name, c.kind, c.vocab) for c in port.schema.columns] == \
        [(c.name, c.kind, c.vocab) for c in ref.schema.columns]


def test_port_saved_index_loads_into_reference(small_index, tmp_path):
    port = _port_of(small_index)
    path = str(tmp_path / "port")
    port.save(path)
    ref = RIndex.load(path)
    for a, b in zip(small_index.index.levels, ref.index.levels):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ref.attrs.ints, small_index.attrs.ints)
    np.testing.assert_array_equal(ref.attrs.floats, small_index.attrs.floats)
    assert ref.index.params == small_index.index.params
    assert ref.delta_d == small_index.delta_d


def test_from_reference_arrays_equals_load(small_index, tmp_path, batch):
    qs, _, pflt = batch
    path = str(tmp_path / "ref")
    small_index.save(path)
    a = PIndex.load(path, device="cpu")
    b = _port_of(small_index)
    opts = POpts(k=10, ef=64)
    ra, rb = a.query(qs, pflt, opts), b.query(qs, pflt, opts)
    np.testing.assert_array_equal(ra.ids, rb.ids)
    np.testing.assert_array_equal(ra.dists, rb.dists)
    np.testing.assert_array_equal(ra.p_hat, rb.p_hat)
