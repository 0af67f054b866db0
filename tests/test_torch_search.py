"""Port parity, graph route: ``favor_graph_search`` of the port against the
JAX package's on the shared ``small_index`` for the six paper scenarios.

The traversal follows distances, so a last-ulp difference in one distance
can change a query's path; the bar is therefore recall@10 against exact
filtered ground truth no lower than the reference's minus 0.02, and at least
90 % of rows with identical ids (measured on this fixture: 100 %, with
identical hops and waves)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import SearchConfig as RConfig  # noqa: E402
from repro.core import exclusion as r_excl  # noqa: E402
from repro.core import favor_graph_search as r_search  # noqa: E402
from repro.core import filters as RF  # noqa: E402
from repro.core import refimpl, rsf_graph_search as r_rsf  # noqa: E402
from repro_torch.core import SearchConfig as PConfig  # noqa: E402
from repro_torch.core import exclusion as p_excl  # noqa: E402
from repro_torch.core import filters as PF  # noqa: E402
from repro_torch.core import search as p_search  # noqa: E402
from repro_torch.core.router import compile_programs  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the other
    test workers on the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SCENARIOS = ("equality_bool", "equality_int", "inclusion", "range_10",
             "range_50", "logic")
K, EF = 10, 80


@pytest.fixture(scope="module")
def port_graph(small_index, small_dataset):
    _, attrs, _ = small_dataset
    pattrs = PF.AttributeTable(PF.paper_schema(), attrs.ints, attrs.floats)
    return p_search.graph_arrays(small_index.index, pattrs, "cpu")


@pytest.fixture(scope="module")
def queries(small_dataset):
    vecs, _, _ = small_dataset
    rng = np.random.default_rng(5)
    return rng.normal(size=(24, vecs.shape[1])).astype(np.float32)


def _both(small_index, small_dataset, queries, port_graph, name, rsf=False):
    vecs, attrs, schema = small_dataset
    rflt = RF.paper_filters(schema)[name]
    pflt = PF.paper_filters(PF.paper_schema())[name]
    mask = RF.eval_program(RF.compile_filter(rflt, schema), attrs.ints,
                           attrs.floats)
    b = len(queries)
    p = np.full((b,), mask.mean(), np.float32)
    rprog = {k: jnp.asarray(v) for k, v in RF.stack_programs(
        [RF.compile_filter(rflt, schema)] * b).items()}
    pprog = compile_programs(pflt, PF.paper_schema(), b, device="cpu")
    q = torch.as_tensor(queries)
    if rsf:
        ref = r_rsf(small_index.g, jnp.asarray(queries), rprog,
                    RConfig(k=K, ef=EF))
        got = p_search.rsf_graph_search(port_graph, q, pprog,
                                        PConfig(k=K, ef=EF))
    else:
        rD = r_excl.exclusion_distance(jnp.asarray(p), EF,
                                       small_index.delta_d, xp=jnp)
        pD = p_excl.exclusion_distance(torch.as_tensor(p), EF,
                                       small_index.delta_d, xp=torch)
        np.testing.assert_array_equal(pD.numpy(), np.asarray(rD))
        ref = r_search(small_index.g, jnp.asarray(queries), rprog, rD,
                       RConfig(k=K, ef=EF))
        got = p_search.favor_graph_search(port_graph, q, pprog, pD,
                                          PConfig(k=K, ef=EF))
    truth = [refimpl.bruteforce_filtered(vecs, mask, qq, K)[0]
             for qq in queries]
    rec = {
        "ref": np.mean([refimpl.recall_at_k(np.asarray(ref["ids"][i]), t, K)
                        for i, t in enumerate(truth)]),
        "port": np.mean([refimpl.recall_at_k(got["ids"][i].numpy(), t, K)
                         for i, t in enumerate(truth)]),
    }
    return ref, got, rec, mask


def _assert_bar(ref, got, rec, mask):
    assert rec["port"] >= rec["ref"] - 0.02, rec
    rids, pids = np.asarray(ref["ids"]), got["ids"].numpy()
    same = (rids == pids).all(axis=1)
    assert same.mean() >= 0.9, same.mean()
    for row in pids:                       # S holds targets only
        assert mask[row[row >= 0]].all()
    fin = np.isfinite(np.asarray(ref["dists"]))
    np.testing.assert_allclose(got["dists"].numpy()[fin & same[:, None]],
                               np.asarray(ref["dists"])[fin & same[:, None]],
                               rtol=1e-5, atol=1e-5)
    # diagnostics are reported per query; where the rows agree the walk did
    np.testing.assert_array_equal(got["hops"].numpy()[same],
                                  np.asarray(ref["hops"])[same])
    assert got["waves"].shape == (len(pids),)
    assert (got["hops"].numpy() > 0).all()


@pytest.mark.parametrize("name", SCENARIOS)
def test_favor_graph_search_matches_reference(small_index, small_dataset,
                                              queries, port_graph, name):
    ref, got, rec, mask = _both(small_index, small_dataset, queries,
                                port_graph, name)
    _assert_bar(ref, got, rec, mask)
    if (np.asarray(ref["ids"]) == got["ids"].numpy()).all():
        np.testing.assert_array_equal(got["waves"].numpy(),
                                      np.asarray(ref["waves"]))


def test_rsf_graph_search_matches_reference(small_index, small_dataset,
                                            queries, port_graph):
    _assert_bar(*_both(small_index, small_dataset, queries, port_graph,
                       "equality_int", rsf=True))


def test_lane_compaction_changes_no_result(small_index, small_dataset,
                                           queries, port_graph):
    """The compaction ladder only sets ``waves``: a single-stage traversal
    returns the same ids, distances and hops."""
    pflt = PF.paper_filters(PF.paper_schema())["inclusion"]
    pprog = compile_programs(pflt, PF.paper_schema(), len(queries),
                             device="cpu")
    D = torch.full((len(queries),), 0.8)
    q = torch.as_tensor(queries)
    a = p_search.favor_graph_search(port_graph, q, pprog, D,
                                    PConfig(k=K, ef=EF))
    b = p_search.favor_graph_search(port_graph, q, pprog, D,
                                    PConfig(k=K, ef=EF, lane_compact=0))
    for key in ("ids", "dists", "hops", "path_td"):
        assert torch.equal(a[key], b[key]), key
    valid = torch.ones(len(queries), dtype=torch.bool)
    valid[3] = False
    c = p_search.favor_graph_search(port_graph, q, pprog, D,
                                    PConfig(k=K, ef=EF), valid=valid)
    assert (c["ids"][3] == -1).all() and c["hops"][3] == 0
    keep = valid.numpy()
    assert torch.equal(c["ids"][keep], a["ids"][keep])
