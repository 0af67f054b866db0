"""Port parity, compressed routes end to end: a quantized ``FavorIndex`` of
the JAX package (its k-means codebook and codes, built on the shared
``small_index``) carried across to the port, and both packages queried on
the same batches.

Bars: p_hat and routes identical row for row; under ``use_pq`` the brute
route returns identical ids on every row whose R-th and (R+1)-th ADC
distances are apart by more than 1e-5 relative (the excluded rows are
counted, fewer than 1 %); under ``graph_quant="pq"`` / ``"sq"`` the graph
route's recall@10 within 0.02 of the JAX package's in every paper scenario
and at least 90 % of rows identical;
the port's own k-means codebook within 0.02 of the JAX-trained one's
``use_pq`` recall; index files with quantization state loading in either
package."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import BuildSpec as RBuild  # noqa: E402
from repro.core import FavorIndex as RIndex  # noqa: E402
from repro.core import QuantSpec as RQuant  # noqa: E402
from repro.core import SearchOptions as ROpts  # noqa: E402
from repro.core import filters as RF  # noqa: E402
from repro.core import refimpl  # noqa: E402
from repro.quant import save_codebook as r_save_codebook  # noqa: E402
from repro_torch.convert import from_reference_arrays  # noqa: E402
from repro_torch.core import BuildSpec, FavorIndex, QuantSpec  # noqa: E402
from repro_torch.core import SearchConfig, SearchOptions  # noqa: E402
from repro_torch.core import exclusion  # noqa: E402
from repro_torch.core import filters as PF  # noqa: E402
from repro_torch.core.search import favor_graph_search  # noqa: E402
from repro_torch.kernels.pq_adc import ops as p_pq  # noqa: E402
from repro_torch.parity import topk_mismatch  # noqa: E402
from repro_torch.quant import adc as p_adc  # noqa: E402


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
QUANT = {"pq": dict(kind="pq", m=8, nbits=6, train_iters=15, rerank=4),
         "sq": dict(kind="sq", rerank=4)}


@pytest.fixture(scope="module")
def ref_quant(small_index, small_dataset):
    """The JAX package's quantized indexes over small_index's graph."""
    _, attrs, _ = small_dataset
    return {kind: RIndex(small_index.index, attrs,
                         RBuild(quant=RQuant(**kw)))
            for kind, kw in QUANT.items()}


def _port_of(ref, **kw):
    idx = ref.index
    cb = ref.codebook
    arrays = ({"centroids": cb.centroids} if ref.quantize == "pq" else
              {"lo": cb.lo, "scale": cb.scale}) if cb is not None else {}
    if cb is not None:
        arrays["codes"] = np.asarray(ref._codes)[:idx.n]
    return from_reference_arrays(
        vectors=idx.vectors, levels=idx.levels, node_level=idx.node_level,
        entry_point=idx.entry_point, delta_d=idx.delta_d, params=idx.params,
        ints=ref.attrs.ints, floats=ref.attrs.floats, schema=ref.schema,
        device="cpu", **arrays, **kw)


@pytest.fixture(scope="module")
def port_quant(ref_quant):
    return {kind: _port_of(ref, spec=BuildSpec(quant=QuantSpec(**QUANT[kind])))
            for kind, ref in ref_quant.items()}


def _mixed(F, schema, per):
    flts = list(F.paper_filters(schema).values())
    flts.append(F.And(F.Equality("i0", 3), F.Range("f0", 10, 12)))
    return [f for f in flts for _ in range(per)]


@pytest.fixture(scope="module")
def batch(small_dataset):
    vecs, _, schema = small_dataset
    rflt, pflt = _mixed(RF, schema, 20), _mixed(PF, PF.paper_schema(), 20)
    rng = np.random.default_rng(31)
    qs = rng.normal(size=(len(rflt), vecs.shape[1])).astype(np.float32)
    return qs, rflt, pflt


def _truth(small_dataset, qs, flts):
    vecs, attrs, schema = small_dataset
    out = []
    for q, f in zip(qs, flts):
        mask = RF.eval_program(RF.compile_filter(f, schema), attrs.ints,
                               attrs.floats)
        out.append(refimpl.bruteforce_filtered(vecs, mask, q, K)[0])
    return out


def _recall(ids, truth):
    return float(np.mean([refimpl.recall_at_k(i, t, K)
                          for i, t in zip(ids, truth)]))


@pytest.fixture(scope="module")
def truth(small_dataset, batch):
    qs, rflt, _ = batch
    return _truth(small_dataset, qs, rflt)


def test_carried_codes_and_codebook(ref_quant, port_quant):
    for kind in QUANT:
        ref, port = ref_quant[kind], port_quant[kind]
        assert port.quantize == kind and port.rerank == 4
        np.testing.assert_array_equal(port._codes.numpy(),
                                      np.asarray(ref._codes))
        np.testing.assert_array_equal(port.g["codes"].numpy(),
                                      np.asarray(ref.g["codes"]))


def test_use_pq_matches_reference(ref_quant, port_quant, batch, truth):
    ref, port = ref_quant["pq"], port_quant["pq"]
    qs, rflt, pflt = batch
    # routed: identical estimates and routes, both routes ran
    r = ref.query(qs, rflt, ROpts(k=K, ef=96, use_pq=True))
    g = port.query(qs, pflt, SearchOptions(k=K, ef=96, use_pq=True))
    np.testing.assert_array_equal(g.p_hat, r.p_hat)
    np.testing.assert_array_equal(g.routed_brute, r.routed_brute)
    assert r.routed_brute.any() and (~r.routed_brute).any()
    # every query through the compressed brute route
    opts = dict(k=K, ef=96, use_pq=True, force="brute")
    r = ref.query(qs, rflt, ROpts(**opts))
    g = port.query(qs, pflt, SearchOptions(**opts))
    # rows with a near-tie at the ADC candidate boundary may legitimately
    # keep another R-th candidate
    R = max(K, port.rerank * K)
    pv, pn, pi, pf = port._pf
    luts = p_adc.build_luts(port._cb_dev[0], torch.as_tensor(qs))
    _, adc = p_pq.pq_adc_topr(port._codes, pn, pi, pf, luts,
                              port.compile_filters(pflt), r=R + 1)
    adc = adc.numpy().astype(np.float64)
    with np.errstate(invalid="ignore"):
        gap = adc[:, R] - adc[:, R - 1]
        near = ~(gap > 1e-5 * adc[:, R - 1])
    near &= np.isfinite(adc[:, R])
    assert near.mean() < 0.01, near.sum()
    keep = ~near
    np.testing.assert_array_equal(g.ids[keep], r.ids[keep])
    m = topk_mismatch(r.ids[keep], r.dists[keep], g.ids[keep], g.dists[keep])
    assert m["dist_mismatch"] == 0, m
    assert _recall(g.ids, truth) >= 0.98


@pytest.mark.parametrize("kind", sorted(QUANT))
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_graph_quant_matches_reference(ref_quant, port_quant, small_dataset,
                                       kind, scenario):
    vecs = small_dataset[0]
    rflt = RF.paper_filters(small_dataset[2])[scenario]
    pflt = PF.paper_filters(PF.paper_schema())[scenario]
    rng = np.random.default_rng(41)
    qs = rng.normal(size=(24, vecs.shape[1])).astype(np.float32)
    opts = dict(k=K, ef=EF, force="graph", graph_quant=kind)
    r = ref_quant[kind].query(qs, rflt, ROpts(**opts))
    g = port_quant[kind].query(qs, pflt, SearchOptions(**opts))
    truth = _truth(small_dataset, qs, [rflt] * len(qs))
    rec_ref, rec_port = _recall(r.ids, truth), _recall(g.ids, truth)
    assert rec_port >= rec_ref - 0.02, (rec_port, rec_ref)
    # the walk follows approximate distances that agree to the last bits:
    # nearly every row is identical (measured: all of them)
    assert (r.ids == g.ids).all(axis=1).mean() >= 0.9
    np.testing.assert_array_equal(g.p_hat, r.p_hat)
    # the exact re-rank returns exact f32 distances in ascending order
    fin = np.isfinite(g.dists)
    assert (np.diff(np.where(fin, g.dists, np.inf), axis=1) >= 0).all()
    assert (g.hops > 0).all() and (g.waves > 0).all()


@pytest.mark.parametrize("kind", sorted(QUANT))
def test_graph_quant_ladder_changes_no_result(port_quant, batch, kind):
    """The lane-compaction ladder restages the scorer state (PQ LUTs per
    lane, SQ's shared w2 untouched): with it on and off the rows agree."""
    port = port_quant[kind]
    qs, _, pflt = batch
    qs, pflt = qs[:40], pflt[:40]
    progs = port.compile_filters(pflt)
    p = port.backend.estimate(progs)
    D = exclusion.exclusion_distance(p, EF, port.delta_d, k=K,
                                     p_min=port.sel_cfg.p_min, xp=torch)
    q = torch.as_tensor(qs)
    on = favor_graph_search(port.g, q, progs, D,
                            SearchConfig(k=K, ef=EF, graph_quant=kind))
    off = favor_graph_search(port.g, q, progs, D,
                             SearchConfig(k=K, ef=EF, graph_quant=kind,
                                          lane_compact=0))
    assert int(on["waves"][0]) > 0
    for key in ("ids", "dists", "hops", "path_td"):
        assert torch.equal(on[key], off[key]), key


def test_port_kmeans_recall_near_reference_codebook(ref_quant, port_quant,
                                                    small_dataset, batch,
                                                    truth):
    """The port trains its own k-means (torch generator, not jax.random):
    its use_pq recall@10 is within 0.02 of the JAX-trained codebook's."""
    carried = port_quant["pq"]
    own = FavorIndex(carried.index, carried.attrs,
                     BuildSpec(quant=QuantSpec(**QUANT["pq"])), device="cpu")
    assert own.codebook.centroids.shape == carried.codebook.centroids.shape
    qs, _, pflt = batch
    opts = SearchOptions(k=K, ef=96, use_pq=True, force="brute")
    rec_own = _recall(own.query(qs, pflt, opts).ids, truth)
    rec_ref = _recall(carried.query(qs, pflt, opts).ids, truth)
    assert rec_own >= rec_ref - 0.02, (rec_own, rec_ref)


@pytest.mark.parametrize("kind", sorted(QUANT))
def test_reference_saved_quantized_index_loads_into_port(ref_quant,
                                                         port_quant, batch,
                                                         kind, tmp_path):
    path = str(tmp_path / "ref")
    ref_quant[kind].save(path)
    got = FavorIndex.load(path, device="cpu")
    carried = port_quant[kind]
    assert got.quantize == kind
    np.testing.assert_array_equal(got._codes.numpy(),
                                  carried._codes.numpy())
    qs, _, pflt = batch
    opts = SearchOptions(k=K, ef=64, use_pq=True, force="brute")
    np.testing.assert_array_equal(got.query(qs[:30], pflt[:30], opts).ids,
                                  carried.query(qs[:30], pflt[:30], opts).ids)
    with pytest.raises(ValueError, match="quant kind"):
        FavorIndex.load(path, BuildSpec(quant=QuantSpec(
            kind="sq" if kind == "pq" else "pq")), device="cpu")


def test_port_saved_quantized_index_loads_into_reference(ref_quant,
                                                         port_quant,
                                                         tmp_path):
    for kind in QUANT:
        path = str(tmp_path / kind)
        port_quant[kind].save(path)
        back = RIndex.load(path)
        ref = ref_quant[kind]
        assert back.quantize == kind
        np.testing.assert_array_equal(np.asarray(back._codes),
                                      np.asarray(ref._codes))
        fields = ("centroids",) if kind == "pq" else ("lo", "scale")
        for f in fields:
            np.testing.assert_array_equal(getattr(back.codebook, f),
                                          getattr(ref.codebook, f))


def test_load_codebook_beside_unquantized_index(small_index, ref_quant,
                                                tmp_path):
    """An .hnsw.npz without quant keys and a .quant.npz beside it: the
    codebook comes from the file and the port encodes the rows."""
    path = str(tmp_path / "plain")
    small_index.save(path)
    with pytest.raises(ValueError, match="without quantization"):
        FavorIndex.load(path, BuildSpec(quant=QuantSpec(**QUANT["pq"])),
                        device="cpu")
    r_save_codebook(path + ".quant.npz", ref_quant["pq"].codebook)
    got = FavorIndex.load(path, device="cpu")
    assert got.quantize == "pq"
    assert (got._codes.numpy() == np.asarray(ref_quant["pq"]._codes)).mean() \
        > 0.999


def test_quant_options_and_validation(port_quant, small_index):
    with pytest.raises(ValueError, match="rerank"):
        SearchOptions(rerank=-1)
    with pytest.raises(ValueError, match="graph_rerank"):
        SearchOptions(graph_rerank=-1)
    assert SearchOptions(graph_quant="pq").search_config().graph_rerank == 4
    assert SearchOptions(graph_rerank=0).search_config().graph_rerank == 0
    plain = _port_of(small_index)
    qs = np.zeros((2, 16), np.float32)
    with pytest.raises(ValueError, match="quantize"):
        plain.query(qs, PF.TrueFilter(), SearchOptions(use_pq=True))
    with pytest.raises(ValueError, match="graph_quant='sq'"):
        port_quant["pq"].query(qs, PF.TrueFilter(),
                               SearchOptions(graph_quant="sq"))
    be = port_quant["pq"].backend
    assert be.bytes_per_hop(SearchOptions()) == 4 * 16
    assert be.bytes_per_hop(SearchOptions(graph_quant="pq")) == 8
    assert port_quant["sq"].backend.bytes_per_hop(
        SearchOptions(graph_quant="sq")) == 16
    idx, attrs = plain.index, plain.attrs
    cb = port_quant["pq"].codebook
    with pytest.raises(ValueError, match="codes="):
        FavorIndex(idx, attrs, codes=np.zeros((idx.n, 8), np.uint8),
                   device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        FavorIndex(idx, attrs, BuildSpec(quant=QuantSpec(kind="sq")),
                   codebook=cb, device="cpu")
    with pytest.raises(ValueError, match="geometry"):
        FavorIndex(idx, attrs, BuildSpec(quant=QuantSpec(m=4, nbits=6)),
                   codebook=cb, device="cpu")
    with pytest.raises(ValueError, match="rows"):
        FavorIndex(idx, attrs, codebook=cb,
                   codes=np.zeros((5, 8), np.uint8), device="cpu")
