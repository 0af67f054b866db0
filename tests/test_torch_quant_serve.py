"""The compressed brute route at the smoke run's serve size, in both
packages: 16,384 rows of the synthetic paper corpus (d = 128), favor-anns'
PQ widths (m = 32 x 8 bits), the smoke run's mixed filters, and a re-rank
depth of 40 ADC candidates (``graph_rerank`` 4 x k = 10).

``chip_smoke.py`` holds the PQ graph route to this exhaustive compressed
scan, not to the f32 route, because at this size PQ m = 32 x 8 bits cannot
rank the corpus' near neighbours as f32 does.  These tests are the second
witness for that bar: the JAX package's own k-means and scan give the same
low recall, the port's k-means is no worse than the JAX package's, and with
the JAX codebook carried across the port's LUTs, scan and re-rank return
the JAX package's ids.  ``pytest -s`` prints the recalls.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import quant as rq  # noqa: E402
from repro.core import filters as RF  # noqa: E402
from repro.core import prefbf as r_prefbf  # noqa: E402
from repro.core import refimpl  # noqa: E402
from repro.core.router import compile_programs as r_compile  # noqa: E402
from repro.data import synthetic as r_synth  # noqa: E402
from repro_torch import quant as pq  # noqa: E402
from repro_torch.core import filters as PF  # noqa: E402
from repro_torch.core.router import compile_programs as p_compile  # noqa: E402
from repro_torch.data import synthetic as p_synth  # noqa: E402
from repro_torch.kernels.pq_adc import ops as p_pq  # noqa: E402

N, D, B, K = 16384, 128, 140, 10
PQ_M, PQ_BITS, RERANK = 32, 8, 4       # favor-anns' PQ; graph_rerank's depth


def _mixed(F, schema):
    """The smoke run's filters: the six paper scenarios and a < 1 % one,
    in turn."""
    scen = dict(F.paper_filters(schema))
    scen["tiny_lt1pct"] = F.And(F.Equality("i0", 3), F.Range("f0", 10, 12))
    names = [list(scen)[i % len(scen)] for i in range(B)]
    return [scen[n] for n in names], names


@pytest.fixture(scope="module")
def serve():
    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    vecs, attrs, schema = r_synth.make_paper_dataset(N, D, seed=0)
    qs = r_synth.make_queries(B, D, dataset_seed=0, seed=100)
    p_vecs, _, _ = p_synth.make_paper_dataset(N, D, seed=0)
    np.testing.assert_array_equal(np.asarray(p_vecs), vecs)
    rflt, names = _mixed(RF, schema)
    pflt, _ = _mixed(PF, PF.paper_schema())
    norms = np.einsum("nd,nd->n", vecs, vecs).astype(np.float32)
    db = r_prefbf.pad_db(vecs, norms, attrs.ints, attrs.floats, chunk=8192)
    truth = []
    for q, f in zip(qs, rflt):
        mask = RF.eval_program(RF.compile_filter(f, schema), attrs.ints,
                               attrs.floats)
        truth.append(refimpl.bruteforce_filtered(vecs, mask, q, K)[0])

    def recall(ids):
        return np.array([refimpl.recall_at_k(i, t, K)
                         for i, t in zip(np.asarray(ids), truth)])

    # the JAX package: its k-means, its encoding, its scan and re-rank
    r_cb = rq.train_pq(vecs, m=PQ_M, nbits=PQ_BITS, seed=0)
    r_cents = np.array(r_cb.centroids)
    r_codes = np.array(rq.encode(r_cb, db[0]))
    r_progs = r_compile(rflt, schema, B)
    r_ids, _ = rq.pq_prefbf_topk(r_codes, db[1], db[2], db[3], qs, r_progs,
                                 r_cents, db[0], k=K, rerank=RERANK)
    # the port on its own k-means, and on the JAX codebook and codes
    p_db = tuple(torch.as_tensor(a) for a in db)
    p_progs = p_compile(pflt, PF.paper_schema(), B, device="cpu")
    p_q = torch.as_tensor(qs)

    def port_scan(centroids, codes):
        return pq.pq_prefbf_topk(codes, p_db[1], p_db[2], p_db[3], p_q,
                                 p_progs, torch.as_tensor(centroids),
                                 p_db[0], k=K, rerank=RERANK)[0].numpy()

    own_cb = pq.train_pq(vecs, m=PQ_M, nbits=PQ_BITS, seed=0,
                         device="cpu")
    out = {"names": np.asarray(names),
           "jax": recall(r_ids),
           "port_own_kmeans": recall(port_scan(own_cb.centroids,
                                               pq.encode(own_cb, db[0],
                                                         device="cpu"))),
           "r_ids": np.asarray(r_ids),
           "carried_ids": port_scan(r_cents, torch.as_tensor(r_codes)),
           "carried": (r_cents, torch.as_tensor(r_codes), p_db,
                       p_progs, p_q)}
    out["port_jax_codebook"] = recall(out["carried_ids"])
    for key in ("jax", "port_own_kmeans", "port_jax_codebook"):
        per = {nm: round(float(out[key][out["names"] == nm].mean()), 4)
               for nm in dict.fromkeys(names)}
        print(f"\nrecall@10 {key}: {out[key].mean():.4f} {per}")
    yield out
    torch.set_num_threads(n_threads)


def test_port_kmeans_no_worse_than_reference_at_serve_size(serve):
    """The port's own k-means codebook (torch generator) reaches at least
    the JAX-trained codebook's exhaustive compressed recall less 0.02."""
    assert serve["port_own_kmeans"].mean() >= serve["jax"].mean() - 0.02, (
        serve["port_own_kmeans"].mean(), serve["jax"].mean())


def test_carried_codebook_matches_reference_at_serve_size(serve):
    """On the JAX codebook and codes, the port's LUTs, ADC scan and exact
    re-rank return the JAX package's ids on every row without a near-tie at
    the 40-candidate boundary (fewer than 1 % of rows excluded)."""
    centroids, codes, p_db, p_progs, p_q = serve["carried"]
    R = RERANK * K
    luts = pq.build_luts(torch.as_tensor(centroids), p_q)
    _, adc = p_pq.pq_adc_topr(codes, p_db[1], p_db[2], p_db[3], luts,
                              p_progs, r=R + 1)
    adc = adc.numpy().astype(np.float64)
    with np.errstate(invalid="ignore"):
        near = ~(adc[:, R] - adc[:, R - 1] > 1e-5 * adc[:, R - 1])
    near &= np.isfinite(adc[:, R])
    assert near.mean() < 0.01, near.sum()
    np.testing.assert_array_equal(serve["carried_ids"][~near],
                                  serve["r_ids"][~near])
    np.testing.assert_array_equal(serve["port_jax_codebook"][~near],
                                  serve["jax"][~near])
