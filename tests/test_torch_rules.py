"""Rules of the port: it imports nothing of JAX or of the JAX package, its
entry points run on the CUDA device unless asked for the CPU, and a kernel
wrapper handed CUDA tensors launches its kernel or raises -- it never falls
back to the plain version."""
import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels as K  # noqa: E402
from repro_torch.core import FavorIndex, HnswParams, SearchOptions  # noqa: E402
from repro_torch.core import BuildSpec, QuantSpec  # noqa: E402
from repro_torch.core import filters as PF  # noqa: E402
from repro_torch.core.router import compile_programs  # noqa: E402
from repro_torch.kernels import _common  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as eb  # noqa: E402
from repro_torch.kernels.filtered_topk import ops as ft  # noqa: E402
from repro_torch.kernels.gather_distance import ops as gd  # noqa: E402
from repro_torch.kernels.pq_adc import ops as pq  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the other
    test workers on the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path.name}:{node.lineno} imports {name}"


def _tiny():
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(64, 8)).astype(np.float32)
    attrs = PF.random_attributes(PF.paper_schema(), 64, seed=1)
    return vecs, attrs


def test_build_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vecs, attrs = _tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FavorIndex.build(vecs, attrs, HnswParams(M=4, efc=16))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FavorIndex.build(vecs, attrs, HnswParams(M=4, efc=16), device="cuda")
    fi = FavorIndex.build(vecs, attrs, HnswParams(M=4, efc=16), device="cpu")
    assert fi.device.type == "cpu"
    assert fi.g["vectors"].device.type == "cpu"


def test_load_defaults_to_cuda(monkeypatch, tmp_path):
    vecs, attrs = _tiny()
    fi = FavorIndex.build(vecs, attrs, HnswParams(M=4, efc=16), device="cpu")
    fi.save(str(tmp_path / "ix"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FavorIndex.load(str(tmp_path / "ix"))


def test_codebook_helpers_default_to_cuda(monkeypatch):
    """``quant.train_pq`` and ``quant.encode`` of host (numpy) data run on
    the card unless the caller asks for the CPU: without a card they raise
    when no device is given, and run when ``device="cpu"`` is."""
    from repro_torch import quant
    vecs, _ = _tiny()
    cb = quant.train_pq(vecs, m=4, nbits=4, iters=2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quant.train_pq(vecs, m=4, nbits=4, iters=2)
    for book in (cb, quant.train_sq(vecs)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            quant.encode(book, vecs)
        codes = quant.encode(book, vecs, device="cpu")
        assert codes.device.type == "cpu"
        # a tensor's own device stays the default
        assert quant.encode(book, torch.as_tensor(vecs)).device.type == "cpu"


def _kernel_args(b=3, n=40, d=8):
    rng = np.random.default_rng(2)
    attrs = PF.random_attributes(PF.paper_schema(), n, seed=3)
    vecs = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32))
    db = (vecs, (vecs * vecs).sum(1), torch.as_tensor(attrs.ints),
          torch.as_tensor(attrs.floats))
    qs = torch.as_tensor(rng.normal(size=(b, d)).astype(np.float32))
    progs = compile_programs(PF.TrueFilter(), PF.paper_schema(), b,
                             device="cpu")
    return db, qs, progs


def _pq_args(b=3, n=40, m=4, ksub=16):
    rng = np.random.default_rng(4)
    codes = torch.as_tensor(rng.integers(0, ksub, size=(n, m)),
                            dtype=torch.uint8)
    luts = torch.as_tensor(rng.uniform(0, 1, size=(b, m, ksub)),
                           dtype=torch.float32)
    return codes, luts


def test_wrappers_raise_on_cuda_request_without_device(monkeypatch):
    """Pretend the tensors are CUDA tensors on a machine with no card: the
    wrappers must raise and never run their plain versions."""
    calls = []
    monkeypatch.setattr(_common, "on_cuda", lambda t: True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(ft, "filtered_topk_plain",
                        lambda *a, **k: calls.append("ft"))
    monkeypatch.setattr(gd, "gather_distance_plain",
                        lambda *a, **k: calls.append("gd"))
    monkeypatch.setattr(pq, "pq_adc_topr_plain",
                        lambda *a, **k: calls.append("topr"))
    monkeypatch.setattr(pq, "pq_adc_gather_plain",
                        lambda *a, **k: calls.append("pqg"))
    monkeypatch.setattr(eb, "embedding_bag_plain",
                        lambda *a, **k: calls.append("eb"))
    db, qs, progs = _kernel_args()
    before = dict(K.launch_counts)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ft.filtered_topk(*db, qs, progs, k=4)
    ids = torch.zeros((3, 5), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gd.gather_distance(*db, qs, ids, progs, torch.zeros(3))
    codes, luts = _pq_args()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pq.pq_adc_topr(codes, db[1], db[2], db[3], luts, progs, r=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pq.pq_adc_gather(codes, luts, ids)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eb.embedding_bag(db[0], ids)
    assert calls == [] and K.launch_counts == before


def test_wrappers_on_cpu_run_plain_version_without_counting():
    db, qs, progs = _kernel_args()
    before = dict(K.launch_counts)
    ids, dists = ft.filtered_topk(*db, qs, progs, k=4)
    assert ids.shape == (3, 4) and torch.isfinite(dists).all()
    nb = torch.tensor([[0, 5, -1]] * 3, dtype=torch.int32)
    d, td = gd.gather_distance(*db, qs, nb, progs, torch.zeros(3))
    assert torch.isinf(d[:, 2]).all() and td[:, :2].all()
    codes, luts = _pq_args()
    ids, adc = pq.pq_adc_topr(codes, db[1], db[2], db[3], luts, progs, r=4)
    assert ids.shape == (3, 4) and torch.isfinite(adc).all()
    d, td = pq.pq_adc_gather(codes, luts, nb, ints=db[2], floats=db[3],
                             programs=progs, dvec=torch.zeros(3))
    assert torch.isinf(d[:, 2]).all() and td[:, :2].all()
    out = eb.embedding_bag(db[0], nb, mode="mean")
    assert torch.equal(out[0], (db[0][0] + db[0][5]) / 2)
    assert K.launch_counts == before


def test_unported_options_raise():
    # the compressed routes, bucketing and the live index are ported: their
    # options construct and their entry points run
    from repro_torch.core import BatchSpec
    from repro_torch.core.batching import ShapeRegistry
    SearchOptions(use_pq=True, rerank=2)
    SearchOptions(graph_quant="pq", graph_rerank=2)
    BuildSpec(quant=QuantSpec())
    opts = SearchOptions(batch=BatchSpec(min_bucket=2, max_bucket=4))
    with pytest.raises(ValueError):
        SearchOptions(graph_quant="bogus")
    with pytest.raises(TypeError, match="BatchSpec"):
        SearchOptions(batch=object())
    vecs, attrs = _tiny()
    fi = FavorIndex.build(vecs, attrs, HnswParams(M=4, efc=16), device="cpu")
    ids = fi.upsert(vecs[:2] + 1e-3, attrs.ints[:2], attrs.floats[:2])
    assert ids.tolist() == [64, 65] and fi.delete([0, 65]) == 2
    assert fi.merge()["merged_slots"] == 2 and fi.index.n == 66
    from repro_torch.core.router import execute
    reg = ShapeRegistry()
    r = execute(fi.backend, vecs[:3], PF.TrueFilter(), opts, registry=reg)
    assert 0 not in r.ids and 65 not in r.ids and reg.compiled_shapes
    # the serving hooks are ported: scopes (ignored by a backend that is
    # not scope-aware), obs and defer run and return the same result
    from repro_torch.core.options import ObsSpec
    from repro_torch.core.router import PendingExecution
    from repro_torch.obs import Obs
    base = execute(fi.backend, vecs[:2], PF.TrueFilter(), SearchOptions())
    for kw in ({"scopes": np.array([1, 2])},
               {"obs": Obs(ObsSpec(trace_sample=1.0))}, {"defer": True}):
        r = execute(fi.backend, vecs[:2], PF.TrueFilter(), SearchOptions(),
                    **kw)
        if kw.get("defer"):
            assert isinstance(r, PendingExecution)
            r = r.finish()
        assert np.array_equal(r.ids, base.ids)

