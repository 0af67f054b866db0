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
    files += sorted((ROOT / "examples").glob("*_torch.py"))
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
    # the serving stack's part B is ported: its specs construct and
    # validate, and the cache serves the same result
    from repro_torch.cache import CachingBackend
    from repro_torch.core import CacheSpec, FrontEndSpec, TenantSpec
    fe = FrontEndSpec(tenants={"a": TenantSpec(weight=2.0, rate_qps=10.0)},
                      parallel_steps=2)
    assert fe.tenant("a").weight == 2.0
    with pytest.raises(ValueError, match="semantic_threshold"):
        CacheSpec(semantic_threshold=-1.0)
    cb = CachingBackend(fi.backend, CacheSpec(ttl_s=5.0))
    for _ in range(2):
        r = execute(cb, vecs[:2], PF.TrueFilter(), SearchOptions(),
                    scopes=np.array([1, 2]))
        assert np.array_equal(r.ids, base.ids)
    assert cb.cache_stats()["semantic"]["hits"] == 2



# The JAX package's public names with no port counterpart of the same name,
# each with where it went or why it stays out ("module:name", the module's
# path under src/repro).
RENAMED = {
    "core/distributed.py:device_put_sharded_db":
        "core/distributed.py place_sharded_db: each mesh cell's slice on "
        "the cell's torch device",
    "core/filters.py:_Conj.copy":
        "none: the port's conjunctions are tuples, never changed in place",
    "core/filters.py:_Conj.feasible": "core/filters.py _feasible",
    "core/prefbf.py:INF": "core/search.py INF, the port's one +inf",
    "core/scoring.py:GRAPH_QUANT_KINDS": "core/options.py GRAPH_QUANT",
    "core/scoring.py:pairwise_dist":
        "folded into kernels/gather_distance/ops.py gather_distance_plain",
    "core/search.py:refresh_graph_arrays":
        "core/favor.py FavorIndex.bump_version: the graph arrays view the "
        "index's padded scan arrays, so the index re-uploads a bumped "
        "component's both",
    "kernels/__init__.py:default_interpret":
        "none: the tensors' device picks the kernel (CUDA) or its plain "
        "version (CPU)",
    "launch/cells.py:SDS": "launch/cells.py sds",
    "launch/cells.py:probe_depths":
        "none, by design: the count runs every layer (a Python loop, not a "
        "scan counted once), so it needs no depth probes",
    "launch/cells.py:build_probe_cell": "none, by design: as probe_depths",
    "roofline/hw.py:ICI_LINK_BW": "renamed: roofline/hw.py NVLINK_LINK_BW",
    "kernels/filtered_topk/kernel.py:filtered_topk_pallas":
        "csrc/filtered_topk.cu behind kernels/filtered_topk/ops.py",
    "kernels/filtered_topk/kernel.py:BIG": "kernels/_common.py BIG",
    "kernels/filtered_topk/ref.py:filtered_topk_ref":
        "kernels/filtered_topk/ops.py filtered_topk_plain",
    "kernels/filtered_topk/ref.py:BIG": "kernels/_common.py BIG",
    "kernels/gather_distance/kernel.py:gather_distance_pallas":
        "csrc/gather_distance.cu behind kernels/gather_distance/ops.py",
    "kernels/gather_distance/kernel.py:BIG": "kernels/_common.py BIG",
    "kernels/gather_distance/ref.py:gather_distance_ref":
        "kernels/gather_distance/ops.py gather_distance_plain",
    "kernels/gather_distance/ref.py:BIG": "kernels/_common.py BIG",
    "kernels/pq_adc/kernel.py:pq_adc_pallas":
        "csrc/pq_adc.cu pq_adc_topr behind kernels/pq_adc/ops.py",
    "kernels/pq_adc/kernel.py:pq_adc_gather_pallas":
        "csrc/pq_adc.cu pq_adc_gather behind kernels/pq_adc/ops.py",
    "kernels/pq_adc/ref.py:pq_adc_topr_ref":
        "kernels/pq_adc/ops.py pq_adc_topr_plain",
    "kernels/pq_adc/ref.py:pq_adc_gather_ref":
        "kernels/pq_adc/ops.py pq_adc_gather_plain",
    "kernels/pq_adc/ref.py:BIG": "kernels/_common.py BIG",
    "kernels/embedding_bag/kernel.py:embedding_bag_pallas":
        "csrc/embedding_bag.cu behind kernels/embedding_bag/ops.py",
    "kernels/embedding_bag/ref.py:embedding_bag_ref":
        "kernels/embedding_bag/ops.py embedding_bag_plain",
}


def _public_names(path: Path, attributes: bool) -> set:
    """Public top-level functions, classes and assigned names of a module,
    and its classes' public methods as ``Class.name`` (with
    ``attributes``, also the ``self.name`` its methods assign)."""
    if not path.exists():
        return set()
    out = set()

    def add(name, owner=None):
        if not name.startswith("_"):
            out.add(f"{owner}.{name}" if owner else name)

    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            add(node.name)
        if isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    add(sub.name, node.name)
                if attributes:
                    for n in ast.walk(sub):
                        if (isinstance(n, ast.Attribute)
                                and isinstance(n.ctx, ast.Store)
                                and isinstance(n.value, ast.Name)
                                and n.value.id == "self"):
                            add(n.attr, node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                for n in (t.elts if isinstance(t, ast.Tuple) else [t]):
                    if isinstance(n, ast.Name):
                        add(n.id)
    return out


def test_every_reference_name_has_a_counterpart():
    """Each public top-level or method name of the JAX package has a port
    counterpart of the same name in the same module, or an entry in
    RENAMED saying where it went or why it stays out (read with ``ast``:
    nothing is imported)."""
    ref_root, port_root = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"
    missing = []
    for ref in sorted(ref_root.rglob("*.py")):
        rel = ref.relative_to(ref_root)
        have = _public_names(port_root / rel, attributes=True)
        missing += [f"{rel.as_posix()}:{name}"
                    for name in sorted(_public_names(ref, attributes=False))
                    if name not in have]
    assert sorted(set(missing) - set(RENAMED)) == []
    # no stale entry: each still names a reference name the port lacks
    assert sorted(set(RENAMED) - set(missing)) == []
