"""Port parity, launch: ``repro_torch.launch`` (mesh, cells, the meta dry
run, the perf variants) and the two helpers only it reads,
``models.module.logical_to_sharding`` / ``spec_tree`` and
``core.distributed.input_specs``.

Every cell the port's dry run can run is built on a 1 x 1 mesh in process
by both packages: its ``model_flops`` are equal, each argument's shape and
dtype equal the JAX ``ShapeDtypeStruct``'s (the programs' ``imask`` is
int64 in the port, holding the uint32 bitmasks, as its programs do on a
device), and every sharding tuple equals the JAX ``PartitionSpec``.  The
dry run of a reduced LM train cell writes nothing but ``meta`` tensors and
gives a useful-FLOP fraction in (0, 1].  favor-anns' ``serve_graph`` cell
and its three perf variants are counted on one mesh cell's real tensors,
here on the CPU at a reduced config (n 4096, dim 16, batch 8, the test
mesh (2, 4)); each kernel wrapper charges a count its analytic work."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

import repro.configs as RC  # noqa: E402
import repro.models.module as rmodule  # noqa: E402
from repro.core import distributed as rdist  # noqa: E402
from repro.launch import cells as RCells  # noqa: E402
from repro.launch import mesh as RMesh  # noqa: E402
from repro_torch.configs import get_spec  # noqa: E402
from repro_torch.core import distributed as pdist  # noqa: E402
from repro_torch.launch import cells as PCells  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import mesh as PMesh  # noqa: E402
from repro_torch.launch import perf as P  # noqa: E402
from repro_torch.launch import perf_run  # noqa: E402
from repro_torch.models import module as pmodule  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.roofline import report  # noqa: E402

CELLS = [(a, s) for a, s, skip in PCells.all_cells() if not skip]
# the port's program masks: the uint32 bitmasks held in int64
DTYPE_MAP = {("imask", "uint32"): "int64"}


@pytest.fixture(scope="module")
def meshes():
    return (jax.make_mesh((1, 1), ("data", "model")),
            pdist.make_mesh((1, 1), device="meta"))


def _shapes(tree, path=""):
    """{path: (shape, dtype name)} over dicts, tuples and leaves."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{path}/{k}"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_shapes(v, f"{path}/{i}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {path: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}
    name = np.dtype(tree.dtype).name
    return {path: (tuple(tree.shape),
                   DTYPE_MAP.get((path.rsplit("/", 1)[-1], name), name))}


def _same_specs(ref, port, path=""):
    if ref is None:
        assert port is None, path
    elif isinstance(ref, NamedSharding):
        assert port == tuple(ref.spec), f"{path}: {port} != {ref.spec}"
    elif isinstance(ref, dict):
        assert ref.keys() == port.keys(), path
        for k in ref:
            _same_specs(ref[k], port[k], f"{path}/{k}")
    else:
        assert len(ref) == len(port), path
        for i, (r, p) in enumerate(zip(ref, port)):
            _same_specs(r, p, f"{path}/{i}")


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in
                                                  CELLS])
def test_cell_matches_reference(arch, shape, meshes):
    jmesh, pmesh = meshes
    ref = RCells.build_cell(arch, shape, jmesh)
    got = PCells.build_cell(arch, shape, pmesh)
    assert got.model_flops == ref.model_flops
    assert (got.arch, got.shape, got.note, got.donate) == \
        (ref.arch, ref.shape, ref.note, ref.donate)
    assert _shapes(got.args) == _shapes(ref.args)
    _same_specs(ref.in_shardings, got.in_shardings)
    assert all(t.device.type == "meta" for t in D._tensors(got.args))


def test_skipped_cells_are_the_registry_s_and_the_meta_run_s():
    """The registry's skips only: the meta run skips none, favor-anns'
    ``serve_graph`` is counted on a block of real tensors instead."""
    ref = {(a, s): skip for a, s, skip in RCells.all_cells()}
    got = {(a, s): skip for a, s, skip in PCells.all_cells()}
    assert ref == got
    assert not hasattr(PCells, "META_SKIP")
    cell = PCells.build_cell("favor-anns", "serve_graph",
                             PMesh.make_production_mesh())
    assert cell.block is not None
    assert PCells.build_cell("favor-anns", "serve_brute",
                             PMesh.make_production_mesh()).block is None
    skipped = next((a, s) for a, s, skip in PCells.all_cells() if skip)
    with pytest.raises(ValueError, match="cell skipped"):
        PCells.build_cell(*skipped, PMesh.make_production_mesh())


def test_spec_tree_matches_reference(meshes):
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    axes = {"a": ("batch", "embed"), "b": {"c": ("vocab", None),
                                           "d": ("layers", "heads", None)},
            "e": ()}
    rules = {"embed": ("pod", "model"), "heads": None}
    for r in (None, rules):
        ref = rmodule.spec_tree(axes, jmesh, r)
        got = pmodule.spec_tree(axes, meshes[1], r)
        assert jax.tree.map(tuple, ref, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec)) == got
        sh = rmodule.logical_to_sharding(axes, jmesh, r)
        _same_specs(sh, pmodule.logical_to_sharding(axes, meshes[1], r))


def test_input_specs_match_reference():
    kw = dict(m0=32, m=16, n_upper=3, width=8, batch=64, sample_rate=0.01)
    ref = rdist.input_specs(4096, 16, 2, 1, 4, **kw)
    got = pdist.input_specs(4096, 16, 2, 1, 4, **kw)
    assert _shapes(got) == _shapes(ref)
    assert all(t.device.type == "meta" for t in D._tensors(got))


def test_meshes_touch_no_device():
    for multi in (False, True):
        m = PMesh.make_production_mesh(multi_pod=multi)
        assert m.devices.shape == ((2, 16, 16) if multi else (16, 16))
        assert m.axis_names == (("pod", "data", "model") if multi else
                                ("data", "model"))
        assert {d.type for d in m.devices.flat} == {"meta"}
    t = PMesh.make_test_mesh()
    assert t.devices.shape == (2, 4)
    for b in (1, 2, 4, 6, 32, 256):
        assert PMesh.batch_axes(b, PMesh.make_production_mesh(
            multi_pod=True)) == RMesh.batch_axes(b, _FakeMesh((2, 16, 16)))


class _FakeMesh:
    axis_names = ("pod", "data", "model")

    def __init__(self, shape):
        self.devices = np.empty(shape)


@pytest.mark.parametrize("remat", [False, True])
def test_dryrun_reduced_lm_train_cell(remat):
    """The whole step -- forward, backward, AdamW update, with and without
    remat -- partitioned on the production mesh, on meta tensors: nothing
    but meta tensors written, every FLOP counted once, the collectives and
    temporaries of one device's program, and no process group left."""
    def builder(arch, shape, mesh):
        spec = get_spec(arch)
        cfg = dataclasses.replace(spec.reduced, remat=remat)
        return PCells.build_lm_cell(dataclasses.replace(spec, config=cfg),
                                    spec.cell(shape), mesh)

    rec = D.run_cell("gemma2-2b", "train_4k", False, builder=builder)
    assert rec["ok"], rec.get("traceback")
    assert rec["off_meta_ops"] == {}
    assert D.off_meta_bytes(rec["off_meta_ops"]) == 0
    r = rec["roofline"]
    assert 0.0 < r["useful_flops_frac"] <= 1.0
    assert rec["partition"] == ("partitioned (data=16, model=16): DTensor, "
                                "fake group of 256")
    assert r["coll_link_bytes"] > 0 and r["t_collective_s"] > 0
    assert r["coll_link_bytes"] == sum(r["collectives"]["by_op"].values())
    assert "all-reduce" in r["collectives"]["counts"]
    assert r["t_compute_s"] > 0 and r["t_memory_s"] > 0
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["memory"]["temp_size_in_bytes"] > 0
    assert not torch.distributed.is_initialized()


def test_dryrun_counts_match_the_shapes():
    """One matmul's FLOPs and bytes, counted on meta tensors."""
    a = torch.empty((64, 32), device="meta")
    b = torch.empty((32, 16), device="meta")
    cost, off_meta = D.count_step(lambda x, y: x @ y, (a, b))
    assert cost.flops == 2 * 64 * 32 * 16
    assert cost.bytes_accessed == 4 * (64 * 32 + 32 * 16 + 64 * 16)
    assert cost.argument_bytes == 4 * (64 * 32 + 32 * 16)
    assert cost.output_bytes == 4 * 64 * 16
    assert off_meta == {}
    _, host = D.count_step(lambda x: (x @ x.t(), torch.zeros(2, 5)), (a,))
    assert host == {"cpu": [{"op": "aten.zeros.default", "shape": [2, 5],
                             "dtype": "torch.float32", "bytes": 40,
                             "at": host["cpu"][0]["at"], "count": 1}]}
    assert D.off_meta_bytes(host) == 40
    view_only, _ = D.count_step(lambda x: x.view(-1)[:8].t(), (a,))
    assert view_only.bytes_accessed == 0


def test_dryrun_cli_and_report(tmp_path, monkeypatch, capsys):
    out = tmp_path / "dry.json"
    monkeypatch.setattr("sys.argv", ["dryrun", "--arch", "gcn-cora", "--shape",
                                     "molecule", "--mesh", "single", "--out",
                                     str(out)])
    D.main()
    # serve_graph runs on the card by default: without one its record is
    # not ok and carries the device error (no fall back to the CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["dryrun", "--arch", "favor-anns",
                                     "--shape", "serve_graph", "--mesh",
                                     "multi", "--out", str(out)])
    D.main()
    recs = json.loads(out.read_text())
    assert [r["ok"] for r in recs] == [True, False]
    assert "no CUDA device" in recs[1]["error"]
    assert "| gcn-cora | molecule |" in report.table(recs, "16x16")
    assert "| favor-anns | serve_graph | FAIL |" in report.table(recs,
                                                               "2x16x16")
    assert "FAIL RuntimeError: no CUDA device" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["gcn_bf16", "gcn_bf16_prune", "gcn_bf16_v2",
                                  "olmoe_cf10", "favor_sample4k",
                                  "favor_ccap256", "favor_n16m"])
def test_perf_experiments_run(name, tmp_path, monkeypatch):
    """The perf table's variants through the dry run, with the JAX
    package's hypotheses; the favor-anns ones on the CPU at the reduced
    config, their DB size lever scaled with it (64M rows -> 4096)."""
    from repro.launch import perf_run as rperf_run
    assert perf_run.EXPERIMENTS[name]["hypothesis"] == \
        rperf_run.EXPERIMENTS[name]["hypothesis"]
    assert perf_run.EXPERIMENTS.keys() == rperf_run.EXPERIMENTS.keys()
    out = tmp_path / "perf.json"
    argv = ["perf_run", "--exp", name, "--out", str(out)]
    if name.startswith("favor"):
        full, variant = get_spec("favor-anns").config.n, P.favor_variant
        _reduced_favor(monkeypatch)
        monkeypatch.setattr(P, "favor_variant", lambda *a, n=0, **kw: variant(
            *a, n=n * RED.n // full, **kw))
        argv += ["--device", "cpu"]
    monkeypatch.setattr("sys.argv", argv)
    perf_run.main()
    rec = json.loads(out.read_text())[0]
    assert rec["ok"], rec.get("traceback")
    assert rec["roofline"]["flops_per_dev"] > 0
    if name.startswith("favor"):
        assert rec["block"]["waves"] > 0
        assert rec["count"]["kernels"]["gather_distance"]["calls"] > 0
        assert rec["block"]["rows"] == (256 if name == "favor_n16m"
                                        else 1024)


def test_gnn_loss_opt_matches_gcn_loss():
    """Without bf16 and pruning the variant's loss is ``gcn_loss``'s."""
    from repro_torch.data import synthetic
    from repro_torch.models import gnn
    cfg = get_spec("gcn-cora").reduced
    g = synthetic.make_random_graph(120, 400, cfg.d_feat, cfg.n_classes,
                                    seed=0)
    params, _ = pmodule.init_with_axes(gnn.init_gcn, 0, cfg, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in g.items()}
    ref, _ = gnn.gcn_loss(params, cfg, batch["x"], batch["edges"],
                          batch["deg"], batch["labels"], batch["mask"])
    got, _ = P.gnn_loss_opt(params, cfg, batch, bf16_msgs=False, n_labeled=0)
    assert float(got) == float(ref)
    bf, _ = P.gnn_loss_opt(params, cfg, batch, bf16_msgs=True, n_labeled=0,
                           bf16_end2end=True)
    assert abs(float(bf) - float(ref)) < 0.05


def test_remat_and_window_list_do_not_change_the_forward():
    cfg = get_spec("gemma2-2b").reduced
    params, _ = pmodule.init_with_axes(PT.init_lm, 0, cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 12))
    a, _ = PT.forward_train(params, cfg, toks)
    with torch.enable_grad():
        b, _ = PT.forward_train(params, dataclasses.replace(cfg, remat=True),
                                toks)
    assert torch.equal(a, b)
    assert cfg.windows().tolist() == cfg.window_list() == \
        np.asarray(RC.get_spec("gemma2-2b").reduced.windows()).tolist()


# ---------------------------------------------------------------------------
# favor-anns' serve_graph cell, counted on one mesh cell's real tensors
# ---------------------------------------------------------------------------
RED = dataclasses.replace(get_spec("favor-anns").reduced, batch=8)


def _reduced_favor(mp):
    """favor-anns at RED (n 4096, dim 16, batch 8, ef 48) on the test mesh
    (2, 4): a serve_graph block of 1024 rows x 4 queries."""
    spec = dataclasses.replace(get_spec("favor-anns"), config=RED)
    real = get_spec

    def patched(arch):
        return spec if arch == "favor-anns" else real(arch)

    mp.setattr(P, "get_spec", patched)
    mp.setattr(PCells, "get_spec", patched)
    mp.setattr(D, "make_production_mesh",
               lambda multi_pod=False: PMesh.make_test_mesh())


def _graph_record(mp, **lever):
    _reduced_favor(mp)
    builder = P.favor_variant("favor-anns", "serve_graph", **lever)
    return D.run_cell("favor-anns", "serve_graph", False, builder=builder,
                      device="cpu")


@pytest.fixture(scope="module")
def graph_records():
    """The cell and two of its levers, counted once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        _reduced_favor(mp)
        recs = {"cell": D.run_cell("favor-anns", "serve_graph", False,
                                   device="cpu")}
        for name, lever in (("sample", dict(sample_rate=0.001)),
                            ("ccap", dict(sample_rate=0.001, cand_cap=256))):
            recs[name] = _graph_record(mp, **lever)
    for rec in recs.values():
        assert rec["ok"], rec.get("traceback")
    return recs


def test_serve_graph_cell_counts_one_block_on_real_tensors(graph_records):
    rec = graph_records["cell"]
    assert rec["partition"].startswith("partitioned (data=2, model=4): one "
                                       "mesh cell counted on real tensors, "
                                       "the per-device program of one of "
                                       "the 8 blocks")
    b = rec["block"]
    assert (b["rows"], b["queries"], b["sample_rows"]) == (1024, 4, 10)
    assert b["device"] == "cpu" and b["peak_memory_bytes"] is None
    assert 0 < b["waves"] < b["max_steps"] == 8 * RED.ef
    assert not b["hit_max_steps"]
    assert b["p_hat"] >= 0.01                    # the estimate's graph route
    assert b["model_flops"] == 4 * 4.0 * RED.ef * RED.m0 * 2.0 * RED.dim
    r = rec["roofline"]
    assert r["t_compute_s"] > 0 and r["t_memory_s"] > 0
    assert r["bottleneck"] == "memory"
    # the estimate's all-reduces of the (4,) f32 counts and the f32 size and
    # the merge's all-gathers of the (4, k) f32 distances and int64 ids, over
    # the model axis of 4
    g, q, k = 4, 4, RED.k
    want = {"all-reduce": 2 * (g - 1) / g * (4 * q + 4),
            "all-gather": (g - 1) * q * k * (4 + 8)}
    assert r["collectives"] == {"counts": {"all-reduce": 2, "all-gather": 2},
                                "by_op": want}
    assert r["coll_link_bytes"] == sum(want.values())
    kern = rec["count"]["kernels"]
    assert set(kern) == {"gather_distance"}
    assert kern["gather_distance"]["calls"] > b["waves"]
    assert r["flops_per_dev"] == kern["gather_distance"]["flops"]
    parts = rec["count"]["parts"]
    assert {"estimate", "descent", "wave", "visited", "pools",
            "traversal", "shard merge"} <= set(parts)
    assert sum(parts.values()) + kern["gather_distance"]["bytes"] == \
        r["hbm_bytes_per_dev"]
    assert "random graph" in rec["note"]
    json.dumps(rec)


def test_counted_block_gives_the_uncounted_results(monkeypatch):
    """The count changes nothing the step computes, and a block made again
    from the same seed counts the same."""
    _reduced_favor(monkeypatch)
    cell = PCells.build_cell("favor-anns", "serve_graph",
                             PMesh.make_test_mesh())
    fields, c, block = D.count_block(cell, "cpu", seed=3)
    ids, dists = block.step_fn(*block.args)
    assert torch.equal(c.out[0], ids) and torch.equal(c.out[1], dists)
    assert ids.shape == (4, RED.k) and bool((ids >= 0).all())
    again, c2, _ = D.count_block(cell, "cpu", seed=3)
    assert c2.cost == c.cost and c2.kernels == c.kernels
    assert again["block"]["waves"] == fields["block"]["waves"]


def test_gather_bytes_equal_the_analytic_sum_over_the_waves(monkeypatch):
    """The gathers' counted FLOPs and bytes are the analytic sum over the
    calls the traversal made: one a wave, one for the entry point, and the
    descent's; each reads its valid ids' rows, norms and attributes, the
    ids, queries, programs and D, and writes dbar and the TD byte."""
    import sys

    from repro_torch.kernels.gather_distance import ops as gd
    calls = []
    plain = gd.gather_distance_plain

    def recording(vectors, norms, ints, floats, queries, nbr_ids, programs,
                  dvec, **kw):
        f, descent = sys._getframe(1), False
        while f is not None and not descent:
            descent = f.f_code.co_name == "_descend"
            f = f.f_back
        calls.append((descent, nbr_ids.clone(), queries.shape,
                      ints.shape[1] + floats.shape[1],
                      sum(v.numel() * v.element_size()
                          for v in programs.values())))
        return plain(vectors, norms, ints, floats, queries, nbr_ids,
                     programs, dvec, **kw)

    monkeypatch.setattr(gd, "gather_distance_plain", recording)
    rec = _graph_record(monkeypatch)
    assert rec["ok"], rec.get("traceback")
    want_bytes = want_flops = 0
    for _, ids, (b, d), attrs, prog in calls:
        n = int((ids >= 0).sum())
        want_bytes += (ids.numel() * ids.element_size() + b * d * 4 + b * 4
                       + prog + ids.numel() * 5 + n * 4 * (d + 1 + attrs))
        want_flops += 2 * n * d
    k = rec["count"]["kernels"]["gather_distance"]
    assert k == {"calls": len(calls), "flops": float(want_flops),
                 "bytes": float(want_bytes)}
    assert sum(not descent for descent, *_ in calls) == \
        rec["block"]["waves"] + 1


def test_favor_variant_levers(graph_records, monkeypatch):
    """Each lever moves its part: a 0.1 % sample shrinks the estimate's
    bytes, a 256-wide candidate pool grows the pools' bytes a wave, and the
    DB size scales the visited bitmap's (B x N/32 words) a wave, at sizes
    where the bitmap outweighs the in-block dedup (B x M x M)."""
    cell, sample, ccap = (graph_records[k] for k in ("cell", "sample",
                                                      "ccap"))
    assert sample["note"].startswith("sample_rate=0.001 ccap=0 b=0")
    assert ccap["note"].startswith("sample_rate=0.001 ccap=256 b=0")
    assert sample["block"]["sample_rows"] < cell["block"]["sample_rows"]
    assert sample["count"]["parts"]["estimate"] < \
        cell["count"]["parts"]["estimate"]
    assert ccap["block"]["cand_cap"] == 256

    def per_wave(rec, part):
        return rec["count"]["parts"][part] / rec["block"]["waves"]

    assert per_wave(ccap, "pools") > per_wave(sample, "pools")
    small, large = (_graph_record(monkeypatch, n=n)
                    for n in (RED.n * 64, RED.n * 256))
    assert (small["block"]["rows"], large["block"]["rows"]) == (65536,
                                                                262144)
    assert per_wave(large, "visited") > 3 * per_wave(small, "visited")


@pytest.mark.parametrize("name", ["filtered_topk", "gather_distance",
                                  "pq_adc_topr", "pq_adc_gather",
                                  "embedding_bag"])
def test_kernel_wrappers_charge_their_analytic_work(name):
    """Under a count each wrapper charges its analytic work and hides its
    own torch ops (here the plain version's), and returns what it returns
    uncounted; filtered_topk charges the same on meta tensors."""
    from repro_torch.core.router import compile_programs
    from repro_torch.core import filters as PF
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.kernels.filtered_topk import ops as ft
    from repro_torch.kernels.gather_distance import ops as gd
    from repro_torch.kernels.pq_adc import ops as pq
    g = torch.Generator().manual_seed(0)
    n, d, b = 64, 8, 3
    vecs = torch.randn((n, d), generator=g)
    norms = (vecs * vecs).sum(dim=1)
    ints = torch.randint(0, 3, (n, 2), generator=g, dtype=torch.int32)
    floats = 100.0 * torch.rand((n, 1), generator=g)
    qs = torch.randn((b, d), generator=g)
    progs = compile_programs(PF.Equality("i0", 1), PF.paper_schema(), b,
                             device="cpu")
    ids = torch.randint(-1, n, (b, 5), generator=g)
    dvec = torch.ones((b,))
    codes = torch.randint(0, 16, (n, 4), generator=g, dtype=torch.uint8)
    luts = torch.rand((b, 4, 16), generator=g)
    calls = {
        "filtered_topk": (ft.filtered_topk, ft.filtered_topk_work,
                          (vecs, norms, ints, floats, qs, progs), {"k": 4}),
        "gather_distance": (gd.gather_distance, gd.gather_distance_work,
                            (vecs, norms, ints, floats, qs, ids, progs,
                             dvec), {}),
        "pq_adc_topr": (pq.pq_adc_topr, pq.pq_adc_topr_work,
                        (codes, norms, ints, floats, luts, progs), {"r": 6}),
        "pq_adc_gather": (pq.pq_adc_gather, pq.pq_adc_gather_work,
                          (codes, luts, ids), {"ints": ints,
                                               "floats": floats,
                                               "programs": progs,
                                               "dvec": dvec}),
        "embedding_bag": (eb.embedding_bag, eb.embedding_bag_work,
                          (torch.randn((20, 6), generator=g),
                           torch.randint(-1, 20, (b, 4), generator=g,
                                         dtype=torch.int32)), {}),
    }
    fn, work, args, kw = calls[name]
    flops, nbytes = work(*args, **kw)
    assert flops > 0 and nbytes > 0
    c = D.count(lambda *a: fn(*a, **kw), args, meta=False)
    assert c.kernels == {name: {"calls": 1, "flops": float(flops),
                                "bytes": float(nbytes)}}
    assert (c.cost.flops, c.cost.bytes_accessed) == (flops, nbytes)
    want = fn(*args, **kw)
    got = c.out if isinstance(c.out, tuple) else (c.out,)
    want = want if isinstance(want, tuple) else (want,)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    if name == "filtered_topk":
        margs = [a.to("meta") if isinstance(a, torch.Tensor) else
                 {k: v.to("meta") for k, v in a.items()} for a in args]
        cm = D.count(lambda *a: fn(*a, **kw), margs)
        assert cm.kernels == c.kernels and cm.off_meta == {}


def test_meta_serve_brute_charges_filtered_topk(monkeypatch):
    """The meta serve_brute cell -- here through ``favor_variant``'s batch
    lever -- counts filtered_topk's analytic work, one call per mesh cell,
    not its plain version's ops."""
    _reduced_favor(monkeypatch)
    builder = P.favor_variant("favor-anns", "serve_brute", batch=16)
    rec = D.run_cell("favor-anns", "serve_brute", False, builder=builder)
    assert rec["ok"], rec.get("traceback")
    assert rec["note"] == "sample_rate=0.01 ccap=0 b=16" and "block" not in rec
    k = rec["count"]["kernels"]["filtered_topk"]
    rows, q = RED.n // 4, 16 // 2
    assert k["calls"] == 8
    assert k["flops"] == 8 * 2.0 * q * rows * RED.dim
    assert rec["roofline"]["flops_per_dev"] == k["flops"] / 8
    assert rec["off_meta_ops"] == {}
