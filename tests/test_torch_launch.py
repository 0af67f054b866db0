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
gives a useful-FLOP fraction in (0, 1]."""
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
    ref = {(a, s): skip for a, s, skip in RCells.all_cells()}
    got = {(a, s): skip for a, s, skip in PCells.all_cells()}
    assert ref.keys() == got.keys()
    for key, skip in got.items():
        assert skip == (ref[key] or PCells.META_SKIP.get(key))
    assert set(PCells.META_SKIP) == {("favor-anns", "serve_graph")}
    with pytest.raises(ValueError, match="cell skipped"):
        PCells.build_cell("favor-anns", "serve_graph",
                          PMesh.make_production_mesh())


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
    remat -- on meta tensors: nothing but meta tensors written, every FLOP
    counted once."""
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
    assert r["coll_link_bytes"] == 0.0 and r["collectives"]["counts"] == {}
    assert r["t_compute_s"] > 0 and r["t_memory_s"] > 0
    assert "no collectives" in rec["partition"]
    assert rec["memory"]["argument_size_in_bytes"] > 0


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
    monkeypatch.setattr("sys.argv", ["dryrun", "--arch", "favor-anns",
                                     "--shape", "serve_graph", "--mesh",
                                     "multi", "--out", str(out)])
    D.main()
    recs = json.loads(out.read_text())
    assert [r["ok"] for r in recs] == [True, True]
    assert recs[1]["skipped"] == PCells.META_SKIP[("favor-anns",
                                                   "serve_graph")]
    assert "| gcn-cora | molecule |" in report.table(recs, "16x16")
    assert "[SKIP] favor-anns x serve_graph" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["gcn_bf16", "gcn_bf16_prune", "gcn_bf16_v2",
                                  "olmoe_cf10", "favor_sample4k",
                                  "favor_ccap256", "favor_n16m"])
def test_perf_experiments_run(name, tmp_path, monkeypatch):
    """The perf table's variants through the dry run (the graph-route ones
    recorded as skipped), with the JAX package's hypotheses."""
    from repro.launch import perf_run as rperf_run
    assert perf_run.EXPERIMENTS[name]["hypothesis"] == \
        rperf_run.EXPERIMENTS[name]["hypothesis"]
    assert perf_run.EXPERIMENTS.keys() == rperf_run.EXPERIMENTS.keys()
    out = tmp_path / "perf.json"
    monkeypatch.setattr("sys.argv", ["perf_run", "--exp", name, "--out",
                                     str(out)])
    perf_run.main()
    rec = json.loads(out.read_text())[0]
    assert rec["ok"], rec.get("traceback")
    if name.startswith("favor"):
        assert rec["skipped"]
    else:
        assert rec["roofline"]["flops_per_dev"] > 0


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
