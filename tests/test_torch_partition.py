"""Port parity, the partitioned dry run: ``repro_torch.launch.partition``
and the partitioned counts of ``launch.dryrun``, held to the JAX package's
lowering on the test mesh (2, 4) at the reduced configs.

The JAX side runs in one subprocess with 8 fake host devices (as
``tests/test_distributed.py`` runs its mesh), started at the module's first
test: ``repro.launch.dryrun._lower_compile`` and ``_cost_of`` on each case
and its ``memory_analysis``, written as JSON.  Its mesh is made with
``AxisType.Auto`` axes, which the JAX models' ``with_sharding_constraint``
needs.

Bars, by case:
  (a) a matmul with its contracting dimension on ``model`` and a
      column-then-row parallel pair (each output replicated): each
      collective kind's link bytes and the per-device FLOPs equal XLA's;
  (b) favor-anns ``serve_brute`` and ``serve_graph``: each kind's link
      bytes equal XLA's once the ids' width is accounted for (the port's
      cross as int64, the JAX package's as int32); counts where XLA's
      combiner did not merge two collectives into one;
  (c) gemma2-2b ``train_4k`` and gcn-cora ``ogb_products``: every kind of
      the JAX record is in the port's, and the total link bytes are within a
      factor of 2 (gcn-cora's equal).  DTensor's sharding propagation is
      not XLA's SPMD partitioner: where XLA all-reduces, DTensor may
      reduce-scatter and all-gather later (the same ring bytes), and it
      reshards with all-to-all where XLA moves data otherwise, so the port
      may name kinds XLA does not;
  (d) each partitioned cell's ``argument_size_in_bytes`` equals
      ``memory_analysis``' (the programs' ``imask`` is int64 in the port);
  (e) on a 1 x 1 mesh the partitioned count equals the unpartitioned one;
  (f) no process group outlives a count, a failed one included, and
      nothing lands off ``meta``;
  (g) ``report.collective_summary`` renders the same text as the JAX
      package's on the same records.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_spec  # noqa: E402
from repro_torch.launch import cells as PCells  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import mesh as PMesh  # noqa: E402
from repro_torch.launch import partition as PT  # noqa: E402
from repro_torch.models import module as pmodule  # noqa: E402
from repro_torch.roofline import report as preport  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CELLS = [("gemma2-2b", "train_4k"), ("gcn-cora", "ogb_products"),
         ("dlrm-rm2", "serve_p99"), ("fm", "retrieval_cand")]
FAVOR = [("favor-anns", "serve_brute"), ("favor-anns", "serve_graph")]
# (name, (x, w[, w2]) shapes, their specs): each output replicated
MATMULS = {
    "contract": ([(64, 1024), (1024, 256)],
                 [(None, "model"), ("model", None)]),
    "column_row": ([(64, 256), (256, 1024), (1024, 256)],
                   [(), (None, "model"), ("model", None)]),
}


def _config(arch: str):
    spec = get_spec(arch)
    if arch == "favor-anns":
        return dataclasses.replace(spec.reduced, batch=8)
    return spec.reduced


def _reference_run(out_path: str) -> None:
    """The JAX package's side, run in the subprocess."""
    import types

    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_spec as ref_spec
    from repro.launch import cells as JC
    from repro.launch import dryrun as JD
    from repro.roofline import analysis as RA

    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)

    def record(cell) -> dict:
        _, compiled, _, _ = JD._lower_compile(cell, mesh)
        flops, _, link, counts, by_op = JD._cost_of(compiled, 8)
        return {"flops": flops, "link": link, "counts": counts,
                "by_op": by_op, "memory": RA.memory_analysis_dict(compiled)}

    rep = NamedSharding(mesh, P())

    def chain(*ts):
        y = ts[0]
        for w in ts[1:]:
            y = y @ w
        return jax.lax.with_sharding_constraint(y, rep)

    out = {}
    for name, (shapes, specs) in MATMULS.items():
        out[name] = record(types.SimpleNamespace(
            step_fn=chain,
            in_shardings=tuple(NamedSharding(mesh, P(*s)) for s in specs),
            args=tuple(jax.ShapeDtypeStruct(s, jnp.float32)
                       for s in shapes)))
    for arch, shape in CELLS + FAVOR:
        spec = ref_spec(arch)
        cfg = spec.reduced
        if arch == "favor-anns":
            cfg = dataclasses.replace(cfg, batch=8)
        out[f"{arch}:{shape}"] = record(JC.BUILDERS[spec.family](
            dataclasses.replace(spec, config=cfg), spec.cell(shape), mesh))
    Path(out_path).write_text(json.dumps(out))


@pytest.fixture(scope="module", autouse=True)
def ref_run(tmp_path_factory):
    """Starts ``_reference_run`` in a subprocess at the module's first test
    (it overlaps the port's counts); calling the fixture's value waits for
    it and returns its records."""
    tmp = tmp_path_factory.mktemp("partition")
    out, log = tmp / "ref.json", tmp / "ref.log"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(ROOT / "src")
    code = ("import sys; sys.path.insert(0, sys.argv[2]); "
            "import test_torch_partition as t; t._reference_run(sys.argv[1])")
    with open(log, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-c", code, str(out), str(ROOT / "tests")],
            env=env, cwd=ROOT, stdout=fh, stderr=subprocess.STDOUT)
    box = {}

    def result() -> dict:
        if "r" not in box:
            rc = proc.wait(timeout=600)
            assert rc == 0, log.read_text()
            box["r"] = json.loads(out.read_text())
        return box["r"]

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def _builder(arch: str):
    spec = get_spec(arch)
    cfg = _config(arch)

    def build(arch_, shape, mesh):
        return PCells.BUILDERS[spec.family](
            dataclasses.replace(spec, config=cfg), spec.cell(shape), mesh)

    return build


@pytest.fixture(scope="module")
def port():
    """The port's records of every case on the test mesh (the favor-anns
    graph block on the CPU)."""
    recs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(D, "make_production_mesh",
                   lambda multi_pod=False: PMesh.make_test_mesh())
        for arch, shape in CELLS + FAVOR:
            rec = D.run_cell(arch, shape, False, builder=_builder(arch),
                             device="cpu")
            assert rec["ok"], rec.get("traceback")
            recs[f"{arch}:{shape}"] = rec
    return recs


def _chain_count(name: str) -> D.Count:
    shapes, specs = MATMULS[name]
    mesh = PMesh.make_test_mesh()

    def step(*ts):
        y = ts[0]
        for w in ts[1:]:
            y = y @ w
        return pmodule.constrain(y, mesh, None, None)

    args = tuple(torch.empty(s, device="meta") for s in shapes)
    return D.count(step, args, shardings=tuple(specs), mesh=mesh)


# ---------------------------------------------------------------------------
# (a) sharded matmuls
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(MATMULS))
def test_sharded_matmul_collectives_and_flops_equal_xla(ref_run, name):
    c = _chain_count(name)
    ref = ref_run()[name]
    assert c.cost.collectives == {"counts": ref["counts"],
                                  "by_op": ref["by_op"]}
    assert c.cost.coll_link_bytes == ref["link"]
    assert c.cost.flops == ref["flops"]


# ---------------------------------------------------------------------------
# (b) favor-anns' collectives
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", ["serve_brute", "serve_graph"])
def test_favor_collectives_equal_xla_with_int64_ids(ref_run, port, shape):
    """The merge's all-gathers move (B, k) f32 distances and (B, k) ids:
    XLA's carry int32 ids, the port's int64, so the port's all-gather bytes
    are XLA's times (4 + 8) / (4 + 4); the estimate's all-reduces (the
    graph step's) move the same f32 counts and size."""
    key = f"favor-anns:{shape}"
    ref, got = ref_run()[key], port[key]["roofline"]["collectives"]
    assert set(got["by_op"]) == set(ref["by_op"])
    assert got["by_op"]["all-gather"] == ref["by_op"]["all-gather"] * 12 / 8
    if shape == "serve_graph":
        assert got["by_op"]["all-reduce"] == ref["by_op"]["all-reduce"]
    for kind, n in ref["counts"].items():
        if n == got["counts"][kind] or (kind == "all-reduce" and n == 1):
            continue                      # XLA combined the two psums
        pytest.fail(f"{kind}: {got['counts'][kind]} against XLA's {n}")
    assert got["counts"]["all-gather"] == ref["counts"]["all-gather"] == 2


def test_serve_brute_link_bytes_are_the_analytic_merge(port):
    """One query block of 4 rows, k = 10, over a model axis of 4."""
    r = port["favor-anns:serve_brute"]["roofline"]
    k, q, g = _config("favor-anns").k, 4, 4
    assert r["coll_link_bytes"] == (g - 1) * q * k * (4 + 8)
    assert port["favor-anns:serve_brute"]["partition"] == (
        "partitioned (data=2, model=4): a single controller runs the "
        "program of each of the 8 mesh cells; per-device terms are the "
        "count / 8; collectives charged where data crosses mesh cells")


# ---------------------------------------------------------------------------
# (c) a train cell of each partitioned family
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,shape", CELLS[:2])
def test_train_cell_collectives_match_xla(ref_run, port, arch, shape):
    ref = ref_run()[f"{arch}:{shape}"]
    got = port[f"{arch}:{shape}"]["roofline"]
    assert set(ref["counts"]) <= set(got["collectives"]["counts"])
    assert set(got["collectives"]["counts"]) - set(ref["counts"]) <= {
        "reduce-scatter", "all-gather", "all-to-all"}
    assert 0.5 <= got["coll_link_bytes"] / ref["link"] <= 2.0
    if arch == "gcn-cora":
        # the edge psums: one scatter-add all-reduce a layer, each way
        assert got["collectives"] == {"counts": ref["counts"],
                                      "by_op": ref["by_op"]}


# ---------------------------------------------------------------------------
# (d) argument bytes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,shape", CELLS)
def test_argument_bytes_equal_memory_analysis(ref_run, port, arch, shape):
    """Per device, the local shards of the arguments the step reads (XLA
    drops one it never reads); each int64 ``imask`` leaf counts as the
    JAX package's uint32."""
    cell = _builder(arch)(arch, shape, PMesh.make_test_mesh())
    wide = 0

    def walk(a, s, key=""):
        nonlocal wide
        if isinstance(a, torch.Tensor):
            if key == "imask":
                wide += PT.local_nbytes(a, s, PMesh.make_test_mesh()) // 2
        elif isinstance(a, dict):
            for k, v in a.items():
                walk(v, s[k], k)
        elif isinstance(a, (tuple, list)):
            for v, x in zip(a, s):
                walk(v, x, key)

    walk(cell.args, cell.in_shardings)
    got = port[f"{arch}:{shape}"]["memory"]["argument_size_in_bytes"]
    assert got - wide == \
        ref_run()[f"{arch}:{shape}"]["memory"]["argument_size_in_bytes"]


# ---------------------------------------------------------------------------
# (e) one device: partitioned == unpartitioned
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,shape", [("gemma2-2b", "train_4k"),
                                        ("gcn-cora", "molecule"),
                                        ("wide-deep", "serve_p99")])
def test_one_device_partitioned_count_equals_unpartitioned(arch, shape):
    mesh = PMesh.make_test_mesh(1, 1)
    cell = _builder(arch)(arch, shape, mesh)
    plain = D.count(cell.step_fn, cell.args)
    cell = _builder(arch)(arch, shape, mesh)
    part = D.count(cell.step_fn, cell.args, shardings=cell.in_shardings,
                   mesh=mesh)
    assert part.cost == plain.cost
    assert part.cost.collectives == {"counts": {}, "by_op": {}}
    assert part.kernels == plain.kernels


# ---------------------------------------------------------------------------
# (f) nothing outlives a count
# ---------------------------------------------------------------------------
def test_no_group_or_host_tensor_outlives_a_count(port):
    assert not torch.distributed.is_initialized()
    for key, rec in port.items():
        if "off_meta_ops" in rec:
            assert D.off_meta_bytes(rec["off_meta_ops"]) == 0, key
            assert rec["off_meta_ops"] == {}, key
    mesh = PMesh.make_test_mesh()

    def broken(x):
        raise RuntimeError("inside the count")

    with pytest.raises(RuntimeError, match="inside the count"):
        D.count(broken, (torch.empty((8, 4), device="meta"),),
                shardings=(("data", "model"),), mesh=mesh)
    assert not torch.distributed.is_initialized()
    with PT.fake_group(mesh):
        with pytest.raises(RuntimeError, match="already initialised"):
            with PT.fake_group(mesh):
                pass
        assert torch.distributed.is_initialized()
    assert not torch.distributed.is_initialized()


def test_uneven_dimension_is_refused():
    mesh = PMesh.make_test_mesh()
    assert PT.local_shape((64, 12), ("data", "model"), mesh) == (32, 3)
    assert PT.local_shape((64, 12), (("data", "model"),), mesh) == (8, 12)
    with pytest.raises(ValueError, match="does not divide evenly"):
        PT.local_shape((6, 12), (("data", "model"),), mesh)

    def uneven(arch, shape, mesh):
        return PCells.Cell(arch, shape, lambda x: x * 2,
                           (torch.empty((6, 4), device="meta"),),
                           ((("data", "model"),),), 1.0)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(D, "make_production_mesh",
                   lambda multi_pod=False: PMesh.make_test_mesh())
        rec = D.run_cell("gemma2-2b", "train_4k", False, builder=uneven)
    # no fall back to the even division: the record is not ok
    assert not rec["ok"] and "roofline" not in rec
    assert "does not divide evenly" in rec["error"] and rec["traceback"]
    assert not torch.distributed.is_initialized()


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    names = ("pod", "data", "model")
    assert PT.placements((("pod", "data"), None, "model"), 3, names) == [
        Shard(0), Shard(0), Shard(2)]
    assert PT.placements((), 2, names) == [Replicate()] * 3
    with pytest.raises(ValueError, match="not an axis"):
        PT.placements(("expert",), 1, names)
    with pytest.raises(ValueError, match="twice"):
        PT.placements(("model", "model"), 2, names)


def test_constrain_redistributes_a_dtensor_and_keeps_the_rest():
    mesh = PMesh.make_test_mesh()
    x = torch.ones(4, 8)
    assert pmodule.constrain(x, None, "batch", "embed") is x
    assert pmodule.constrain(x, mesh, "batch", "embed") is x  # meta mesh
    from repro_torch.core.distributed import make_mesh
    with pytest.raises(NotImplementedError, match="one device"):
        pmodule.constrain(x, make_mesh((1, 1), device="cpu"), "batch")
    with PT.fake_group(mesh) as dmesh:
        t = PT.distribute(torch.empty((8, 16), device="meta"), (), dmesh,
                          mesh)
        y = pmodule.constrain(t, mesh, "batch", "mlp")
        assert tuple(y.placements) == tuple(PT.placements(
            ("data", "model"), 2, mesh.axis_names))
        assert y.to_local().shape == (4, 4)


# ---------------------------------------------------------------------------
# (g) the collective schedule
# ---------------------------------------------------------------------------
def test_collective_summary_matches_reference(port):
    from repro.roofline import report as rreport
    recs = [dict(r, mesh="16x16") for r in port.values()]
    recs.append({"arch": "z", "shape": "s", "mesh": "16x16", "ok": True,
                 "skipped": "why"})
    text = preport.collective_summary(recs, "16x16")
    assert text == rreport.collective_summary(recs, "16x16")
    assert "| gcn-cora | ogb_products | all-reduce:4 |" in text
    assert "all-gather:2" in text
