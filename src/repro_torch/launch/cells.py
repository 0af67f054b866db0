"""Dry-run cell builders: for every (architecture x shape) cell produce
(step_fn, example args as ``meta`` tensors, in_shardings, model_flops), as
the JAX package's do.

Building a cell allocates nothing: parameters come from the init functions
on the ``meta`` device (``models.module.Ctx`` draws nothing there), the
optimizer state and the inputs are ``meta`` tensors of the JAX package's
shapes and dtypes, and the shardings are the port's partition specs
(``models.module.logical_to_sharding``: a tuple of mesh axes per
dimension, as a ``PartitionSpec`` reads).  ``dryrun.py`` runs each step
once over them and counts it: partitioned, as DTensors of those specs on a
fake process group of the mesh's device count (``partition.py``).  The
LM functions get the mesh, as the JAX package's do, so their ``constrain``
calls redistribute the activations.  favor-anns' cells are the JAX
package's ``shard_map`` steps: one program per mesh cell, run by the single
controller (``core.distributed.make_serve_fns``), with their per-cell specs
in ``Cell.shard_specs``.

One cell is counted on real tensors instead: favor-anns' ``serve_graph``,
whose route reads device values to steer its Python loops (the descent's
``moved.any()``, each wave's count of active queries, lane compaction),
which ``meta`` tensors cannot answer.  Its ``Cell.block`` makes one mesh
cell's block -- the per-device program -- on a device, from synthetic data
(``favor_graph_block``); only then is anything allocated.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..configs import get_spec
from ..configs.base import ArchSpec, ShapeCell
from ..models import gnn, recsys
from ..models.module import init_with_axes, logical_to_sharding
from ..models.transformer import (LMConfig, decode_step, init_lm, lm_loss,
                                  make_cache_specs, prefill)
from ..training import optimizer as opt
from ..training.step import make_train_step
from .mesh import batch_axes

F32, BF16, I32 = torch.float32, torch.bfloat16, torch.int32


def sds(shape, dtype) -> torch.Tensor:
    """A shape stand-in (the JAX package's ``ShapeDtypeStruct``)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


@dataclass
class Cell:
    arch: str
    shape: str
    step_fn: object          # callable run once by the dry run
    args: tuple              # meta tensors (trees)
    in_shardings: tuple      # partition-spec tuples (trees), or None
    model_flops: float
    note: str = ""
    donate: tuple = ()
    # a cell counted on real tensors: block(device, seed, data_device=None)
    # -> Block, one mesh cell's per-device program (``dryrun.count_block``)
    block: object = None
    # a single controller's cell (in_shardings None): each argument's and
    # each output's per-cell spec, the JAX package's shard_map in_specs
    # and out_specs
    shard_specs: tuple = None
    out_specs: tuple = None


@dataclass
class Block:
    """One mesh cell's block of a cell counted on real tensors: its step
    (the per-device program), its arguments on the device, what its record
    states (``info``: rows, queries, ``model_flops`` of the block, ...),
    and ``facts()`` -> what the record reads after the step ran (waves)."""
    step_fn: object
    args: tuple
    info: dict
    facts: object


def _mesh_axis_size(mesh, name: str) -> int:
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    return sizes.get(name, 1)


def _repl(tree):
    return opt.tree_map(lambda _: (), tree)


def _eval_init(init_fn, cfg, dtype):
    return init_with_axes(init_fn, 0, cfg, dtype=dtype, device="meta")


def _opt_sds(params_sds):
    return opt.OptState(step=sds((), I32),
                        mu=opt.tree_map(lambda p: sds(p.shape, F32),
                                        params_sds),
                        nu=opt.tree_map(lambda p: sds(p.shape, F32),
                                        params_sds))


def _opt_shardings(param_sh):
    return opt.OptState(step=(), mu=param_sh, nu=param_sh)


def _bspec(bax: tuple) -> tuple:
    """The batch dimension's spec entry as ``P(bax)`` / ``P(bax[0])`` /
    ``P()`` give it."""
    if not bax:
        return ()
    return (bax,) if len(bax) != 1 else (bax[0],)


def _one(bax: tuple):
    return bax if len(bax) > 1 else (bax[0] if bax else None)


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------
def _lm_rules(cfg: LMConfig, mesh) -> dict:
    model = _mesh_axis_size(mesh, "model")
    rules = {}
    if cfg.n_kv % model == 0 and cfg.n_kv >= model:
        rules["kv_heads"] = "model"
    if cfg.n_heads % model:
        rules["heads"] = None
    return rules


def build_lm_cell(spec: ArchSpec, cell: ShapeCell, mesh) -> Cell:
    cfg: LMConfig = spec.config
    dtype = BF16 if cfg.param_dtype == "bfloat16" else F32
    params_sds, axes = _eval_init(init_lm, cfg, dtype)
    rules = _lm_rules(cfg, mesh)
    param_sh = logical_to_sharding(axes, mesh, rules)
    b = cell.meta["batch"]
    s = cell.meta["seq"]
    bax = batch_axes(b, mesh)
    bspec = _bspec(bax)

    if cell.kind == "train":
        ocfg = opt.OptConfig(total_steps=10000)

        def loss_fn(p, batch):
            return lm_loss(p, cfg, batch["tokens"], batch["labels"], mesh)

        step = make_train_step(loss_fn, ocfg)
        batch_sds = {"tokens": sds((b, s), I32), "labels": sds((b, s), I32)}
        bsh = {k: bspec + (None,) for k in batch_sds}
        args = (params_sds, _opt_sds(params_sds), batch_sds)
        shard = (param_sh, _opt_shardings(param_sh), bsh)
        mf = 6.0 * cfg.active_param_count() * b * s
        return Cell(spec.arch_id, cell.name, step, args, shard, mf,
                    donate=(0, 1))

    if cell.kind == "prefill":
        def step(p, tokens):
            return prefill(p, cfg, tokens, s, mesh)
        tok_sds = sds((b, s), I32)
        mf = 2.0 * cfg.active_param_count() * b * s
        return Cell(spec.arch_id, cell.name, step, (params_sds, tok_sds),
                    (param_sh, bspec + (None,)), mf)

    # decode: one new token against a seq-long cache
    model = _mesh_axis_size(mesh, "model")
    kv_on_model = cfg.n_kv % model == 0 and cfg.n_kv >= model
    seq_ax = None if kv_on_model else "model"
    # cache layout: (layers, batch, seq, kv, hd); when kv heads don't divide
    # the model axis the cache shards on SEQ instead (split-KV decode)
    cache_spec = (None, _one(bax), seq_ax,
                  "model" if kv_on_model else None, None)
    if not bax and seq_ax == "model":
        # batch=1 long-context: spread the cache over data + model
        cache_spec = (None, None, ("data", "model"), None, None)

    cache_sds = {k: sds(shape, dt) for k, (shape, dt) in
                 make_cache_specs(cfg, b, s).items()}
    cache_sh = {k: cache_spec for k in cache_sds}

    def step(p, token, caches):
        return decode_step(p, cfg, token, caches, s - 1, mesh)

    tok_sds = sds((b, 1), I32)
    mf = 2.0 * cfg.active_param_count() * b
    return Cell(spec.arch_id, cell.name, step, (params_sds, tok_sds, cache_sds),
                (param_sh, (_one(bax), None), cache_sh), mf, donate=(2,))


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------
_GNN_CLASSES = {"full_graph_sm": 7, "minibatch_lg": 41, "ogb_products": 47,
                "molecule": 2}


def _gnn_flops(cfg, n, e) -> float:
    f = 0.0
    for din, dout in cfg.dims():
        f += 2.0 * n * din * dout + 4.0 * e * dout
    return 3.0 * f  # fwd + bwd


def build_gnn_cell(spec: ArchSpec, cell: ShapeCell, mesh) -> Cell:
    meta = cell.meta
    n_classes = _GNN_CLASSES[cell.name]
    cfg = dataclasses.replace(spec.config, d_feat=meta["d_feat"],
                              n_classes=n_classes,
                              readout="graph" if meta.get("graphs") else "node")
    params_sds, axes = _eval_init(gnn.init_gcn, cfg, F32)
    param_sh = logical_to_sharding(axes, mesh, {"hidden": None, "feat": None})

    n_dev = math.prod(mesh.devices.shape)
    all_ax = tuple(mesh.axis_names)

    if meta.get("sampled"):
        from ..data.graphs import minibatch_shapes
        sh = minibatch_shapes(meta["batch_nodes"], meta["fanout"], meta["d_feat"])
        n, e = sh["n"], sh["e"]
    elif meta.get("graphs"):
        bg = meta["batch"]
        n = bg * meta["n_nodes"]
        e = bg * (2 * meta["n_edges"] + meta["n_nodes"])
    else:
        n, e = meta["n_nodes"], 2 * meta["n_edges"] + meta["n_nodes"]
    e_pad = -(-e // n_dev) * n_dev

    n_lbl = n if not meta.get("graphs") else meta["batch"]
    batch_sds = {
        "x": sds((n, cfg.d_feat), F32),
        "edges": sds((2, e_pad), I32),
        "deg": sds((n,), F32),
        "labels": sds((n_lbl,), I32),
        "mask": sds((n_lbl,), torch.bool),
    }
    bsh = {"x": (), "edges": (None, all_ax), "deg": (), "labels": (),
           "mask": ()}
    if meta.get("graphs"):
        batch_sds["graph_ids"] = sds((n,), I32)
        bsh["graph_ids"] = ()
    ocfg = opt.OptConfig(total_steps=1000)

    n_graphs = meta.get("batch", 0)

    def loss_fn(p, batch):
        return gnn.gcn_loss(p, cfg, batch["x"], batch["edges"], batch["deg"],
                            batch["labels"], batch["mask"],
                            graph_ids=batch.get("graph_ids"),
                            n_graphs=n_graphs)

    step = make_train_step(loss_fn, ocfg)
    args = (params_sds, _opt_sds(params_sds), batch_sds)
    shard = (param_sh, _opt_shardings(param_sh), bsh)
    return Cell(spec.arch_id, cell.name, step, args, shard,
                _gnn_flops(cfg, n, e), donate=(0, 1))


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------
def _rs_mlp_params(cfg) -> int:
    total = 0
    if hasattr(cfg, "mlp") and hasattr(cfg, "n_sparse"):  # wide&deep
        dims = [cfg.n_sparse * cfg.embed_dim, *cfg.mlp, 1]
        total += sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    if hasattr(cfg, "bot_mlp"):
        dims = [cfg.n_dense, *cfg.bot_mlp]
        total += sum(a * b for a, b in zip(dims[:-1], dims[1:]))
        nv = cfg.n_sparse + 1
        dint = nv * (nv - 1) // 2 + cfg.embed_dim
        dims = [dint, *cfg.top_mlp, 1]
        total += sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    if hasattr(cfg, "gru_dim"):
        total += 2 * 3 * (cfg.embed_dim + cfg.gru_dim) * cfg.gru_dim * cfg.seq_len
        dims = [cfg.gru_dim + cfg.embed_dim, *cfg.mlp, 1]
        total += sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    if type(cfg).__name__ == "FMConfig":
        total += 3 * cfg.n_sparse * cfg.embed_dim
    return max(total, 1)


_RS_DEFS = {
    "fm": (recsys.init_fm, recsys.fm_loss, recsys.fm_forward),
    "wide-deep": (recsys.init_wide_deep, recsys.wide_deep_loss,
                  recsys.wide_deep_forward),
    "dien": (recsys.init_dien, recsys.dien_loss, recsys.dien_forward),
    "dlrm-rm2": (recsys.init_dlrm, recsys.dlrm_loss, recsys.dlrm_forward),
}


def _rs_batch_sds(arch, cfg, b):
    out = {}
    if arch == "dien":
        out["hist"] = sds((b, cfg.seq_len), I32)
        out["target"] = sds((b,), I32)
    else:
        out["ids"] = sds((b, cfg.n_sparse), I32)
        if arch == "dlrm-rm2":
            out["dense"] = sds((b, cfg.n_dense), F32)
    out["labels"] = sds((b,), F32)
    return out


def _rs_loss_args(arch, cfg, loss, p, batch):
    if arch == "dien":
        return loss(p, cfg, batch["hist"], batch["target"], batch["labels"])
    if arch == "dlrm-rm2":
        return loss(p, cfg, batch["dense"], batch["ids"], batch["labels"])
    return loss(p, cfg, batch["ids"], batch["labels"])


def build_recsys_cell(spec: ArchSpec, cell: ShapeCell, mesh) -> Cell:
    arch = spec.arch_id
    cfg = spec.config
    init_fn, loss_fn_, fwd_fn = _RS_DEFS[arch]
    # row (vocab) sharding: uniform across archs -- field counts (26/39/40/1)
    # don't divide the 16-way model axis, vocab (1e6) does
    rules = {"fields": None, "table": "model",
             # recsys MLPs are small (<=1024 hidden, odd dims incl. the final
             # scalar head) -- replicate them; batch parallelism dominates
             "mlp": None, "feat": None, "hidden": None}
    params_sds, axes = _eval_init(init_fn, cfg, F32)
    param_sh = logical_to_sharding(axes, mesh, rules)

    if cell.kind == "retrieval":
        # FAVOR as the retrieval layer: user vec x 1e6 candidates + filter
        nc = cell.meta["n_candidates"]
        d = cfg.embed_dim
        items_sds = sds((nc, d), F32)
        user_sds = sds((cell.meta["batch"], d), F32)
        ai = sds((nc, 2), I32)
        af = sds((nc, 1), F32)
        # imask: the uint32 bitmasks in int64, as the port's programs hold them
        progs = {"valid": sds((1, 8), F32), "imask": sds((1, 8, 2), torch.int64),
                 "flo": sds((1, 8, 1), F32), "fhi": sds((1, 8, 1), F32)}

        def step(user, items, programs, attrs_int, attrs_float):
            return recsys.retrieval_topk_filtered(
                user, items, programs, attrs_int, attrs_float, k=100)

        row = ("model", None)
        shard = ((), row, _repl(progs), row, row)
        mf = 2.0 * nc * d * cell.meta["batch"]
        return Cell(arch, cell.name, step,
                    (user_sds, items_sds, progs, ai, af), shard, mf,
                    note="FAVOR PreFBF path as retrieval layer")

    b = cell.meta["batch"]
    bax = batch_axes(b, mesh)
    bspec = _one(bax)
    batch_sds = _rs_batch_sds(arch, cfg, b)
    bsh = {k: (bspec,) + (None,) * (v.dim() - 1) for k, v in batch_sds.items()}

    if cell.kind == "train":
        ocfg = opt.OptConfig(total_steps=10000)

        def lf(p, batch):
            return _rs_loss_args(arch, cfg, loss_fn_, p, batch)

        step = make_train_step(lf, ocfg)
        args = (params_sds, _opt_sds(params_sds), batch_sds)
        shard = (param_sh, _opt_shardings(param_sh), bsh)
        mf = 6.0 * _rs_mlp_params(cfg) * b
        return Cell(arch, cell.name, step, args, shard, mf, donate=(0, 1))

    # serve
    def step(p, batch):
        if arch == "dien":
            return fwd_fn(p, cfg, batch["hist"], batch["target"])
        if arch == "dlrm-rm2":
            return fwd_fn(p, cfg, batch["dense"], batch["ids"])
        return fwd_fn(p, cfg, batch["ids"])

    mf = 2.0 * _rs_mlp_params(cfg) * b
    return Cell(arch, cell.name, step, (params_sds, batch_sds),
                (param_sh, bsh), mf)


# ---------------------------------------------------------------------------
# FAVOR serve cells (the paper's own system)
# ---------------------------------------------------------------------------
def build_favor_cell(spec: ArchSpec, cell: ShapeCell, mesh) -> Cell:
    route = cell.meta["route"]
    return favor_cell(spec.config, cell.name, route, mesh,
                      note=f"paper serve step ({route} route)")


def favor_cell(cfg, shape: str, route: str, mesh, *,
               sample_rate: float = 0.01, cand_cap: int = 0,
               note: str = "") -> Cell:
    """The favor-anns cell of ``route`` at ``cfg``'s sizes: the global
    DB, queries and programs as ``meta`` stand-ins beside the sharded step
    (``favor_step``); the graph route also gets its ``block``, one mesh
    cell counted on real tensors (``favor_graph_block``)."""
    from ..core import distributed as dist
    from ..core.search import SearchConfig
    model = _mesh_axis_size(mesh, "model")
    qax = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    specs = dist.input_specs(cfg.n, cfg.dim, cfg.m_i, cfg.m_f, model,
                             m0=cfg.m0, m=cfg.m, n_upper=cfg.n_upper,
                             width=cfg.width, batch=cfg.batch,
                             sample_rate=sample_rate)
    scfg = SearchConfig(k=cfg.k, ef=cfg.ef, cand_cap=cand_cap)
    if route == "graph":
        # estimated expansion work: ~4*ef hops x M0 neighbors x 2d flops
        mf = cfg.batch * 4.0 * cfg.ef * cfg.m0 * 2.0 * cfg.dim
        block = functools.partial(favor_graph_block, cfg, scfg, mesh,
                                  sample_rate)
    else:
        mf = cfg.batch * cfg.n * 2.0 * cfg.dim
        block = None
    q = qax if len(qax) > 1 else (qax[0] if qax else None)
    shard_specs = (dist.db_specs(), (q, None),
                   {k: (q,) for k in specs["programs"]}, (q,))
    return Cell("favor-anns", shape, favor_step(mesh, scfg, qax, route),
                (specs["db"], specs["queries"], specs["programs"],
                 specs["valid"]),
                None, mf, note=note, block=block, shard_specs=shard_specs,
                out_specs=((q, None), (q, None)))


def favor_step(mesh, scfg, query_axes, route: str):
    """The sharded serve step of ``route`` over the global-shaped DB dict:
    each mesh cell's slice placed (``place_sharded_db``), then the step."""
    from ..core import distributed as dist
    fns = dist.make_serve_fns(mesh, scfg, query_axes=query_axes)
    fn = fns["serve_graph"] if route == "graph" else fns["serve_brute"]

    def step(db, queries, programs, valid):
        cells = dist.place_sharded_db(db, mesh, fns["db_specs"])
        return fn(cells, queries, programs, valid)

    return step


def graph_filter():
    """The graph cell's stated filter: the paper's inclusion scenario
    (section 6.1.1, ~30 % of the rows), which the estimate routes to the
    graph (p_hat above the selector's lambda of 1 %)."""
    from ..core import filters as F
    return F.Inclusion("i0", [1, 4, 7])


# Delta_d (Eq. 5) of the graph cell's shard: a random graph has no distance
# curve of its own, so the cell states one
GRAPH_DELTA_D = 0.02


def favor_graph_block(cfg, scfg, mesh, sample_rate: float, device, seed: int,
                      data_device=None) -> Block:
    """One mesh cell's block of the favor-anns graph cell on real tensors:
    the DB shard (``cfg.n`` / model rows) and one data group's queries
    (``cfg.batch`` / query groups), at ``input_specs``' shapes, run by the
    per-device program ``make_serve_fns`` gives (the estimate over the
    shard's sample, the traversal, the shard merge) on a 1 x 1 mesh of
    ``device``.

    The data is synthetic, drawn from ``seed`` on ``data_device`` (default
    ``device``) and placed on ``device``: normal vectors and their norms;
    random neighbour ids of the specs' degrees, without -1, on level 0 and
    every upper level; attributes in the paper schema's ranges (bool,
    int of vocab 10, float in [0, 100)); the sample drawn from the rows;
    ``graph_filter()`` compiled for every query."""
    from ..core import distributed as dist
    from ..core import filters as F
    from ..core.router import compile_programs
    rows = cfg.n // _mesh_axis_size(mesh, "model")
    q = cfg.batch // math.prod(_mesh_axis_size(mesh, a)
                               for a in ("pod", "data"))
    spec = dist.input_specs(rows, cfg.dim, cfg.m_i, cfg.m_f, 1, m0=cfg.m0,
                            m=cfg.m, n_upper=cfg.n_upper,
                            sample_rate=sample_rate, width=cfg.width,
                            batch=q)["db"]
    schema = F.paper_schema()
    if (len(schema.int_columns), len(schema.float_columns)) != (cfg.m_i,
                                                               cfg.m_f):
        raise ValueError(f"favor-anns m_i={cfg.m_i}, m_f={cfg.m_f} is not "
                         "the paper schema's")
    gdev = torch.device(data_device or device)
    gen = torch.Generator(device=gdev).manual_seed(seed)

    def ids(shape, high=rows):
        return torch.randint(0, high, tuple(shape), generator=gen,
                             device=gdev, dtype=I32)

    vectors = torch.randn(tuple(spec["vectors"].shape), generator=gen,
                          device=gdev)
    ints = torch.stack([ids((rows,), c.vocab) for c in schema.int_columns],
                       dim=1)
    floats = 100.0 * torch.rand((rows, cfg.m_f), generator=gen, device=gdev)
    samp = ids((spec["sample_int"].shape[0],)).long()
    db = {"vectors": vectors, "norms": (vectors * vectors).sum(dim=1),
          "neighbors0": ids(spec["neighbors0"].shape),
          "upper": ids(spec["upper"].shape),
          "attrs_int": ints, "attrs_float": floats, "entry": ids((1,)),
          "delta_d": torch.full((1,), GRAPH_DELTA_D, device=gdev),
          "sample_int": ints[samp], "sample_float": floats[samp]}
    queries = torch.randn((q, cfg.dim), generator=gen, device=gdev)
    dev = torch.device(device)
    mesh1 = dist.make_mesh((1, 1), device=dev)
    fns = dist.make_serve_fns(mesh1, scfg, query_axes=("data",))
    placed = dist.place_sharded_db(db, mesh1, fns["db_specs"])[0, 0]
    progs = compile_programs(graph_filter(), schema, q, cfg.width,
                             device=dev)
    valid = torch.ones((q,), dtype=torch.bool, device=dev)

    def step(db, queries, programs, valid):
        cells = np.empty((1, 1), dtype=object)
        cells[0, 0] = db
        return fns["serve_graph"](cells, queries, programs, valid)

    def facts() -> dict:
        """The last run's waves (a batch-wide count) and the estimate."""
        cells = np.empty((1, 1), dtype=object)
        cells[0, 0] = placed
        p_hat = fns["estimate"](cells, progs)
        waves = int(fns["last_graph"]["waves"][0])
        return {"waves": waves, "hit_max_steps": waves >= scfg.steps,
                "p_hat": float(p_hat.mean())}

    info = {"rows": rows, "queries": q, "sample_rows": int(samp.numel()),
            "dim": cfg.dim, "k": scfg.k, "ef": cfg.ef, "cand_cap": scfg.ccap,
            "max_steps": scfg.steps, "delta_d": GRAPH_DELTA_D,
            "filter": "Inclusion('i0', [1, 4, 7])",
            # the cell's formula at the block's queries: one traversal a
            # query on its shard
            "model_flops": q * 4.0 * cfg.ef * cfg.m0 * 2.0 * cfg.dim}
    return Block(step, (placed, queries.to(dev), progs, valid), info, facts)


BUILDERS = {"lm": build_lm_cell, "gnn": build_gnn_cell,
            "recsys": build_recsys_cell, "favor": build_favor_cell}


def skip_reason(arch: str, shape: str) -> str | None:
    """Why a cell does not run: the registry's reason."""
    return get_spec(arch).cell(shape).skip


def build_cell(arch: str, shape: str, mesh) -> Cell:
    spec = get_spec(arch)
    cell = spec.cell(shape)
    skip = skip_reason(arch, shape)
    if skip:
        raise ValueError(f"cell skipped: {skip}")
    return BUILDERS[spec.family](spec, cell, mesh)


def all_cells(include_favor: bool = True):
    from ..configs import all_specs
    out = []
    for arch, spec in all_specs(include_favor).items():
        for cell in spec.cells:
            out.append((arch, cell.name, skip_reason(arch, cell.name)))
    return out
