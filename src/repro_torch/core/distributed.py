"""Sharded FAVOR serving over a mesh of devices, driven by one process.

Layout (classic distributed-ANNS segment model, Milvus/Vearch style), as in
the JAX package:
 * the DB (vectors, attributes, per-shard HNSW subgraphs, selectivity sample)
   is sharded on the ``model`` axis: shard s owns rows [s*Ns, (s+1)*Ns);
 * the query batch is split on the query axes (``data``): pure data
   parallelism;
 * every (data, model) mesh cell runs the single-shard search of
   ``search.py`` on its query block x DB shard, then the per-shard top-k are
   gathered onto the mesh's first device in shard order and sort-merged (k
   per shard -> k global);
 * the selectivity estimate sums the per-shard sample counts and sizes, so
   every shard sees the same p_hat and the same route.

Each shard has its own HNSW (built independently, embarrassingly parallel
and linear in shards), its own entry point and its own Delta_d; D is
computed per shard from the *global* p_hat and the local Delta_d.

The JAX package runs these bodies under ``shard_map`` inside ``jax.jit``;
here one Python process, the one that runs the router and the serving
stack, drives every cell in turn.  A ``Mesh`` is an array of
``torch.device``s: several shards may share one card (the per-shard kernel
launches, the global-id offsets and the merge then run for real on it), or
span ``cuda:0..S-1`` on a box with more cards, or ``"cpu"`` for the tests.
``arrays`` of a ``ShardedFavorArrays`` stay host numpy; ``place_sharded_db``
puts each cell's slice on its device.

Where the JAX bodies run a collective -- the merge's all-gathers of every
shard's (B, k) results, the estimate's all-reduces of the sample counts and
sizes -- the single controller moves the same data between mesh cells.
Under a dry-run count (``count_collectives``) each of those points charges
the collective the JAX body runs, once per device program
(``serve_collectives``); outside a count the charge is a no-op.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass

import numpy as np
import torch

from . import exclusion, prefbf
from . import filters as F
from .hnsw import HnswParams, build_hnsw
from .search import SearchConfig, favor_graph_search
from ..device import resolve_device
from ..kernels._common import stable_topk


def largest_divisor(n: int, cap: int) -> int:
    """Largest divisor of ``n`` that is <= ``cap`` (e.g. scan chunk sizes and
    mesh-axis extents that must evenly split a row count)."""
    d = max(1, min(cap, n))
    while n % d:
        d -= 1
    return d


# ---------------------------------------------------------------------------
# Device mesh
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Mesh:
    """An n-d array of ``torch.device``s with named axes (the counterpart of
    ``jax.sharding.Mesh``): ``devices`` (an object array), ``axis_names``
    and ``shape`` ({axis name: extent})."""
    devices: np.ndarray
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh devices {self.devices.shape} do not match "
                             f"axis names {self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def first_device(self) -> torch.device:
        """Where queries, programs, p_hat and merged results live."""
        return self.devices.flat[0]


def make_mesh(shape, axis_names=("data", "model"), device=None) -> Mesh:
    """A mesh of ``shape`` cells.  ``device=None`` puts every cell on the
    CUDA device (``device.resolve_device``: raises without a card); a
    device name or ``torch.device`` puts every cell there (``"cpu"`` for
    the tests); an array of devices of ``shape`` names each cell's."""
    shape = tuple(int(s) for s in shape)
    if device is None or isinstance(device, (str, torch.device)):
        dev = resolve_device(device)
        devs = np.empty(shape, dtype=object)
        devs.fill(dev)
    else:
        flat = [resolve_device(d) for d in np.asarray(device,
                                                      dtype=object).flat]
        devs = np.empty(len(flat), dtype=object)
        devs[:] = flat
        if devs.size != math.prod(shape):
            raise ValueError(f"{devs.size} devices for a mesh of {shape}")
        devs = devs.reshape(shape)
    return Mesh(devs, tuple(axis_names))


def _grid(cells: np.ndarray, mesh: Mesh, query_axes, model_axis: str):
    """A mesh-shaped object array viewed as (query blocks, model shards):
    query axes first (flattened, in order), then the model axis; cells on
    any other axis hold replicas, and the first replica serves."""
    names = list(mesh.axis_names)
    order = [names.index(a) for a in query_axes] + [names.index(model_axis)]
    rest = [i for i in range(len(names)) if i not in order]
    n_q = math.prod(mesh.shape[a] for a in query_axes)
    out = np.transpose(cells, order + rest).reshape(
        n_q, mesh.shape[model_axis], -1)
    return out[:, :, 0]


# ---------------------------------------------------------------------------
# Sharded index container
# ---------------------------------------------------------------------------
def db_specs(model_axis: str = "model", quant: str | None = None,
             live: bool = False) -> dict:
    """Partition specs for the serve DB dict: one entry per array axis, the
    mesh axis it is split on or None (replicated), as JAX's PartitionSpec.

    ``quant`` extends the base layout with the compressed-scan arrays:
    "codes" rows are co-sharded with their vectors on ``model_axis``; the
    (tiny) codebook tables are replicated on every device.  ``live`` adds
    the tombstone mask ("alive", row-co-sharded) of a mutated backend.
    """
    sh = {
        "vectors": (model_axis, None), "norms": (model_axis,),
        "neighbors0": (model_axis, None), "upper": (None, model_axis, None),
        "attrs_int": (model_axis, None), "attrs_float": (model_axis, None),
        "entry": (model_axis,), "delta_d": (model_axis,),
        "sample_int": (model_axis, None), "sample_float": (model_axis, None),
    }
    if live:
        sh["alive"] = (model_axis,)
    if quant is not None:
        sh["codes"] = (model_axis, None)
        if quant == "pq":
            sh["centroids"] = (None, None, None)
        elif quant == "sq":
            sh["sq_lo"] = (None,)
            sh["sq_scale"] = (None,)
        else:
            raise ValueError(
                f"quant must be 'pq', 'sq' or None, got {quant!r}")
    return sh


@dataclass
class ShardedFavorArrays:
    """Global-shaped host arrays; axis 0 of every DB array is sharded on
    "model".

    vectors     (S*Ns, d)      norms      (S*Ns,)
    neighbors0  (S*Ns, M0)     upper      (L_up, S*Ns, M)   [local node ids]
    attrs_int   (S*Ns, m_i)    attrs_float(S*Ns, m_f)
    entry       (S,) int32     delta_d    (S,) f32
    sample_int  (S*ns, m_i)    sample_float (S*ns, m_f)

    With a codebook attached (attach_quant): codes (S*Ns, M) uint8 plus the
    replicated codebook tables (centroids | sq_lo/sq_scale).
    """
    arrays: dict
    n_shards: int
    shard_rows: int
    sample_rows: int  # per shard
    quant: str | None = None  # "pq" | "sq" once attach_quant has run

    def specs(self) -> dict:
        return db_specs(quant=self.quant)


def attach_quant(sharded: ShardedFavorArrays, codebook,
                 device=None) -> ShardedFavorArrays:
    """Encode the sharded DB under ``codebook`` so the brute route can
    stream codes instead of float32 rows.  Row i's code lands on the same
    shard as vector i (contiguous row partition on "model").  The encode
    runs on ``device`` (None: the CUDA device); the codes come back to the
    host with the other arrays."""
    from .. import quant
    from ..device import to_host
    arrays = dict(sharded.arrays)
    arrays["codes"] = to_host(quant.encode(codebook, arrays["vectors"],
                                           device=device))
    if isinstance(codebook, quant.PQCodebook):
        kind = "pq"
        arrays["centroids"] = np.asarray(codebook.centroids, np.float32)
    else:
        kind = "sq"
        arrays["sq_lo"] = np.asarray(codebook.lo, np.float32)
        arrays["sq_scale"] = np.asarray(codebook.scale, np.float32)
    return ShardedFavorArrays(arrays, sharded.n_shards, sharded.shard_rows,
                              sharded.sample_rows, quant=kind)


def build_sharded(vectors: np.ndarray, attrs: F.AttributeTable, n_shards: int,
                  params: HnswParams | None = None, sample_rate: float = 0.01,
                  seed: int = 0, min_sample: int = 8,
                  max_sample: int = 65536,
                  build_fn=None, n_valid: int | None = None,
                  keep_parts: bool = False):
    """Partition rows round-robin-contiguously, build one HNSW per shard.

    ``min_sample``/``max_sample`` bound the TOTAL selectivity-sample size
    (split evenly across shards) exactly like SelectorConfig bounds the
    single-host sample, so the summed p_hat matches the single-host
    estimator's variance and both backends take the same routes -- and the
    per-batch estimate stays O(max_sample) however large the DB.

    ``build_fn(vectors, params) -> HnswIndex`` overrides the per-shard build
    (default sequential ``build_hnsw``; pass ``index.bulk.build_hnsw_bulk``
    for the device wave pipeline).

    ``n_valid`` marks rows >= n_valid as permanently-dead headroom: they are
    excluded from the per-shard graph build (their neighbor rows stay -1, so
    a later incremental merge can register real rows onto those positions)
    and from the selectivity sample.  The headroom convention requires the
    dead tail to live inside the LAST shard; a fully-dead shard falls back
    to the legacy zero-vector build so its entry/delta_d stay defined.

    ``keep_parts=True`` additionally returns the per-shard HnswIndex objects
    (the handles an incremental merge grows via ``bulk_add``)."""
    n = vectors.shape[0]
    assert n % n_shards == 0, "row count must divide the model axis"
    build_fn = build_fn or build_hnsw
    ns = n // n_shards
    n_valid = n if n_valid is None else int(n_valid)
    parts = []
    lvs = []
    max_lup = 0
    for s in range(n_shards):
        sl = slice(s * ns, (s + 1) * ns)
        p = params or HnswParams()
        p = HnswParams(M=p.M, M0=p.M0, efc=p.efc, ml=p.ml, alpha=p.alpha,
                       heuristic=p.heuristic, seed=p.seed + s)
        lv = min(ns, n_valid - s * ns)
        lv = ns if lv < 1 else lv
        idx = build_fn(vectors[sl][:lv], p)
        parts.append((idx, sl))
        lvs.append(lv)
        max_lup = max(max_lup, len(idx.levels) - 1)

    sample_n = max(8, -(-min_sample // n_shards), int(round(ns * sample_rate)))
    sample_n = min(sample_n, ns, max(8, max_sample // n_shards))
    rng = np.random.default_rng(seed + 31)

    neighbors0 = np.full((n, parts[0][0].params.M0), -1, np.int32)
    upper = np.full((max_lup, n, parts[0][0].params.M), -1, np.int32)
    entry = np.zeros((n_shards,), np.int32)
    delta_d = np.zeros((n_shards,), np.float32)
    s_int = np.zeros((n_shards * sample_n, attrs.ints.shape[1]), np.int32)
    s_flt = np.zeros((n_shards * sample_n, attrs.floats.shape[1]), np.float32)
    norms = np.einsum("nd,nd->n", vectors, vectors).astype(np.float32)

    for s, (idx, sl) in enumerate(parts):
        lo, lv = sl.start, lvs[s]
        neighbors0[lo:lo + idx.n] = idx.levels[0]
        for li, lvl in enumerate(idx.levels[1:]):
            upper[li, lo:lo + idx.n] = lvl
        entry[s] = idx.entry_point
        delta_d[s] = idx.delta_d
        samp = rng.choice(lv, size=sample_n, replace=sample_n > lv) + lo
        s_int[s * sample_n:(s + 1) * sample_n] = attrs.ints[samp]
        s_flt[s * sample_n:(s + 1) * sample_n] = attrs.floats[samp]

    arrays = {
        "vectors": vectors.astype(np.float32), "norms": norms,
        "neighbors0": neighbors0, "upper": upper,
        "attrs_int": attrs.ints, "attrs_float": attrs.floats,
        "entry": entry, "delta_d": delta_d,
        "sample_int": s_int, "sample_float": s_flt,
    }
    sharded = ShardedFavorArrays(arrays, n_shards, ns, sample_n)
    if keep_parts:
        return sharded, [idx for idx, _ in parts]
    return sharded


def input_specs(n: int, dim: int, m_i: int, m_f: int, n_shards: int, *,
                m0: int = 32, m: int = 16, n_upper: int = 3,
                sample_rate: float = 0.01, width: int = 8,
                batch: int = 4096, dtype=torch.float32) -> dict:
    """Shape stand-ins for the dry run: the JAX package's keys, shapes and
    dtypes as ``meta`` tensors (its ``ShapeDtypeStruct``s; nothing is
    allocated).  The programs' ``imask`` is int64, holding the uint32
    bitmasks as ``router.compile_programs`` puts them on a device."""
    ns = n // n_shards
    sample_n = max(8, int(round(ns * sample_rate)))
    f32, i32 = dtype, torch.int32

    def sds(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")

    return {
        "db": {
            "vectors": sds((n, dim), f32), "norms": sds((n,), f32),
            "neighbors0": sds((n, m0), i32), "upper": sds((n_upper, n, m), i32),
            "attrs_int": sds((n, m_i), i32), "attrs_float": sds((n, m_f), f32),
            "entry": sds((n_shards,), i32),
            "delta_d": sds((n_shards,), torch.float32),
            "sample_int": sds((n_shards * sample_n, m_i), i32),
            "sample_float": sds((n_shards * sample_n, m_f), f32),
        },
        "queries": sds((batch, dim), f32),
        "programs": {
            "valid": sds((batch, width), torch.float32),
            "imask": sds((batch, width, m_i), torch.int64),
            "flo": sds((batch, width, m_f), f32),
            "fhi": sds((batch, width, m_f), f32),
        },
        "valid": sds((batch,), torch.bool),
    }


def place_sharded_db(arrays: dict, mesh: Mesh, specs: dict) -> np.ndarray:
    """Each mesh cell's slice of ``arrays`` (numpy, or tensors: the dry
    run's meta stand-ins) as tensors on the cell's device: a mesh-shaped
    object array of dicts.  An array is split along every axis its spec
    names (the cell's coordinate on that mesh axis picks the slice) and
    copied whole where the spec says None; cells on one device that hold
    the same slice share one tensor."""
    cells = np.empty(mesh.devices.shape, dtype=object)
    placed: dict = {}
    for coord in np.ndindex(*mesh.devices.shape):
        dev = mesh.devices[coord]
        at = dict(zip(mesh.axis_names, coord))
        cell = {}
        for key, a in arrays.items():
            index = []
            for size, ax in zip(a.shape, specs[key]):
                if ax is None:
                    index.append(slice(None))
                else:
                    part = size // mesh.shape[ax]
                    index.append(slice(at[ax] * part, (at[ax] + 1) * part))
            memo = (str(dev), key, tuple((s.start, s.stop) for s in index))
            if memo not in placed:
                piece = a[tuple(index)]
                placed[memo] = (piece.to(dev) if torch.is_tensor(piece) else
                                torch.as_tensor(np.ascontiguousarray(piece),
                                                device=dev))
            cell[key] = placed[memo]
        cells[coord] = cell
    return cells


# ---------------------------------------------------------------------------
# Collective charges of a dry-run count
# ---------------------------------------------------------------------------
_charging = threading.local()


@contextlib.contextmanager
def count_collectives(charge):
    """While active on this thread, the serve steps charge
    ``charge(kind, operand_bytes, g, programs)`` for each collective the
    JAX package's ``shard_map`` body runs where data crosses mesh cells:
    one collective of ``kind`` over a group of ``g`` on an operand of
    ``operand_bytes``, in each of ``programs`` device programs."""
    prev = getattr(_charging, "charge", None)
    _charging.charge = charge
    try:
        yield
    finally:
        _charging.charge = prev


def serve_collectives(b_local: int, k: int, *, merge: bool = True,
                      estimate: bool = False) -> list[tuple[str, int]]:
    """The collectives one device program of a sharded serve step runs, as
    (kind, operand bytes) over the ``model`` axis, for a query block of
    ``b_local`` rows: the merge's all-gather of the (b_local, k) f32
    distances and of the ids (int64, as the port moves them; the JAX
    package's are int32), and the estimate's all-reduces of the
    (b_local,) f32 sample counts and of the f32 sample size (the port sums
    the sizes on the host; the JAX package psums an f32 scalar)."""
    out = []
    if estimate:
        out += [("all-reduce", 4 * b_local), ("all-reduce", 4)]
    if merge:
        out += [("all-gather", 4 * b_local * k),
                ("all-gather", 8 * b_local * k)]
    return out


def _charge(colls, g: int) -> None:
    charge = getattr(_charging, "charge", None)
    if charge is not None and g > 1:
        for kind, operand in colls:
            charge(kind, float(operand), g, g)


# ---------------------------------------------------------------------------
# Sharded serve steps
# ---------------------------------------------------------------------------
def _block(x, i: int, n: int, dev):
    """Row block ``i`` of ``n`` equal blocks of a tensor, a numpy array or a
    program dict, on ``dev`` (None stays None)."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _block(v, i, n, dev) for k, v in x.items()}
    x = torch.as_tensor(x)
    rows = x.shape[0] // n
    return x[i * rows:(i + 1) * rows].to(dev)


def make_serve_fns(mesh: Mesh, cfg: SearchConfig, *, ef_sel: int | None = None,
                   prefbf_chunk: int = 65536, query_axes=("data",),
                   model_axis: str = "model", quant: str | None = None,
                   rerank: int = 4, live: bool = False):
    """Build the sharded serve steps for ``mesh``.

    Returns dict with:
      estimate(db, programs)                     -> (B,) p_hat
      serve_graph(db, queries, programs, valid)  -> ids (B,k) GLOBAL ids, dists
      serve_graph_phat(db, queries, programs, p_hat, valid) -> the same, with
                                                    p_hat from the caller
      serve_brute(db, queries, programs, valid)  -> ids (B,k), dists
      serve_brute_pq(db, queries, programs, valid) [quant only] -> ids, dists
      last_graph                                 -> {"waves", "hops"} of the
                                                    last cell's traversal

    ``db`` is ``place_sharded_db``'s cell array; queries, programs, p_hat
    and ``valid`` lie on the mesh's first device, where the results come
    back.  B must divide by the query axes' extent.  ``valid`` is the (B,)
    bool row mask of the bucket-padding contract (core.batching): False
    rows are pad rows and come back as -1 / +inf.

    Each cell runs the single-shard body on its query block and its shard,
    on the cell's device: the brute scans through the ``filtered_topk`` /
    ``pq_adc_topr`` kernel wrappers over the shard's rows (one launch per
    shard on CUDA tensors), the traversal with the scorer
    ``cfg.graph_quant`` names.  With ``quant`` set ("pq"/"sq") the db
    carries the attach_quant arrays; serve_brute_pq scans only the uint8
    codes per shard, exact-re-ranks the top ``rerank * k`` local candidates
    against the shard's float32 rows, and only then joins the cross-shard
    merge.  With ``cfg.graph_quant`` set each shard's traversal scores its
    code rows (requires ``quant`` == ``cfg.graph_quant``).
    """
    ef = ef_sel or cfg.ef
    dspecs = db_specs(model_axis, quant, live)
    devs = _grid(mesh.devices, mesh, query_axes, model_axis)
    n_q, n_s = devs.shape
    out_dev = mesh.first_device

    def _cells(db):
        return _grid(db, mesh, query_axes, model_axis)

    def _scan_norms(cell):
        """Per-shard norms for the brute scans: with a live DB, tombstoned
        rows take +inf (the padded-row convention) so they can never win."""
        if live:
            return torch.where(cell["alive"], cell["norms"], float("inf"))
        return cell["norms"]

    def _per_block(db, inputs, body):
        """Run ``body(cell, shard, *block inputs)`` on every cell, merge each
        query block's shards, and stack the blocks in order."""
        cells = _cells(db)
        outs_i, outs_d = [], []
        for qi in range(n_q):
            ds, is_ = [], []
            for s in range(n_s):
                dev = devs[qi, s]
                args = [_block(x, qi, n_q, dev) for x in inputs]
                i, d = body(cells[qi, s], s, *args)
                n_local = cells[qi, s]["norms"].shape[0]
                ds.append(d)
                is_.append(torch.where(i >= 0, i.to(torch.int64)
                                       + s * n_local, -1))
            # the shards' (B, k) results gathered in shard order, so ties
            # go to the lower shard (as ``jnp.argsort`` over the JAX
            # all-gather gives them); a count charges those all-gathers,
            # the ids at the int64 they cross as
            _charge(serve_collectives(*ds[0].shape), n_s)
            d, i = stable_topk([x.to(out_dev) for x in ds], cfg.k,
                               [x.to(out_dev) for x in is_])
            outs_i.append(torch.where(torch.isfinite(d), i, -1))
            outs_d.append(d)
        return torch.cat(outs_i), torch.cat(outs_d)

    # -- selectivity estimate (summed over shards; the same on every shard) --
    def estimate(db, programs):
        cells = _cells(db)
        out = []
        for qi in range(n_q):
            cnt, tot = None, 0
            for s in range(n_s):
                cell = cells[qi, s]
                progs = _block(programs, qi, n_q, devs[qi, s])
                mask = F.eval_program_batched(progs, cell["sample_int"],
                                              cell["sample_float"])
                c = mask.sum(dim=1, dtype=torch.float32).to(out_dev)
                cnt = c if cnt is None else cnt + c
                tot += int(mask.shape[1])
            # the JAX package's psum of the counts and of the f32 size
            _charge(serve_collectives(cnt.shape[0], 0, merge=False,
                                      estimate=True), n_s)
            # a true division, as the JAX package's cnt / psum(tot)
            out.append(cnt / torch.full_like(cnt, tot))
        return torch.cat(out)

    # -- graph route ----------------------------------------------------------
    if cfg.graph_quant is not None and cfg.graph_quant != quant:
        raise ValueError(
            f"cfg.graph_quant={cfg.graph_quant!r} needs the serve DB built "
            f"with matching attach_quant codes (quant={quant!r})")

    last_graph: dict = {}

    def _graph_body(cell, s, queries, programs, p_hat, valid):
        local_g = {
            "vectors": cell["vectors"], "norms": cell["norms"],
            "neighbors0": cell["neighbors0"], "upper": cell["upper"],
            "entry": int(cell["entry"][0]),
            "attrs_int": cell["attrs_int"], "attrs_float": cell["attrs_float"],
        }
        if live:
            local_g["alive"] = cell["alive"]
        if cfg.graph_quant is not None:
            # scorer arrays (core.scoring): each shard scores its own code
            # rows; the replicated codebook tables ride along
            local_g["codes"] = cell["codes"]
            if cfg.graph_quant == "pq":
                local_g["centroids"] = cell["centroids"]
            else:
                local_g["sq_lo"] = cell["sq_lo"]
                local_g["sq_scale"] = cell["sq_scale"]
        D = exclusion.exclusion_distance(p_hat, ef, cell["delta_d"][0],
                                         k=cfg.k, xp=torch)
        out = favor_graph_search(local_g, queries, programs, D, cfg,
                                 valid=valid)
        last_graph.update(waves=out["waves"], hops=out["hops"])
        return out["ids"], out["dists"]

    def serve_graph_phat(db, queries, programs, p_hat, valid):
        return _per_block(db, (queries, programs, p_hat, valid), _graph_body)

    def serve_graph(db, queries, programs, valid):
        return serve_graph_phat(db, queries, programs,
                                estimate(db, programs), valid)

    # -- brute route ----------------------------------------------------------
    def _brute_body(cell, s, queries, programs, valid):
        n_local = cell["vectors"].shape[0]
        return prefbf.prefbf_topk(
            cell["vectors"], _scan_norms(cell), cell["attrs_int"],
            cell["attrs_float"], queries, programs, k=cfg.k,
            chunk=largest_divisor(n_local, prefbf_chunk), valid=valid)

    def serve_brute(db, queries, programs, valid):
        return _per_block(db, (queries, programs, valid), _brute_body)

    fns = {"estimate": estimate, "serve_graph": serve_graph,
           "serve_graph_phat": serve_graph_phat, "serve_brute": serve_brute,
           "last_graph": last_graph,
           "db_specs": dspecs, "query_spec": (tuple(query_axes), None)}

    # -- compressed brute route (quant subsystem, sharded) --------------------
    if quant is not None:
        from ..quant import adc as quant_adc

        def _brute_pq_body(cell, s, queries, programs, valid):
            """Per shard: ADC scan over the local uint8 codes -> exact
            float32 re-rank of the top rerank*k local candidates; the O(Ns)
            scan reads only codes."""
            chunk = largest_divisor(cell["norms"].shape[0], prefbf_chunk)
            norms = _scan_norms(cell)
            if quant == "pq":
                return quant_adc.pq_prefbf_topk(
                    cell["codes"], norms, cell["attrs_int"],
                    cell["attrs_float"], queries, programs, cell["centroids"],
                    cell["vectors"], k=cfg.k, rerank=rerank, chunk=chunk,
                    valid=valid)
            return quant_adc.sq_prefbf_topk(
                cell["codes"], cell["sq_lo"], cell["sq_scale"], norms,
                cell["attrs_int"], cell["attrs_float"], queries, programs,
                cell["vectors"], k=cfg.k, rerank=rerank, chunk=chunk,
                valid=valid)

        def serve_brute_pq(db, queries, programs, valid):
            return _per_block(db, (queries, programs, valid), _brute_pq_body)

        fns["serve_brute_pq"] = serve_brute_pq

    return fns
