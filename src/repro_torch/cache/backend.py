"""CachingBackend: a Backend decorator that layers the serving caches over
an inner backend (the port's LocalBackend) without the router or
ServeEngine changing shape.

Layer placement follows the online pipeline (estimate -> route -> scan):

  * ``lookup_result``/``record_result`` -- the optional router hooks -- run
    the SemanticResultCache *before* estimation, so an exact-repeat
    (query, filter) pair skips the whole pipeline.
  * ``estimate`` runs the SelectivityCache keyed on canonical signatures and
    forwards only first-occurrence cache misses to the inner estimator.
  * ``search_brute`` runs the CandidateCache: a hit scans the cached
    matching-ID block (exact distances, identical results) instead of the
    corpus; admission is on the *second* brute miss of a signature so one-off
    filters never pay the O(N) extension computation.

Every call first syncs against ``inner.version()``.  Backends that expose
per-component epochs (``versions()`` -> vectors/attributes/graph, the live
index subsystem) get *scoped* invalidation: an attributes bump drops the
selectivity layer (the estimator sample changed), attributes|graph drops the
candidate layer (cached extensions describe stale base rows), and any bump
drops the semantic layer (final top-k results can shift under every mutation
class).  A vectors-only bump -- streaming upsert/delete, which never touches
the base arrays or the estimator sample -- therefore leaves the selectivity
and candidate layers warm: the candidate hit path composes the live state at
serve time (tombstoned base rows masked out, live delta rows folded in), so
warm blocks still produce exact results.  Backends without ``versions()``
fall back to the drop-everything epoch bump.

Tenant scoping: the backend declares ``scope_aware``, so ``router.execute``
attaches the per-request tenant/session scope ids (when the caller supplies
them) as a ``"scope"`` sidecar row on the stacked program dict.  The sidecar
is stripped before every inner call -- the device backend never sees it --
and consumed host-side: the semantic and candidate layers key on (scope,
signature), so one tenant's cached results/ID blocks can never serve
another, while the selectivity layer stays global (p_hat is a property of
the data, not of who asked).  ``scope_id``
interns tenant names -> dense ids (0 is the unscoped default); per-scope
hit/miss counters surface through ``cache_stats()``.

The device boundary: the cache layers are host numpy, the inner backend
works on tensors on its device.  Every value read off the inner backend
(or off the router's program tensors and ``"scope"`` sidecar) crosses
through ``repro_torch.device.to_host``; every sub-batch handed back to it
is sliced on its device.  The candidate layer's block scan runs on the
host over the host HNSW's rows, as in the JAX package.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..core import batching
from ..core import filters as F
from ..core.options import CacheSpec, SearchOptions
from ..core.router import take_programs
from ..device import to_host
from .layers import CandidateCache, SelectivityCache, SemanticResultCache
from .lru import LruTtlCache

_REJECTED = -1  # _brute_seen sentinel: signature failed candidate admission


def _corpus_view(inner):
    """Host-side (vectors, norms, ints, floats) of the inner backend's rows,
    or None when the backend does not expose its corpus (candidate layer
    then bypasses).  Row order matches the IDs the backend returns.

    A LocalBackend's FavorIndex keeps its host HNSW (``norms`` are |v|^2)
    and attribute table beside the device arrays; those are read, not the
    padded device scan arrays, which carry pad rows past ``n``.  A
    ShardedBackend's arrays are host numpy in global row order."""
    fi = getattr(inner, "index", None)           # LocalBackend -> FavorIndex
    if fi is not None:
        hx = fi.index
        return (np.asarray(hx.vectors, np.float32),
                np.asarray(hx.norms, np.float32),
                fi.attrs.ints, fi.attrs.floats)
    sharded = getattr(inner, "sharded", None)    # ShardedBackend
    if sharded is not None:
        a = sharded.arrays
        return (np.asarray(a["vectors"], np.float32),
                np.asarray(a["norms"], np.float32),
                a["attrs_int"], a["attrs_float"])
    return None


def _host_programs(programs: dict, row: int) -> dict:
    """One program row of a stacked (device) program dict, on the host."""
    return {k: to_host(v[row]) for k, v in programs.items()}


def _split_scope(programs: dict):
    """Split the host-side ``"scope"`` sidecar off a stacked program dict.

    Returns ``(inner_programs, scopes)`` where ``inner_programs`` carries
    only real program rows (what the inner backend's kernels take) and
    ``scopes`` is a host (B,) int array, or None when the batch is
    unscoped."""
    if "scope" not in programs:
        return programs, None
    inner = {k: v for k, v in programs.items() if k != "scope"}
    return inner, to_host(programs["scope"]).astype(np.int64)


class CachingBackend:
    """Wrap ``inner`` with the selectivity/candidate/semantic cache layers."""

    # router.execute attaches per-request tenant scopes only to backends
    # that declare they consume (and strip) the sidecar
    scope_aware = True

    def __init__(self, inner, spec: CacheSpec | None = None, *,
                 clock=time.monotonic):
        self.inner = inner
        self.spec = spec or CacheSpec()
        # every public entry point below is host-side (dict/LRU walks):
        # one reentrant lock makes lookups, admissions and epoch
        # invalidation safe under pipelined serving, where cache record
        # (step k, finish thread) and cache lookup (step k+1, dispatch
        # thread) would otherwise interleave mid-eviction.  Device work is
        # never awaited while holding it except on the brute miss path,
        # which the engine lock already serializes when driven through
        # ServeEngine.
        self._lock = threading.RLock()
        self.selectivity_cache = SelectivityCache(self.spec, clock)
        self.candidate_cache = CandidateCache(self.spec, clock)
        self.semantic_cache = SemanticResultCache(self.spec, clock)
        # signature -> brute-miss count; admission to the candidate cache
        # happens on the second miss (cache-on-re-reference)
        self._brute_seen = LruTtlCache(4 * self.spec.candidate_cap,
                                       self.spec.ttl_s, clock)
        # lazy: resolved on the first brute batch that can use it, so
        # wrapping a backend never materializes a corpus view it won't need
        self._corpus_view = None
        # signature memo keyed on program-array identity: router.execute
        # hands the *same* program-dict object to lookup_result, estimate
        # and record_result whenever the sub-batch is the whole batch, but
        # with bucket padding up to three distinct padded dicts (estimate,
        # graph, brute) sit between the first and last use of the original
        # -- four slots keep the full call chain memoized (the held
        # references keep the identity-keys valid)
        self._sig_memo: list = []
        self._epoch = inner.version()
        self._versions = self._inner_versions()
        self.invalidations = 0
        # tenant/session scope registry: name -> dense id (0 = unscoped);
        # the front-end interns its tenants here so scopes stay consistent
        # across every logical front-end sharing this backend
        self._scope_ids: dict[str, int] = {"": 0}
        # the live BatchSpec, captured in validate() (which router.execute
        # calls before every batch): the cache split re-introduces
        # data-dependent miss counts, so inner estimate/brute calls are
        # re-bucketed with the SAME ladder the caller padded (and warmup()
        # warmed) with -- a private default here would run shapes warmup
        # never covered
        self._batch = None

    # -- Backend protocol (delegated identity) -------------------------------
    @property
    def schema(self) -> F.Schema:
        return self.inner.schema

    @property
    def sel_cfg(self):
        return self.inner.sel_cfg

    def validate(self, opts: SearchOptions) -> None:
        self._batch = opts.batch
        self.inner.validate(opts)

    def version(self) -> int:
        return self.inner.version()

    def bytes_per_hop(self, opts: SearchOptions) -> int:
        # spelled out, not left to __getattr__: isinstance against the
        # runtime-checkable Backend protocol looks attributes up statically
        return self.inner.bytes_per_hop(opts)

    def scope_id(self, name) -> int:
        """Intern a tenant/session name to its dense scope id ("" -> 0)."""
        with self._lock:
            s = str(name)
            if s not in self._scope_ids:
                self._scope_ids[s] = len(self._scope_ids)
            return self._scope_ids[s]

    def __getattr__(self, name):
        # transparent decorator: anything outside the cache surface
        # (bytes_per_vector, mesh, index, ...) resolves on the inner backend
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self.inner, name)

    # -- epoch invalidation ---------------------------------------------------
    def _corpus(self):
        """Host corpus view for the candidate layer (lazily resolved)."""
        if not self.spec.candidates:
            return None
        if self._corpus_view is None:
            self._corpus_view = _corpus_view(self.inner)
        return self._corpus_view

    def _inner_versions(self):
        """Per-component epochs of the inner backend, or None when it only
        reports an aggregate version (legacy clear-everything granularity)."""
        fn = getattr(self.inner, "versions", None)
        return dict(fn()) if fn is not None else None

    def _live_view(self):
        """The inner backend's (base_alive, delta) live state, or None for
        static backends / an inactive live path."""
        fn = getattr(self.inner, "live_view", None)
        return fn() if fn is not None else None

    def _sync_epoch(self) -> None:
        v = self.inner.version()
        if v == self._epoch:
            return
        self.invalidations += 1
        new = self._inner_versions()
        if new is None or self._versions is None:
            self.clear()
            self._corpus_view = None  # re-resolved on next use
        else:
            # scoped invalidation (see module docstring for the matrix)
            attrs_moved = new["attributes"] != self._versions["attributes"]
            graph_moved = new["graph"] != self._versions["graph"]
            if attrs_moved:
                self.selectivity_cache.clear()
            if attrs_moved or graph_moved:
                self.candidate_cache.clear()
                self._brute_seen.clear()
                self._corpus_view = None  # base arrays were rebuilt
            self.semantic_cache.clear()
        self._epoch = v
        self._versions = new

    def clear(self) -> None:
        """Drop every cached entry in all three layers (counters survive)."""
        with self._lock:
            self.selectivity_cache.clear()
            self.candidate_cache.clear()
            self.semantic_cache.clear()
            self._brute_seen.clear()
            self._sig_memo = []

    def reset_cache_counters(self) -> None:
        """Zero every layer's hit/miss/bypass/eviction counters and the
        invalidation count; entries, epochs and scope interning survive.
        ``ServeEngine.reset_stats()`` calls this through the metrics
        registry's reset cascade (the dual of ``clear()``, which drops
        entries but keeps counters)."""
        with self._lock:
            self.selectivity_cache.reset_counters()
            self.candidate_cache.reset_counters()
            self.semantic_cache.reset_counters()
            self.invalidations = 0

    def _signatures(self, programs: dict) -> list[str]:
        """Per-query canonical signatures, memoized on array identity."""
        vals = tuple(programs[k] for k in ("valid", "imask", "flo", "fhi"))
        for j, (prev, sigs) in enumerate(self._sig_memo):
            if len(prev) == len(vals) and all(a is b for a, b in
                                              zip(prev, vals)):
                if j:
                    self._sig_memo.insert(0, self._sig_memo.pop(j))
                return sigs
        sigs = F.batch_signatures(programs)
        self._sig_memo.insert(0, (vals, sigs))
        del self._sig_memo[4:]
        return sigs

    # -- semantic layer: router fast-path hooks -------------------------------
    def lookup_result(self, queries: np.ndarray, programs: dict,
                      opts: SearchOptions):
        """Optional router hook: per-query semantic hits for the batch, or
        None when the layer is disabled / nothing hit."""
        with self._lock:
            return self._lookup_result(queries, programs, opts)

    def _lookup_result(self, queries, programs, opts):
        self._sync_epoch()
        if not self.semantic_cache.enabled:
            return None
        programs, scopes = _split_scope(programs)
        queries = to_host(queries).astype(np.float32, copy=False)
        sigs = self._signatures(programs)
        hit = np.zeros((len(sigs),), bool)
        rows = []
        for i, sig in enumerate(sigs):
            scope = int(scopes[i]) if scopes is not None else 0
            e = self.semantic_cache.get(sig, opts, queries[i], scope=scope)
            if e is not None:
                hit[i] = True
                rows.append(e)
        if not rows:
            return None
        return {
            "hit": hit,
            "ids": np.stack([e.ids for e in rows]),
            "dists": np.stack([e.dists for e in rows]),
            "p_hat": np.asarray([e.p_hat for e in rows], np.float32),
            "routed_brute": np.asarray([e.routed_brute for e in rows], bool),
        }

    def record_result(self, queries: np.ndarray, programs: dict,
                      opts: SearchOptions, ids, dists, p_hat,
                      routed_brute) -> None:
        """Optional router hook: store freshly computed per-query results."""
        with self._lock:
            self._record_result(queries, programs, opts, ids, dists, p_hat,
                                routed_brute)

    def _record_result(self, queries, programs, opts, ids, dists, p_hat,
                       routed_brute):
        if not self.semantic_cache.enabled:
            return
        programs, scopes = _split_scope(programs)
        queries = to_host(queries).astype(np.float32, copy=False)
        sigs = self._signatures(programs)
        ids, dists, p_hat, routed_brute = (
            to_host(a) for a in (ids, dists, p_hat, routed_brute))
        for i, sig in enumerate(sigs):
            scope = int(scopes[i]) if scopes is not None else 0
            self.semantic_cache.put(sig, opts, queries[i], ids[i], dists[i],
                                    float(p_hat[i]), bool(routed_brute[i]),
                                    scope=scope)

    # -- selectivity layer ----------------------------------------------------
    def estimate(self, programs: dict, valid=None):
        with self._lock:
            return self._estimate(programs, valid)

    def _estimate(self, programs, valid=None):
        self._sync_epoch()
        # the selectivity layer is scope-blind (p_hat is data, not tenant);
        # the sidecar is stripped so the inner backend never sees it
        programs, _ = _split_scope(programs)
        sigs = self._signatures(programs)
        b = len(sigs)
        # pad rows (valid False) never touch the cache: no phantom
        # always-false entries, no inflated hit/miss counters (same
        # hygiene as search_brute); their p_hat is 0, sliced off upstream
        real = (range(b) if valid is None
                else np.nonzero(to_host(valid).astype(bool))[0])
        p_hat = np.zeros((b,), np.float32)
        first_row: dict[str, int] = {}   # sig -> first miss row
        for i in real:
            cached = self.selectivity_cache.get(sigs[i])
            if cached is not None:
                p_hat[i] = cached
            elif sigs[i] not in first_row:
                first_row[sigs[i]] = int(i)
        if first_row:
            rows = np.asarray(sorted(first_row.values()), np.int64)
            sub = take_programs(programs, rows)
            if self._batch is None:
                fresh = to_host(self.inner.estimate(sub)).astype(np.float32)
            else:
                sub, sub_valid = batching.pad_programs(self._batch, sub)
                fresh = to_host(self.inner.estimate(
                    sub, valid=sub_valid)).astype(np.float32)[:len(rows)]
            by_sig = {sigs[r]: fresh[j] for j, r in enumerate(rows)}
            for sig, p in by_sig.items():
                self.selectivity_cache.put(sig, float(p))
            for i in real:
                if sigs[i] in by_sig:
                    p_hat[i] = by_sig[sigs[i]]
        return p_hat

    # -- graph route: pass-through --------------------------------------------
    def search_graph(self, queries, programs: dict, p_hat,
                     opts: SearchOptions, valid=None) -> dict:
        with self._lock:
            self._sync_epoch()
            programs, _ = _split_scope(programs)
        # pass-through dispatch needs no cache state: drop the lock first
        return self.inner.search_graph(queries, programs, p_hat, opts,
                                       valid=valid)

    # -- candidate layer: brute route -----------------------------------------
    def _extension(self, programs: dict, row: int) -> np.ndarray:
        """Exact matching-ID set of one program row over the full corpus."""
        _, _, ints, floats = self._corpus()
        mask = F.eval_program(_host_programs(programs, row), ints, floats)
        return np.nonzero(mask.numpy())[0].astype(np.int64)

    def _delta_extension(self, delta, programs: dict, row: int):
        """Live delta rows matching one program row, as (ids, vectors,
        norms) ready to fold into a candidate block -- None when the delta
        contributes nothing (empty, all dead, or no row matches)."""
        cnt = delta.count
        if delta.live_count == 0:
            return None
        m = F.eval_program(_host_programs(programs, row), delta.ints[:cnt],
                           delta.floats[:cnt]).numpy()
        m &= delta.alive[:cnt]
        slots = np.nonzero(m)[0]
        if not len(slots):
            return None
        return (delta.ids[slots], delta.vectors[slots], delta.norms[slots])

    def _scan_block(self, queries: np.ndarray, cand: np.ndarray, k: int,
                    extra=None):
        """Exact top-k of ``queries`` over the candidate rows: the same
        qn + vn - 2*q.v distance the PreFBF scan computes, restricted to the
        predicate's true extension (so results match the full scan).
        ``extra`` -- (ids, vectors, norms) of matching live delta rows --
        extends the block with out-of-base rows at their global ids."""
        vectors, norms, _, _ = self._corpus()
        v = vectors[cand]                      # (C, d)
        vn = norms[cand]                       # (C,)
        id_map = cand
        if extra is not None:
            eids, ev, en = extra
            v = np.concatenate([v, ev], axis=0)
            vn = np.concatenate([vn, en])
            id_map = np.concatenate([cand, eids])
        qn = np.einsum("bd,bd->b", queries, queries).astype(np.float32)
        d2 = qn[:, None] + vn[None, :] - 2.0 * (queries @ v.T)
        dist = np.sqrt(np.maximum(d2, 0.0), dtype=np.float32)
        c = dist.shape[1]
        ids = np.full((len(queries), k), -1, np.int64)
        out = np.full((len(queries), k), np.inf, np.float32)
        kk = min(k, c)
        if kk:  # an always-false predicate has an empty (legal) extension
            part = np.argpartition(dist, kk - 1, axis=1)[:, :kk]
            pd = np.take_along_axis(dist, part, axis=1)
            order = np.argsort(pd, axis=1, kind="stable")
            ids[:, :kk] = id_map[np.take_along_axis(part, order, axis=1)]
            out[:, :kk] = np.take_along_axis(pd, order, axis=1)
        return ids, out

    def _inner_brute(self, queries, programs: dict, rows,
                     opts: SearchOptions):
        """Run the inner brute scan on a row subset, re-bucketing the
        sub-batch when ``opts.batch`` is set: the cache split re-introduces
        data-dependent miss counts, so shape stability must be restored
        before the inner call.  The sub-batch is sliced on the queries'
        device; the results come back to the host."""
        sub_q = queries.index_select(
            0, torch.as_tensor(rows, device=queries.device))
        sub_p = take_programs(programs, rows)
        if opts.batch is None:
            mid, md = self.inner.search_brute(sub_q, sub_p, opts)
        else:
            sub_q, sub_p, _, sub_valid = batching.pad_to_bucket(
                opts.batch, sub_q, sub_p)
            mid, md = self.inner.search_brute(sub_q, sub_p, opts,
                                              valid=sub_valid)
        return to_host(mid)[:len(rows)], to_host(md)[:len(rows)]

    def search_brute(self, queries, programs: dict, opts: SearchOptions,
                     valid=None):
        with self._lock:
            return self._search_brute(queries, programs, opts, valid)

    def _search_brute(self, queries, programs, opts, valid=None):
        self._sync_epoch()
        programs, scopes = _split_scope(programs)
        b = int(queries.shape[0])
        # this layer is host-side: pad rows (valid False) are dropped here
        # and the inner call is re-bucketed in _inner_brute, so
        # they never pollute signatures, counters or admission
        real = (np.arange(b) if valid is None
                else np.nonzero(to_host(valid).astype(bool))[0])
        # a compressed (ADC) scan is not the exact-distance computation the
        # candidate block runs, so use_pq bypasses this layer entirely
        serveable = (self.candidate_cache.enabled and not opts.use_pq
                     and self._corpus() is not None)
        if not serveable:
            if self.candidate_cache.enabled:
                self.candidate_cache.bypasses += int(len(real))
            return self.inner.search_brute(queries, programs, opts,
                                           valid=valid)

        queries_np = to_host(queries).astype(np.float32, copy=False)
        sigs = self._signatures(programs)
        scope_of = (lambda i: int(scopes[i])) if scopes is not None \
            else (lambda i: 0)
        ids = np.full((b, opts.k), -1, np.int64)
        dists = np.full((b, opts.k), np.inf, np.float32)

        # candidate bookkeeping is keyed on (scope, signature): blocks
        # cached by one tenant never serve another, per the isolation
        # contract (the extension itself is tenant-independent, so the
        # cost of isolation is duplicate entries, not wrong results)
        hit_rows: dict[tuple, list[int]] = {}
        blocks: dict[tuple, np.ndarray] = {}
        miss: list[int] = []
        for i in real:
            skey = (scope_of(i), sigs[i])
            # one get() per ROW (not per unique signature) so the reported
            # hit/miss counters reflect served lookups, not distinct keys
            cand = self.candidate_cache.get(sigs[i], scope=skey[0])
            if cand is None:
                miss.append(int(i))
                continue
            blocks[skey] = cand
            hit_rows.setdefault(skey, []).append(int(i))

        lv = self._live_view() if hit_rows else None
        for skey, rows in hit_rows.items():
            # compose the live state over the cached base extension: dead
            # base rows drop out, matching live delta rows join at their
            # global ids -- warm blocks stay exact under streaming mutation
            cand = blocks[skey]
            extra = None
            if lv is not None:
                if lv.base_alive is not None:
                    cand = cand[lv.base_alive[cand]]
                extra = self._delta_extension(lv.delta, programs, rows[0])
                if lv.base_alive is not None or extra is not None:
                    self.candidate_cache.composed += len(rows)
            rid, rd = self._scan_block(queries_np[rows], cand, opts.k,
                                       extra=extra)
            ids[rows] = rid
            dists[rows] = rd

        if miss:
            rows = np.asarray(miss, np.int64)
            mid, md = self._inner_brute(queries, programs, rows, opts)
            ids[rows] = mid
            dists[rows] = md
            n_rows = self._corpus()[0].shape[0]
            miss_first: dict[tuple, int] = {}  # one reference per key per batch
            for i in miss:
                miss_first.setdefault((scope_of(i), sigs[i]), i)
            for (scope, sig), i in miss_first.items():
                seen = self._brute_seen.get((scope, sig), 0)
                if seen == _REJECTED:
                    continue  # known-ineligible: never recompute extensions
                self._brute_seen.put((scope, sig), seen + 1)
                if seen < 1:
                    continue  # first miss: one-off filters stay free
                # second miss: admit.  A cached estimate far above the
                # admission bound rejects without the O(N) extension pass
                # (2x slack absorbs sample-estimator error)
                p_est = self.selectivity_cache.peek(sig)
                if p_est is not None and p_est > 2.0 * self.candidate_cache.p_max:
                    self._brute_seen.put((scope, sig), _REJECTED)
                    self.candidate_cache.bypasses += 1
                    continue
                if not self.candidate_cache.admit(
                        sig, self._extension(programs, i), n_rows,
                        scope=scope):
                    self._brute_seen.put((scope, sig), _REJECTED)
        return ids, dists

    # -- accounting -----------------------------------------------------------
    def cache_stats(self) -> dict:
        """Per-layer hit/miss/bypass counters (surfaced by ServeEngine)."""
        with self._lock:
            return self._cache_stats()

    def _cache_stats(self) -> dict:
        out = {
            "selectivity": self.selectivity_cache.stats(),
            "candidates": self.candidate_cache.stats(),
            "semantic": self.semantic_cache.stats(),
            "epoch": self._epoch,
            "versions": dict(self._versions) if self._versions else None,
            "invalidations": self.invalidations,
            "scopes": dict(self._scope_ids),
        }
        for layer in ("selectivity", "candidates", "semantic"):
            st = out[layer]
            asked = st["hits"] + st["misses"]
            st["hit_rate"] = st["hits"] / asked if asked else 0.0
        return out
