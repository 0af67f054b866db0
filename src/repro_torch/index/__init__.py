"""Live-index mutation subsystem: streaming upsert/delete over a built index.

The serving index stays a *static* artifact (the HNSW arrays + padded scan
arrays on the device); mutations accumulate beside it in three small pieces
that every query path composes at serve time:

  DeltaSegment     -- append-only buffer of fresh rows, brute-scanned per
                      query (exact f32 PreFBF over a pow-2-padded buffer)
                      and top-k-merged into every route's results.
  tombstones       -- a base-row alive bitmask: +inf norms on the brute
                      scans, an ``alive`` gate on the graph traversal, so
                      dead ids never surface.
  ComponentEpochs  -- scoped version counters (vectors / attributes / graph).

``merge()`` (index.bulk) folds the delta back into the HNSW with a bulk
build whose candidate search runs on the device, returning the index to the
static fast path.  IDs are dense row positions: a replaced row retires its
id and the new row gets a fresh one, so merge never renumbers surviving
rows.
"""
from .bulk import build_hnsw_bulk, bulk_add
from .delta import DeltaSegment, compose_topk, compose_topk_dev
from .epochs import COMPONENTS, ComponentEpochs
from .live import LiveState, LiveView

__all__ = ["DeltaSegment", "compose_topk", "compose_topk_dev",
           "ComponentEpochs", "COMPONENTS", "LiveState", "LiveView",
           "bulk_add", "build_hnsw_bulk"]
