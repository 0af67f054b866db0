"""Architecture registry plumbing: each configs/<arch>.py exposes ``spec()``
returning an ArchSpec with the exact published configuration, a reduced
config for CPU smoke tests, and its assigned shape cells.

The port's copy of the JAX package's ``repro.configs.base`` (pure
Python)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str            # train | prefill | decode | graph_train | serve | retrieval
    meta: dict
    skip: str | None = None  # reason when the cell is inapplicable


@dataclass
class ArchSpec:
    arch_id: str
    family: str          # lm | gnn | recsys
    source: str
    config: object       # full published config
    reduced: object      # smoke-test config
    cells: tuple
    notes: str = ""

    def cell(self, name: str) -> ShapeCell:
        for c in self.cells:
            if c.name == name:
                return c
        raise KeyError(name)


def lm_cells(long_ok: bool, arch: str) -> tuple:
    """The assigned LM shape set (seq_len x global_batch)."""
    skip = (None if long_ok else
            f"{arch} is pure full attention; 524k-token prefill is quadratic "
            "with no windowing to bound it (assignment rule; DESIGN.md section 5)")
    return (
        ShapeCell("train_4k", "train", {"seq": 4096, "batch": 256}),
        ShapeCell("prefill_32k", "prefill", {"seq": 32768, "batch": 32}),
        ShapeCell("decode_32k", "decode", {"seq": 32768, "batch": 128}),
        ShapeCell("long_500k", "decode", {"seq": 524288, "batch": 1}, skip=skip),
    )


RECSYS_CELLS = (
    ShapeCell("train_batch", "train", {"batch": 65536}),
    ShapeCell("serve_p99", "serve", {"batch": 512}),
    ShapeCell("serve_bulk", "serve", {"batch": 262144}),
    ShapeCell("retrieval_cand", "retrieval", {"batch": 1, "n_candidates": 1_000_000}),
)

GNN_CELLS = (
    ShapeCell("full_graph_sm", "graph_train",
              {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433}),
    ShapeCell("minibatch_lg", "graph_train",
              {"n_nodes": 232965, "n_edges": 114615892, "batch_nodes": 1024,
               "fanout": (15, 10), "d_feat": 602, "sampled": True}),
    ShapeCell("ogb_products", "graph_train",
              {"n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100}),
    ShapeCell("molecule", "graph_train",
              {"n_nodes": 30, "n_edges": 64, "batch": 128, "d_feat": 32,
               "graphs": True}),
)
