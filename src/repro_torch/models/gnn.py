"""GCN (Kipf & Welling, arXiv:1609.02907) via edge-index message passing.

An edge-index (2, E) int32 array drives gather -> scale-by-sym-norm ->
``index_add_`` scatter (the JAX package's ``segment_sum``; atomics on the
card, so the sum's order -- and its last bits -- may differ from run to
run).  Edges are padded with (-1, -1) rows (weight 0) so every shape is
static; degree normalization assumes self-loops were added by the data
pipeline.

Covers full-graph node classification, sampled subgraphs (the neighbor
sampler in data/graphs.py produces padded static-shape subgraphs) and
batched small graphs (molecule) via block-diagonal batching + a mean-pool
graph readout.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .module import Ctx, ParamModule, fan_in_init, init_with_axes, zeros_init


@dataclass(frozen=True)
class GCNConfig:
    name: str
    n_layers: int = 2
    d_feat: int = 1433
    d_hidden: int = 16
    n_classes: int = 7
    norm: str = "sym"          # symmetric normalization (paper)
    readout: str = "node"      # "node" | "graph" (molecule cells)
    dropout: float = 0.0       # (inference path ignores)

    def dims(self):
        dims = [self.d_feat] + [self.d_hidden] * (self.n_layers - 1) + [self.n_classes]
        return list(zip(dims[:-1], dims[1:]))


def init_gcn(ctx: Ctx, cfg: GCNConfig):
    for i, (din, dout) in enumerate(cfg.dims()):
        sc = ctx.scope(f"conv{i}")
        sc.param("w", (din, dout), ("feat", "hidden"), fan_in_init())
        sc.param("b", (dout,), ("hidden",), zeros_init())
    if cfg.readout == "graph":
        sc = ctx.scope("head")
        sc.param("w", (cfg.n_classes, cfg.n_classes), ("hidden", "hidden"),
                 fan_in_init())
        sc.param("b", (cfg.n_classes,), ("hidden",), zeros_init())


def _sym_coeff(edges, deg):
    """1/sqrt(deg_src * deg_dst) in f32; padded edges (src = -1) get
    weight 0."""
    src, dst = edges[0], edges[1]
    ok = src >= 0
    s = torch.clamp(src, min=0).long()
    d = torch.clamp(dst, min=0).long()
    c = torch.rsqrt(torch.clamp(deg[s] * deg[d], min=1.0).float())
    return torch.where(ok, c, 0.0), s, d


def _segment_sum(x, seg, n: int):
    return torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                       device=x.device).index_add_(0, seg, x)


@torch.no_grad()
def gcn_forward(params, cfg: GCNConfig, x, edges, deg, graph_ids=None,
                n_graphs: int = 0):
    """x (N, F); edges (2, E) int32 with -1 padding; deg (N,) float
    (in-degree + self-loop).  graph_ids (N,) for graph readout."""
    n = x.shape[0]
    coeff, s, d = _sym_coeff(edges, deg)
    h = x
    n_conv = len(cfg.dims())
    for i in range(n_conv):
        h = h @ params[f"conv{i}"]["w"]                     # (N, dout) first: cheaper gather
        msg = h[s] * coeff[:, None]                          # (E, dout)
        h = _segment_sum(msg, d, n)
        h = h + params[f"conv{i}"]["b"]
        if i < n_conv - 1:
            h = torch.relu(h)
    if cfg.readout == "graph":
        if graph_ids is None:
            raise ValueError("graph readout needs graph_ids")
        gid = torch.clamp(graph_ids, min=0).long()
        pooled = _segment_sum(h, gid, n_graphs)
        cnt = _segment_sum(torch.ones((n, 1), dtype=h.dtype, device=h.device),
                           gid, n_graphs)
        pooled = pooled / torch.clamp(cnt, min=1.0)          # mean pool
        h = torch.relu(pooled) @ params["head"]["w"] + params["head"]["b"]
    return h


@torch.no_grad()
def gcn_loss(params, cfg: GCNConfig, x, edges, deg, labels, mask,
             graph_ids=None, n_graphs: int = 0):
    """Masked softmax cross entropy (mask: which nodes/graphs are labeled)."""
    logits = gcn_forward(params, cfg, x, edges, deg, graph_ids, n_graphs)
    logp = torch.log_softmax(logits.float(), dim=-1)
    lbl = torch.clamp(labels, min=0).long()
    nll = -torch.gather(logp, -1, lbl[:, None])[:, 0]
    w = mask.float()
    denom = torch.clamp(w.sum(), min=1.0)
    loss = torch.sum(nll * w) / denom
    acc = torch.sum((logits.argmax(-1) == labels) * w) / denom
    return loss, {"ce_loss": loss, "acc": acc}


class GCN(ParamModule):
    """The GCN as an ``nn.Module`` (parameters ``conv0.w``, ...):
    ``forward(x, edges, deg, graph_ids=None, n_graphs=0)``."""

    def __init__(self, cfg: GCNConfig, params: dict | None = None, *,
                 seed: int = 0, dtype=torch.float32, device=None):
        if params is None:
            params, _ = init_with_axes(init_gcn, seed, cfg, dtype=dtype,
                                       device=device)
        super().__init__(params)
        self.cfg = cfg

    def forward(self, x, edges, deg, graph_ids=None, n_graphs: int = 0):
        return gcn_forward(self.tree(), self.cfg, x, edges, deg, graph_ids,
                           n_graphs)
