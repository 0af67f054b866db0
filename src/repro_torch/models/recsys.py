"""RecSys architectures: FM, Wide&Deep, DIEN (GRU + AUGRU), DLRM (dot).

Embedding tables are stacked per-field tables (F, V, d) and lookups are
gathers, as in the JAX package (uniform per-field vocab keeps shapes
static).  The forwards and losses build an autograd graph when the
parameters require grad; the retrieval layer serves under ``no_grad``.

``retrieval_cand`` cells use the factorized dot-scoring form (two-tower /
FM retrieval): a user vector against the item-embedding table, served by
FAVOR's fused ``filtered_topk`` kernel -- the paper's technique as the
retrieval layer.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import filters as F
from ..kernels.filtered_topk import ops as ft
from .module import (Ctx, ParamModule, fan_in_init, init_with_axes,
                     normal_init, zeros_init)

# candidate rows per filter-program chunk on the dot-scoring path: the
# program's (B, W, rows) intermediates stay small at a million candidates
MASK_CHUNK = 65536


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------
def init_tables(ctx: Ctx, name: str, n_fields: int, vocab: int, dim: int):
    ctx.param(name, (n_fields, vocab, dim), ("fields", "table", "embed_dim"),
              normal_init(0.01))


def lookup(tables, ids):
    """tables (F, V, d); ids (B, F) -> (B, F, d)."""
    f = tables.shape[0]
    return tables[torch.arange(f, device=ids.device)[None, :], ids.long()]


def init_mlp_stack(ctx: Ctx, name: str, dims: list[int]):
    sc = ctx.scope(name)
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        sc.param(f"w{i}", (a, b), ("feat", "mlp"), fan_in_init())
        sc.param(f"b{i}", (b,), ("mlp",), zeros_init())


def apply_mlp_stack(params, x, n: int, final_act: bool = False):
    for i in range(n):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n - 1 or final_act:
            x = torch.relu(x)
    return x


def bce_loss(logit, label):
    logit = logit.float()
    return torch.mean(torch.clamp(logit, min=0) - logit * label +
                      torch.log1p(torch.exp(-torch.abs(logit))))


# ---------------------------------------------------------------------------
# FM  (Rendle ICDM'10)  -- O(nk) sum-square trick
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class FMConfig:
    name: str = "fm"
    n_sparse: int = 39
    vocab: int = 1_000_000
    embed_dim: int = 10


def init_fm(ctx: Ctx, cfg: FMConfig):
    ctx.param("w0", (1,), ("stats",), zeros_init())
    ctx.param("w_lin", (cfg.n_sparse, cfg.vocab, 1), ("fields", "table", "embed_dim"),
              normal_init(0.01))
    init_tables(ctx, "v", cfg.n_sparse, cfg.vocab, cfg.embed_dim)


def fm_forward(params, cfg: FMConfig, ids):
    """ids (B, F) -> logit (B,).  Pairwise interactions via
    0.5 * ((sum_f v_f)^2 - sum_f v_f^2) summed over the latent dim."""
    lin = lookup(params["w_lin"], ids)[..., 0].sum(dim=1)        # (B,)
    e = lookup(params["v"], ids)                                  # (B, F, k)
    s = e.sum(dim=1)                                              # (B, k)
    fm = 0.5 * (s * s - (e * e).sum(dim=1)).sum(dim=-1)           # (B,)
    return params["w0"][0] + lin + fm


def fm_loss(params, cfg: FMConfig, ids, labels):
    loss = bce_loss(fm_forward(params, cfg, ids), labels)
    return loss, {"bce": loss}


# ---------------------------------------------------------------------------
# Wide & Deep  (arXiv:1606.07792)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class WideDeepConfig:
    name: str = "wide-deep"
    n_sparse: int = 40
    vocab: int = 1_000_000
    embed_dim: int = 32
    mlp: tuple = (1024, 512, 256)


def init_wide_deep(ctx: Ctx, cfg: WideDeepConfig):
    ctx.param("wide", (cfg.n_sparse, cfg.vocab, 1),
              ("fields", "table", "embed_dim"), normal_init(0.01))
    init_tables(ctx, "deep_emb", cfg.n_sparse, cfg.vocab, cfg.embed_dim)
    dims = [cfg.n_sparse * cfg.embed_dim, *cfg.mlp, 1]
    init_mlp_stack(ctx, "deep_mlp", dims)


def wide_deep_forward(params, cfg: WideDeepConfig, ids):
    wide = lookup(params["wide"], ids)[..., 0].sum(dim=1)
    e = lookup(params["deep_emb"], ids).reshape(ids.shape[0], -1)
    deep = apply_mlp_stack(params["deep_mlp"], e, len(cfg.mlp) + 1)[:, 0]
    return wide + deep


def wide_deep_loss(params, cfg: WideDeepConfig, ids, labels):
    loss = bce_loss(wide_deep_forward(params, cfg, ids), labels)
    return loss, {"bce": loss}


# ---------------------------------------------------------------------------
# DIEN  (arXiv:1809.03672)  -- interest extraction GRU + AUGRU evolution
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class DIENConfig:
    name: str = "dien"
    vocab: int = 1_000_000
    embed_dim: int = 18
    seq_len: int = 100
    gru_dim: int = 108
    mlp: tuple = (200, 80)
    unroll: bool = False  # dry-run only (not ported): the loops are unrolled


def _init_gru(ctx: Ctx, name: str, d_in: int, d_h: int):
    sc = ctx.scope(name)
    sc.param("wx", (d_in, 3 * d_h), ("feat", "hidden"), fan_in_init())
    sc.param("wh", (d_h, 3 * d_h), ("hidden", "hidden"), fan_in_init())
    sc.param("b", (3 * d_h,), ("hidden",), zeros_init())


def _gru_cell(p, h, x, a=None):
    """Standard GRU; if attention score ``a`` is given, AUGRU: z <- a*z."""
    gx = x @ p["wx"] + p["b"]
    gh = h @ p["wh"]
    dh = h.shape[-1]
    r = torch.sigmoid(gx[..., :dh] + gh[..., :dh])
    z = torch.sigmoid(gx[..., dh:2 * dh] + gh[..., dh:2 * dh])
    n = torch.tanh(gx[..., 2 * dh:] + r * gh[..., 2 * dh:])
    if a is not None:
        z = a[..., None] * z
    return (1.0 - z) * h + z * n


def init_dien(ctx: Ctx, cfg: DIENConfig):
    init_tables(ctx, "item_emb", 1, cfg.vocab, cfg.embed_dim)
    _init_gru(ctx, "gru1", cfg.embed_dim, cfg.gru_dim)
    _init_gru(ctx, "augru", cfg.gru_dim, cfg.gru_dim)
    sc = ctx.scope("att")
    sc.param("w", (cfg.gru_dim + cfg.embed_dim, 1), ("feat", "embed_dim"),
             fan_in_init())
    dims = [cfg.gru_dim + cfg.embed_dim, *cfg.mlp, 1]
    init_mlp_stack(ctx, "head", dims)


def dien_forward(params, cfg: DIENConfig, hist, target):
    """hist (B, S) behavior ids (-1 pad); target (B,) item id -> logit (B,)."""
    b, s = hist.shape
    emb = params["item_emb"][0]                                    # (V, d)
    he = emb[torch.clamp(hist, min=0).long()] * (hist >= 0)[..., None]
    te = emb[target.long()]                                        # (B, d)

    p1 = params["gru1"]
    h0 = torch.zeros((b, cfg.gru_dim), dtype=he.dtype, device=he.device)
    states = he.new_empty((b, s, cfg.gru_dim))                     # (B, S, gru)
    h = h0
    for t in range(s):
        h = _gru_cell(p1, h, he[:, t])
        states[:, t] = h

    # attention of each interest state on the target item
    att_in = torch.cat(
        [states, te[:, None, :].expand(b, s, cfg.embed_dim)], -1)
    scores = (att_in @ params["att"]["w"])[..., 0]                 # (B, S)
    scores = torch.where(hist >= 0, scores, -1e30)
    a = torch.softmax(scores.float(), dim=-1).to(he.dtype)

    p2 = params["augru"]
    h = h0
    for t in range(s):
        h = _gru_cell(p2, h, states[:, t], a[:, t])

    z = torch.cat([h, te], dim=-1)
    return apply_mlp_stack(params["head"], z, len(cfg.mlp) + 1)[:, 0]


def dien_loss(params, cfg: DIENConfig, hist, target, labels):
    loss = bce_loss(dien_forward(params, cfg, hist, target), labels)
    return loss, {"bce": loss}


# ---------------------------------------------------------------------------
# DLRM-RM2  (arXiv:1906.00091)  -- bottom MLP + dot interaction + top MLP
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-rm2"
    n_dense: int = 13
    n_sparse: int = 26
    vocab: int = 1_000_000
    embed_dim: int = 64
    bot_mlp: tuple = (512, 256, 64)
    top_mlp: tuple = (512, 512, 256)


def init_dlrm(ctx: Ctx, cfg: DLRMConfig):
    init_tables(ctx, "emb", cfg.n_sparse, cfg.vocab, cfg.embed_dim)
    init_mlp_stack(ctx, "bot", [cfg.n_dense, *cfg.bot_mlp])
    n_vec = cfg.n_sparse + 1
    d_int = n_vec * (n_vec - 1) // 2 + cfg.embed_dim
    init_mlp_stack(ctx, "top", [d_int, *cfg.top_mlp, 1])


def dlrm_forward(params, cfg: DLRMConfig, dense, ids):
    """dense (B, 13) f32; ids (B, 26) int32 -> logit (B,)."""
    x = apply_mlp_stack(params["bot"], dense, len(cfg.bot_mlp), final_act=True)
    e = lookup(params["emb"], ids)                           # (B, 26, 64)
    vecs = torch.cat([x[:, None, :], e], dim=1)              # (B, 27, 64)
    gram = torch.bmm(vecs, vecs.transpose(1, 2))             # (B, 27, 27)
    n_vec = cfg.n_sparse + 1
    iu, ju = torch.triu_indices(n_vec, n_vec, offset=1, device=gram.device)
    inter = gram[:, iu, ju]                                  # (B, 351)
    z = torch.cat([x, inter], dim=-1)
    return apply_mlp_stack(params["top"], z, len(cfg.top_mlp) + 1)[:, 0]


def dlrm_loss(params, cfg: DLRMConfig, dense, ids, labels):
    loss = bce_loss(dlrm_forward(params, cfg, dense, ids), labels)
    return loss, {"bce": loss}


# ---------------------------------------------------------------------------
# Retrieval scoring (retrieval_cand cells) -- FAVOR as the retrieval layer
# ---------------------------------------------------------------------------
def retrieval_scores(user_vec, item_table):
    """Factorized dot scoring: (B, d) x (N, d) -> (B, N)."""
    return user_vec @ item_table.T


@torch.no_grad()
def retrieval_topk_filtered(user_vec, item_table, programs, attrs_int,
                            attrs_float, k: int = 100,
                            use_kernel: bool = False):
    """Top-k candidates under attribute filters: ids (B, k) and scores
    (B, k), -inf where fewer than k items pass.

    ``use_kernel`` serves them through FAVOR's fused ``filtered_topk``
    (the kernel for CUDA tensors, its plain version for CPU tensors; k
    above the kernel's list length runs chained passes).  Max-inner-product
    -> min-L2 uses the exact augmentation reduction (Shrivastava & Li):
    every item gets the *constant* augmented norm M^2 = max_row |v|^2 (the
    virtual extra coordinate sqrt(M^2 - |v|^2) contributes nothing to q.v
    since the query's extra coordinate is 0), so d2 = M^2 + |q|^2 - 2 q.v
    is >= (M - |q|)^2 >= 0 and exactly MIP-ordered.  The kernel's TF32
    screen stays sound under these norms: its margin scales with |v| taken
    from the row itself, never from ``norms`` (csrc/filtered_topk.cu, "The
    screen").  Otherwise the plain dot-scoring path: one matmul, the filter
    mask, a stable top-k."""
    if use_kernel:
        m2 = torch.max(torch.sum(item_table * item_table, dim=-1))
        norms = torch.full((item_table.shape[0],), float(m2),
                           dtype=torch.float32, device=item_table.device)
        ids, d = ft.filtered_topk(item_table, norms, attrs_int, attrs_float,
                                  user_vec, programs, k=k)
        qn = torch.sum(user_vec * user_vec, dim=-1, keepdim=True)
        scores = 0.5 * (m2 + qn - d * d)       # invert the reduction
        return ids, torch.where(ids >= 0, scores, -torch.inf)
    scores = retrieval_scores(user_vec, item_table)
    for s in range(0, item_table.shape[0], MASK_CHUNK):
        mask = F.eval_program_batched(programs, attrs_int[s:s + MASK_CHUNK],
                                      attrs_float[s:s + MASK_CHUNK])
        scores[:, s:s + MASK_CHUNK].masked_fill_(~mask, -torch.inf)
    order = torch.sort(scores, dim=-1, descending=True,
                       stable=True).indices[:, :k]
    return order.to(torch.int32), torch.gather(scores, 1, order)


# ---------------------------------------------------------------------------
# The models as nn.Modules over their param trees
# ---------------------------------------------------------------------------
class _Recsys(ParamModule):
    _init = None
    _forward = None

    def __init__(self, cfg, params: dict | None = None, *, seed: int = 0,
                 dtype=torch.float32, device=None):
        if params is None:
            params, _ = init_with_axes(type(self)._init, seed, cfg,
                                       dtype=dtype, device=device)
        super().__init__(params)
        self.cfg = cfg

    def forward(self, *inputs):
        return type(self)._forward(self.tree(), self.cfg, *inputs)


class FM(_Recsys):
    """FM: ``forward(ids)``."""
    _init, _forward = init_fm, fm_forward


class WideDeep(_Recsys):
    """Wide & Deep: ``forward(ids)``."""
    _init, _forward = init_wide_deep, wide_deep_forward


class DIEN(_Recsys):
    """DIEN: ``forward(hist, target)``."""
    _init, _forward = init_dien, dien_forward


class DLRM(_Recsys):
    """DLRM: ``forward(dense, ids)``."""
    _init, _forward = init_dlrm, dlrm_forward
