"""Perf variants over the port's dry run (the JAX package's
``launch/perf.py``).

Each variant is a named builder that reshapes ONE lever of a target cell;
``python -m repro_torch.launch.perf_run`` counts the step through
``dryrun.run_cell`` and appends the three roofline terms to
perf_results.json.  The count runs every layer, so a variant is a builder
alone (no depth probes).

Variants:
  lm:    chunked attention (attn_chunk), microbatch accumulation, remat off
  gnn:   bf16 message features, label-pruned final layer
  favor: selectivity-sample sizing, candidate-pool width, batch, DB size
         (the ``serve_graph`` cell is counted on one mesh cell's real
         tensors: ``cells.favor_graph_block``)
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs import get_spec
from ..models import gnn
from ..models.transformer import lm_loss
from ..training import optimizer as opt
from ..training.step import make_train_step
from . import cells as C


# ---------------------------------------------------------------------------
# LM variants
# ---------------------------------------------------------------------------
def lm_variant(arch: str, shape: str, *, attn_chunk: int = 0,
               microbatches: int = 1, remat: bool | None = None,
               capacity_factor: float = 0.0):
    def build(arch_, shape_, mesh):
        spec = get_spec(arch_)
        cfg = dataclasses.replace(
            spec.config, attn_chunk=attn_chunk,
            **({"remat": remat} if remat is not None else {}))
        if capacity_factor and cfg.moe:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=capacity_factor))
        spec2 = dataclasses.replace(spec, config=cfg)
        cell = C.build_lm_cell(spec2, spec.cell(shape_), mesh)
        if microbatches > 1 and spec.cell(shape_).kind == "train":
            ocfg = opt.OptConfig(total_steps=10000)

            def loss_fn(p, batch):
                return lm_loss(p, cfg, batch["tokens"], batch["labels"], mesh)

            cell.step_fn = make_train_step(loss_fn, ocfg,
                                           microbatches=microbatches)
            cell.note = (cell.note or "") + f" mb={microbatches}"
        return cell

    return build


# ---------------------------------------------------------------------------
# GNN variants (gcn ogb_products)
# ---------------------------------------------------------------------------
def gnn_variant(arch: str, shape: str, *, bf16_msgs: bool = False,
                label_prune: float = 0.0, bf16_end2end: bool = False):
    """bf16_msgs: cast hidden features to bf16 around the segment sum, so
    an edge-sharded all-reduce would carry half the bytes.
    label_prune: fraction of labeled nodes; the FINAL conv layer aggregates
    only edges into labeled nodes (receptive-field pruning)."""
    def build(arch_, shape_, mesh):
        spec = get_spec(arch_)
        cell0 = C.build_gnn_cell(spec, spec.cell(shape_), mesh)
        meta = spec.cell(shape_).meta
        n_classes = C._GNN_CLASSES[shape_]
        cfg = dataclasses.replace(spec.config, d_feat=meta["d_feat"],
                                  n_classes=n_classes)
        params_sds, opt_sds, batch_sds = cell0.args
        param_sh, opt_sh, bsh = cell0.in_shardings
        all_ax = tuple(mesh.axis_names)
        n_dev = mesh.devices.size

        n_labeled = 0
        if label_prune > 0:
            n = batch_sds["x"].shape[0]
            e = batch_sds["edges"].shape[1]
            n_labeled = max(1, int(n * label_prune))
            e_last = -(-max(1, int(e * label_prune)) // n_dev) * n_dev
            batch_sds = dict(batch_sds)
            batch_sds["final_edges"] = C.sds((2, e_last), torch.int32)
            batch_sds["label_idx"] = C.sds((n_labeled,), torch.int32)
            bsh = dict(bsh)
            bsh["final_edges"] = (None, all_ax)
            bsh["label_idx"] = ()

        ocfg = opt.OptConfig(total_steps=1000)

        def loss_fn(p, batch):
            return gnn_loss_opt(p, cfg, batch, bf16_msgs=bf16_msgs,
                                n_labeled=n_labeled, bf16_end2end=bf16_end2end)

        cell0.step_fn = make_train_step(loss_fn, ocfg)
        cell0.args = (params_sds, opt_sds, batch_sds)
        cell0.in_shardings = (param_sh, opt_sh, bsh)
        cell0.note = f"bf16_msgs={bf16_msgs} label_prune={label_prune}"
        return cell0

    return build


def gnn_loss_opt(params, cfg, batch, *, bf16_msgs: bool, n_labeled: int,
                 bf16_end2end: bool = False):
    """GCN loss with optional bf16 message casting and final-layer pruning.
    bf16_end2end keeps hidden features bf16 through relu/matmul."""
    x, edges, deg = batch["x"], batch["edges"], batch["deg"]
    labels, mask = batch["labels"], batch["mask"]
    n = x.shape[0]
    cast = (lambda t: t.to(torch.bfloat16)) if bf16_msgs else (lambda t: t)
    uncast = ((lambda t: t) if bf16_end2end else
              ((lambda t: t.float()) if bf16_msgs else (lambda t: t)))
    if bf16_end2end:
        x = x.to(torch.bfloat16)

    def linear(h, w):
        # torch's matmul takes one dtype: promote as jnp's does
        dt = torch.promote_types(h.dtype, w.dtype)
        return h.to(dt) @ w.to(dt)

    coeff, s, d = gnn._sym_coeff(edges, deg)
    h = x
    dims = cfg.dims()
    for i, _ in enumerate(dims[:-1]):
        h = linear(h, params[f"conv{i}"]["w"])
        msg = cast(h[s] * coeff[:, None].to(h.dtype))
        h = uncast(gnn._segment_sum(msg, d, n))
        h = torch.relu(h + params[f"conv{i}"]["b"])

    i_last = len(dims) - 1
    h = linear(h, params[f"conv{i_last}"]["w"])
    if n_labeled:
        fe = batch["final_edges"]
        li = batch["label_idx"].long()
        coeff_f, s_f, d_f = gnn._sym_coeff(fe, deg)
        msg = cast(h[s_f] * coeff_f[:, None].to(h.dtype))
        # d_f indexes into the compact labeled-row space [0, n_labeled)
        logits = uncast(gnn._segment_sum(msg, d_f, n_labeled))
        logits = logits + params[f"conv{i_last}"]["b"]
        lbl = labels[li]
        msk = mask[li]
    else:
        msg = cast(h[s] * coeff[:, None].to(h.dtype))
        logits = uncast(gnn._segment_sum(msg, d, n))
        logits = logits + params[f"conv{i_last}"]["b"]
        lbl, msk = labels, mask

    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, torch.clamp(lbl, min=0).long()[:, None])[:, 0]
    w = msk.float()
    loss = torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)
    return loss, {"ce_loss": loss}



# ---------------------------------------------------------------------------
# FAVOR variants
# ---------------------------------------------------------------------------
def favor_variant(arch: str, shape: str, *, sample_rate: float = 0.01,
                  cand_cap: int = 0, batch: int = 0, n: int = 0):
    """``sample_rate``: the selectivity sample's share of each shard's rows
    (``input_specs``); ``cand_cap``: the candidate pool's capacity
    (``SearchConfig.cand_cap``, 0 = ef); ``batch`` and ``n`` replace the
    config's serve batch and DB rows (0 keeps them)."""
    def build(arch_, shape_, mesh):
        spec = get_spec("favor-anns")
        cfg = spec.config
        if batch:
            cfg = dataclasses.replace(cfg, batch=batch)
        if n:
            cfg = dataclasses.replace(cfg, n=n)
        return C.favor_cell(
            cfg, shape_, spec.cell(shape_).meta["route"], mesh,
            sample_rate=sample_rate, cand_cap=cand_cap,
            note=f"sample_rate={sample_rate} ccap={cand_cap} b={batch}")

    return build
