"""Train-step factory: gradients + optimizer update, with optional
microbatch gradient accumulation, a gradient compression hook, and
in-place updates.

``make_train_step(loss_fn, opt_cfg, microbatches)`` returns
``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
  * the gradients are ``torch.autograd.grad`` of the loss over detached
    copies of the parameter leaves (the caller's tensors never require
    grad, so serving the same tree builds no graph); it composes with the
    models' ``torch.utils.checkpoint`` layers;
  * microbatches > 1 splits every batch leaf (B, ...) into ``m`` slices of
    B/m rows and accumulates their gradients into f32 zeros, one slice
    after the other (the JAX package's ``lax.scan``, in its order): the
    activation-memory lever for the big train shapes;
  * the optional ``compress`` hook (training/compression.py) maps the
    gradients before the update;
  * ``donate`` updates the parameters and the optimizer state in place
    (the JAX package's ``donate_argnums``): the step returns the trees it
    was given, holding the new values.

The port trains on one device: there is no data-parallel all-reduce, and
``jit_train_step`` refuses shardings.
"""
from __future__ import annotations

import torch

from . import optimizer as opt


def _batch_slice(batch, i: int, m: int):
    if isinstance(batch, dict):
        return {k: _batch_slice(v, i, m) for k, v in batch.items()}
    rows = batch.shape[0] // m
    return batch[i * rows:(i + 1) * rows]


def loss_and_grads(loss_fn, params, batch):
    """(loss, metrics, grads) of ``loss_fn(params, batch) -> (loss,
    metrics)``: ``torch.autograd.grad`` over detached leaves of ``params``
    (the counterpart of ``jax.value_and_grad(..., has_aux=True)``); the
    grads tree has the params' structure."""
    leaves = opt.tree_leaves(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    by_id = {id(p): q for p, q in zip(leaves, live)}
    with torch.enable_grad():
        loss, metrics = loss_fn(opt.tree_map(lambda p: by_id[id(p)], params),
                                batch)
        grads = torch.autograd.grad(loss, live)
    g_by_id = {id(p): g for p, g in zip(leaves, grads)}
    metrics = {k: v.detach() if torch.is_tensor(v) else v
               for k, v in metrics.items()}
    return loss.detach(), metrics, opt.tree_map(lambda p: g_by_id[id(p)],
                                                params)


def make_train_step(loss_fn, opt_cfg: opt.OptConfig, *, microbatches: int = 1,
                    compress=None, donate: bool = True):
    """loss_fn(params, batch) -> (loss, metrics dict)."""

    def step(params, opt_state, batch):
        if microbatches > 1:
            gsum = opt.tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            losses, metricses = [], []
            for i in range(microbatches):
                loss, metrics, grads = loss_and_grads(
                    loss_fn, params, _batch_slice(batch, i, microbatches))
                opt.tree_map(lambda a, g: a.add_(g), gsum, grads)
                losses.append(loss)
                metricses.append(metrics)
                del grads
            grads = opt.tree_map(lambda g: g / microbatches, gsum)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([torch.as_tensor(m[k]) for m in
                                       metricses]).mean()
                       for k in metricses[0]}
        else:
            loss, metrics, grads = loss_and_grads(loss_fn, params, batch)

        if compress is not None:
            grads = compress(grads)
        params, opt_state, om = opt.apply_updates(params, grads, opt_state,
                                                  opt_cfg, inplace=donate)
        metrics = {**metrics, **om, "loss": loss}
        return params, opt_state, metrics

    return step


def jit_train_step(step, mesh=None, in_shardings=None, out_shardings=None,
                   donate: bool = True):
    """The step as it is: torch runs it eagerly (donation is
    ``make_train_step``'s ``donate``).  The port trains on one device, so
    a mesh or shardings are refused, as ``models.module.constrain``
    refuses a mesh."""
    if mesh is not None or in_shardings is not None or \
            out_shardings is not None:
        raise NotImplementedError(
            "the port trains on one device: pass no mesh or shardings")
    return step
