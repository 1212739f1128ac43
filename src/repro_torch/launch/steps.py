"""Step functions of the LM substrate on one device (port of the one-device
half of the reference's ``launch/steps.py``): the optimizer, the train step
and the serve step that ``launch/train.py`` and ``launch/serve.py`` drive.

The train step differentiates ``models.model.loss_fn`` with its defaults,
so every kernel is off (``use_flash=False``, ``use_ssm_kernel=False``), as
in the reference: no Hopper kernel has a backward pass, and the reference's
Pallas kernels have no ``custom_vjp``.  Parameters and the optimizer state
are updated IN PLACE, where the reference donates them to its jitted step;
the step returns the same objects so callers can keep the reference's
``params, opt_state, metrics = step(params, opt_state, batch)``.

The reference's sharding half (``param_pspecs``, ``batch_specs``,
``cache_pspecs``, ``zero1_specs``, ``input_specs`` / ``LoweringBundle``)
has no counterpart on one device.
"""

from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.models.common import dtype_of, tree_leaves, tree_map
from repro_torch.optim import adamw, apply_updates, global_norm_clip


def make_optimizer(cfg, lr=3e-4):
    """AdamW with the LM recipe's betas and decay (``lr`` a float or a
    schedule)."""
    return adamw(lr, b1=0.9, b2=0.95, weight_decay=0.1)


def loss_and_grads(params, batch, cfg):
    """``(loss, metrics, grads)`` of ``M.loss_fn`` at ``params`` (kernels
    off): the gradient of every leaf, taken on detached copies so the
    caller can update ``params`` in place; metrics detached."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    proxy = tree_map(lambda _: next(it), params)
    loss, metrics = M.loss_fn(proxy, batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    git = iter(grads)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(git), params))


def make_train_step(cfg, opt=None, clip_norm: float = 1.0):
    """``(train_step, opt)``: ``train_step(params, opt_state, batch) ->
    (params, opt_state, metrics)`` takes one optimizer step in place —
    gradients cast to ``cfg.grad_sync_dtype`` where set (the reference
    casts before its data-parallel all-reduce), clipped to global norm
    ``clip_norm``, the optimizer's update applied — and returns the
    loss's metrics with ``grad_norm`` (before clipping)."""
    opt = opt or make_optimizer(cfg)

    def train_step(params, opt_state, batch):
        _, metrics, grads = loss_and_grads(params, batch, cfg)
        if cfg.grad_sync_dtype:
            gd = dtype_of(cfg.grad_sync_dtype)
            grads = tree_map(lambda g: g.to(gd), grads)
        grads, gnorm = global_norm_clip(grads, clip_norm)
        with torch.no_grad():
            apply_updates(params, opt.update(grads, opt_state, params))
        return params, opt_state, dict(metrics, grad_norm=gnorm)

    return train_step, opt


def make_serve_step(cfg):
    """``serve_step(params, cache, tokens, index) -> (logits, cache)``: one
    decode step (``M.decode_step``)."""

    def serve_step(params, cache, tokens, index):
        return M.decode_step(params, cache, tokens, index, cfg)

    return serve_step
