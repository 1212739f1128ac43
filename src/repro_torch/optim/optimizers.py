"""Hand-written AdamW over nested dicts of tensors (port of the reference's
``optim/optimizers.py:38-69`` and ``apply_updates``).

``torch.optim.Adam`` places ``sqrt`` and ``eps`` differently from the
reference, so the update is spelled out in the reference's order:
``mu/c1``, ``sqrt(nu/c2) + eps``, moments in f32, an int32 step.

The port updates moments and parameters IN PLACE, where the reference
donates the state buffers to its jitted step.  A step tensor may carry
leading user dims (``(U,)`` for the stacked per-user optimizers); the bias
corrections then broadcast over each parameter's trailing dims.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.models.common import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable    # (params, lead=()) -> state
    update: Callable  # (grads, state, params) -> updates; state in place


def adamw(lr: float, *, b1=0.9, b2=0.95, eps=1e-8,
          weight_decay=0.0) -> Optimizer:

    def init(params, lead: tuple = ()):
        """``lead`` is the shape of the step counter: ``()`` for one
        model, ``(U,)`` for U stacked models."""
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        device = tree_leaves(params)[0].device
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
                "step": torch.zeros(lead, dtype=torch.int32, device=device)}

    def update(grads, state, params):
        state["step"] += 1
        step = state["step"].to(torch.float32)
        c1 = 1.0 - torch.pow(torch.full_like(step, b1), step)
        c2 = 1.0 - torch.pow(torch.full_like(step, b2), step)
        lead = step.ndim

        def upd(g, mu, nu, p):
            g = g.to(torch.float32)
            mu.copy_(b1 * mu + (1 - b1) * g)
            nu.copy_(b2 * nu + (1 - b2) * (g * g))
            trail = (1,) * (g.ndim - lead)
            c1b = c1.reshape(c1.shape + trail)
            c2b = c2.reshape(c2.shape + trail)
            step_dir = (mu / c1b) / (torch.sqrt(nu / c2b) + eps)
            if weight_decay:
                step_dir = step_dir + weight_decay * p.to(torch.float32)
            return -lr * step_dir

        return tree_map(upd, grads, state["mu"], state["nu"], params)

    return Optimizer(init, update)


def apply_updates(params, updates) -> None:
    """``p += u`` for every leaf, in place."""
    for p, u in zip(tree_leaves(params), tree_leaves(updates)):
        p.add_(u.to(p.dtype))
