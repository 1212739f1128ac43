"""Hand-written optimizers over nested dicts of tensors (port of the
reference's ``optim/optimizers.py``): AdamW, SGD with optional momentum,
``apply_updates`` and ``global_norm_clip``.

``torch.optim.Adam`` places ``sqrt`` and ``eps`` differently from the
reference, so the update is spelled out in the reference's order:
``mu/c1``, ``sqrt(nu/c2) + eps``, moments in f32, an int32 step.

The port updates moments and parameters IN PLACE, where the reference
donates the state buffers to its jitted step.  A step tensor may carry
leading user dims (``(U,)`` for the stacked per-user optimizers); the bias
corrections then broadcast over each parameter's trailing dims.

``lr`` is a float or a schedule ``lr(step) -> lr`` (``optim/schedule.py``)
called on the incremented step tensor, on its device, so a CUDA graph
that captured the update reads each replay's step.

An update is the exact product ``-lr * direction`` of two f32 values, held
in f64, and ``apply_updates`` rounds ``p + u`` to f32 once: the
reference's compiled step contracts the multiply and the add into one
fused multiply-add (XLA on the CPU), where rounding the product first
lands some sums on the other side of a tie.  The f64 sum is rounded once
more before f32, which differs from a true fused multiply-add only where
it falls exactly on an f32 midpoint.  Adam's sqrt is correctly rounded on
every device (``_sqrt``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.models.common import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable    # (params, lead=()) -> state
    update: Callable  # (grads, state, params) -> f64 updates; state in place


def _lr_scale(lr, step, lead: int):
    """``-lr`` rounded to f32, as an f64 tensor of the step's shape (a
    float lr filled on the step's device, a schedule read at ``step``), and
    a function giving its view against a leaf of ``ndim`` dims (the step's
    dims lead).  The view has the leaf's dims, so its product with an f32
    leaf is taken in f64, where it is exact."""
    if callable(lr):
        neg = (-lr(step).to(torch.float32)).to(torch.float64)
    else:
        neg = torch.full(step.shape, torch.tensor(-lr, dtype=torch.float32)
                         .item(), dtype=torch.float64, device=step.device)
    return lambda ndim: neg.reshape(neg.shape + (1,) * (ndim - lead))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 sqrt.  CUDA's is; torch's vectorized CPU sqrt
    (MKL's) is not, so the CPU takes it in f64, whose rounding to f32 is
    the correctly rounded f32 root (``meta``, the dry run's device, counts
    the card's)."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def _f32_zeros(params):
    """f32 zeros in each leaf's layout (a DTensor leaf's placements)."""
    return tree_map(lambda p: torch.zeros_like(
        p, dtype=torch.float32, memory_format=torch.contiguous_format),
        params)


def adamw(lr, *, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0) -> Optimizer:

    def init(params, lead: tuple = ()):
        """``lead`` is the shape of the step counter: ``()`` for one
        model, ``(U,)`` for U stacked models."""
        device = tree_leaves(params)[0].device
        return {"mu": _f32_zeros(params), "nu": _f32_zeros(params),
                "step": torch.zeros(lead, dtype=torch.int32, device=device)}

    def update(grads, state, params):
        state["step"] += 1
        step = state["step"].to(torch.float32)
        c1 = 1.0 - torch.pow(torch.full_like(step, b1), step)
        c2 = 1.0 - torch.pow(torch.full_like(step, b2), step)
        lead = step.ndim
        neg_lr = _lr_scale(lr, state["step"], lead)

        def upd(g, mu, nu, p):
            g = g.to(torch.float32)
            mu.copy_(b1 * mu + (1 - b1) * g)
            nu.copy_(b2 * nu + (1 - b2) * (g * g))
            trail = (1,) * (g.ndim - lead)
            c1b = c1.reshape(c1.shape + trail)
            c2b = c2.reshape(c2.shape + trail)
            step_dir = (mu / c1b) / (_sqrt(nu / c2b) + eps)
            if weight_decay:
                step_dir = step_dir + weight_decay * p.to(torch.float32)
            return torch.mul(step_dir, neg_lr(g.ndim))

        return tree_map(upd, grads, state["mu"], state["nu"], params)

    return Optimizer(init, update)


def sgd(lr, *, momentum=0.0) -> Optimizer:
    """SGD, with a heavy-ball velocity in f32 when ``momentum`` is set."""

    def init(params, lead: tuple = ()):
        device = tree_leaves(params)[0].device
        st = {"step": torch.zeros(lead, dtype=torch.int32, device=device)}
        if momentum:
            st["vel"] = _f32_zeros(params)
        return st

    def update(grads, state, params):
        state["step"] += 1
        neg_lr = _lr_scale(lr, state["step"], state["step"].ndim)
        if momentum:
            def vel(v, g):
                v.copy_(momentum * v + g.to(torch.float32))
                return torch.mul(v, neg_lr(v.ndim))
            return tree_map(vel, state["vel"], grads)
        return tree_map(lambda g: torch.mul(g.to(torch.float32),
                                            neg_lr(g.ndim)), grads)

    return Optimizer(init, update)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree_leaves(tree)))


def global_norm_clip(grads, max_norm: float):
    """``(grads * min(1, max_norm / (norm + 1e-9)), norm)``; a new tree."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), norm


def apply_updates(params, updates) -> None:
    """``p += u`` for every leaf, in place: ``p`` read as f64, the sum
    taken in f64 and rounded once to f32, as the reference's compiled step
    rounds ``p.astype(f32) + u``; a leaf of another type (a bf16 LM
    weight) is then rounded from that f32 to its own type, as the
    reference's ``.astype(p.dtype)`` does (rounding the f64 sum straight
    to bf16 would differ where the f32 lands on a bf16 tie).  An f32 leaf
    takes one kernel."""
    for p, u in zip(tree_leaves(params), tree_leaves(updates)):
        if p.dtype == torch.float32:
            torch.add(p, u, out=p)
        else:
            f32 = torch.empty_like(p, dtype=torch.float32)
            p.copy_(torch.add(p, u, out=f32))
