"""Step functions and their sharding specs (port of the reference's
``launch/steps.py``), shared by the dry run (``launch/dryrun.py``), the
trainer (``launch/train.py``) and the server (``launch/serve.py``).

The train step differentiates ``models.model.loss_fn`` with its defaults,
so every kernel is off (``use_flash=False``, ``use_ssm_kernel=False``), as
in the reference: no Hopper kernel has a backward pass, and the reference's
Pallas kernels have no ``custom_vjp``.  Parameters and the optimizer state
are updated IN PLACE, where the reference donates them to its jitted step;
the step returns the same objects so callers can keep the reference's
``params, opt_state, metrics = step(params, opt_state, batch)``.

The spec half derives each input's spec (``sharding.rules``) from the
parameters' and the cache's logical axes: ``param_pspecs``,
``batch_pspec`` / ``batch_specs``, ``cache_pspecs`` and ``zero1_specs``,
and ``input_specs`` assembles a ``LoweringBundle`` for one (architecture
x shape x mesh): the step, its inputs as ``meta`` tensors of their global
shapes (nothing allocated; the reference's ``ShapeDtypeStruct``s) and
their specs.

On a mesh the step runs unchanged on DTensors (``distribute``): the
parameters and the batch are placed by their specs, the plain tensors the
model makes (positions, masks, the optimizer's step) join as replicated
(``implicit_replication``), and each gradient is redistributed to its
parameter's placements right after the backward (and the
``cfg.grad_sync_dtype`` cast), so it is reduced once, as the reference's
GSPMD reduces it, before the clip and the optimizer read it.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.models import model as M
from repro_torch.models.cache import cache_logical_axes, cache_spec
from repro_torch.models.common import dtype_of, tree_leaves, tree_map
from repro_torch.optim import adamw, apply_updates, global_norm_clip
from repro_torch.sharding.rules import (DEFAULT_RULES, AxisRules,
                                        logical_to_spec, mesh_axis_sizes,
                                        spec_to_placements)


# ---------------------------------------------------------------------------
# Sharding spec derivation
# ---------------------------------------------------------------------------

def param_pspecs(cfg, mesh, rules: AxisRules = DEFAULT_RULES):
    """The spec of every parameter (the tree of ``M.param_shapes``)."""
    return tree_map(lambda s, ax: logical_to_spec(ax, s.shape, mesh, rules),
                    M.param_shapes(cfg), M.param_logical_axes(cfg))


def batch_pspec(cfg, mesh, global_batch: int,
                rules: AxisRules = DEFAULT_RULES) -> tuple:
    return logical_to_spec(("batch",), (global_batch,), mesh, rules)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg, mesh, shp, rules: AxisRules = DEFAULT_RULES):
    """(meta tensors, specs) of a train / prefill batch; the audio family
    adds its frame embeddings ``src_embeds``."""
    B, S = shp.global_batch, shp.seq_len
    bspec = batch_pspec(cfg, mesh, B, rules)
    structs = {"tokens": _meta((B, S), torch.int32),
               "targets": _meta((B, S), torch.int32)}
    specs = {"tokens": bspec + (None,), "targets": bspec + (None,)}
    if cfg.arch_type == "audio":
        s_src = max(S // cfg.encoder_downsample, 1)
        structs["src_embeds"] = _meta((B, s_src, cfg.d_model),
                                      dtype_of(cfg.compute_dtype))
        specs["src_embeds"] = bspec + (None, None)
    return structs, specs


def cache_pspecs(cfg, mesh, batch: int, max_len: int,
                 rules: AxisRules = DEFAULT_RULES):
    return tree_map(lambda s, ax: logical_to_spec(ax, s.shape, mesh, rules),
                    cache_spec(cfg, batch, max_len), cache_logical_axes(cfg))


def zero1_specs(param_shapes, pspecs, mesh):
    """ZeRO-1 moment specs: each f32 Adam moment additionally sharded over
    the data axis on its first dim that is unsharded and divisible (the
    moments are only touched elementwise in the update)."""
    data_size = mesh_axis_sizes(mesh).get("data", 1)

    def one(shape_struct, spec):
        entries = list(spec) + [None] * (len(shape_struct.shape) - len(spec))
        used = {a for e in entries if e is not None
                for a in ((e,) if isinstance(e, str) else e)}
        if "data" in used:
            return tuple(entries)
        for i, (dim, e) in enumerate(zip(shape_struct.shape, entries)):
            if e is None and data_size > 1 and dim % data_size == 0:
                entries[i] = "data"
                break
        return tuple(entries)

    return tree_map(one, param_shapes, pspecs)


# ---------------------------------------------------------------------------
# Tensors on a mesh
# ---------------------------------------------------------------------------

def distribute(tree, specs, mesh):
    """Each tensor of ``tree`` as a DTensor on ``mesh`` (a ``DeviceMesh``)
    placed by its spec.  A full tensor (every rank holds the same values)
    is split with no communication; a ``meta`` one stays on ``meta``."""
    from torch.distributed.tensor import distribute_tensor

    return tree_map(lambda t, s: distribute_tensor(
        t, mesh, spec_to_placements(s, mesh), src_data_rank=None),
        tree, specs)


def full_tensors(tree):
    """The full tensor of every DTensor leaf (a plain leaf as it is)."""
    from torch.distributed.tensor import DTensor

    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)


def mesh_context(tree):
    """``implicit_replication()`` when ``tree`` holds a DTensor (a plain
    tensor an op meets beside one joins as replicated), else a null
    context."""
    from torch.distributed.tensor import DTensor

    if any(isinstance(t, DTensor) for t in tree_leaves(tree)):
        from torch.distributed.tensor.experimental import (
            implicit_replication)
        return implicit_replication()
    return contextlib.nullcontext()


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


def _reduce_like(g, p):
    """A DTensor gradient redistributed to its parameter's placements
    (its pending reduction done once, here); a plain one as it is."""
    from torch.distributed.tensor import DTensor

    if isinstance(g, DTensor) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(cfg, opt=None, clip_norm: float = 1.0):
    """``(train_step, opt)``: ``train_step(params, opt_state, batch) ->
    (params, opt_state, metrics)`` takes one optimizer step in place —
    gradients cast to ``cfg.grad_sync_dtype`` where set (the reference
    casts before its data-parallel all-reduce), clipped to global norm
    ``clip_norm``, the optimizer's update applied — and returns the
    loss's metrics with ``grad_norm`` (before clipping)."""
    opt = opt or make_optimizer(cfg)

    def train_step(params, opt_state, batch):
        with mesh_context(params):
            _, metrics, grads = loss_and_grads(params, batch, cfg)
            if cfg.grad_sync_dtype:
                gd = dtype_of(cfg.grad_sync_dtype)
                grads = tree_map(lambda g: g.to(gd), grads)
            grads = tree_map(_reduce_like, grads, params)
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


# ---------------------------------------------------------------------------
# Dry-run assembly: everything one (arch, shape, mesh) run needs
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LoweringBundle:
    fn: object
    args: tuple           # meta tensors of the global shapes
    in_shardings: object  # specs, the tree of ``args``
    kind: str
    out_shardings: object = None  # None: as the ops propagate them


def serve_max_len(cfg, shp) -> int:
    return shp.seq_len


def input_specs(cfg, shp, mesh, rules: AxisRules = DEFAULT_RULES
                ) -> LoweringBundle:
    """Meta stand-ins and specs for one (arch x shape) on ``mesh``."""
    pspecs = param_pspecs(cfg, mesh, rules)

    if shp.kind in ("train", "prefill"):
        structs, bspecs = batch_specs(cfg, mesh, shp, rules)
        if shp.kind == "train":
            step_fn, opt = make_train_step(cfg)
            params = M.param_shapes(cfg)
            opt_state = opt.init(params)
            mom_specs = pspecs
            if cfg.zero1:
                mom_specs = zero1_specs(params, pspecs, mesh)
            opt_specs = {"mu": mom_specs, "nu": mom_specs, "step": ()}
            return LoweringBundle(
                fn=step_fn, args=(params, opt_state, structs),
                in_shardings=(pspecs, opt_specs, bspecs), kind="train")
        # prefill: the loss-less forward; the (f32) logits stay
        # vocab-sharded on the way out
        fwd = lambda params, batch: M.forward(params, batch, cfg)[0]
        logits_spec = logical_to_spec(
            ("batch", None, "vocab"),
            (shp.global_batch, shp.seq_len, cfg.vocab_size), mesh, rules)
        return LoweringBundle(fn=fwd, args=(M.param_shapes(cfg), structs),
                              in_shardings=(pspecs, bspecs), kind="prefill",
                              out_shardings=logits_spec)

    # decode
    B = shp.global_batch
    T = serve_max_len(cfg, shp)
    cspecs = cache_pspecs(cfg, mesh, B, T, rules)
    caches = tree_map(lambda s: _meta(s.shape, s.dtype),
                      cache_spec(cfg, B, T))
    bspec = batch_pspec(cfg, mesh, B, rules)
    return LoweringBundle(
        fn=make_serve_step(cfg),
        args=(M.param_shapes(cfg), caches, _meta((B, 1), torch.int32),
              _meta((), torch.int32)),
        in_shardings=(pspecs, cspecs, bspec + (None,), ()),
        kind="decode")
