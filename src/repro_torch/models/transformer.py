"""Layer assembly (port of the reference's ``models/transformer.py``):
the decoder-only stacks (dense / vlm, MoE with or without MLA, ssm, hybrid
RG-LRU + local attention) and the audio encoder-decoder stack.

Parameters stay stacked per layer, with a leading layer dimension, as in
the reference, so the two packages' trees are interchangeable.  The
reference's ``scan_stack`` (``lax.scan`` over that dimension) becomes a
Python loop over the layer index, summing each layer's auxiliary loss (the
MoE router's; zero elsewhere) in f32.  ``backbone_decode`` runs one token
through the stack against a decode cache (``models/cache.py``), layer by
layer.

``cfg.remat`` rematerialises each layer under autograd, as the reference's
``_maybe_remat`` wraps the layer its scan runs:

* ``"full"``: ``torch.utils.checkpoint`` (non-reentrant) around the layer;
  its backward recomputes the whole layer forward, so only the layer's
  inputs stay alive between forward and backward (``jax.checkpoint``);
* ``"offloadable-dots"``: selective checkpointing that keeps the outputs
  of the weight matmuls (``aten.mm`` / ``addmm``, what ``torch.matmul``
  of an activation by a weight lowers to) and recomputes everything else,
  batched products (``aten.bmm``: the attention scores and values, the
  MoE experts' GEMMs) included: the counterpart of jax's
  ``checkpoint_dots_with_no_batch_dims``.  The two differ where XLA would
  fuse or simplify: jax picks by ``dot_general`` dimension numbers inside
  one compiled program, torch by the aten op the eager layer dispatches,
  so an einsum that torch lowers to ``bmm`` with a batch of one, or a
  ``mm`` XLA folds into a neighbour, may fall on the other side.
  Neither saves to host memory (the name's "offloadable" is the TPU
  policy's option to; here the saved products stay on the device).

Recomputation repeats the same operations on the same inputs, so the loss
and every gradient equal ``"none"``'s bitwise.  Without autograd (decode,
``torch.no_grad``) remat is a no-op.

On a mesh the residual stream is a DTensor, and each residual add places
both its terms as the stream is kept (``_residual``): batch-sharded,
every other dim whole, so the pending sum of a tensor-parallel output
projection is all-reduced there, once, and every norm and projection
reads a settled stream.  ``cfg.seq_shard`` is Megatron sequence
parallelism, as the reference's ``_seq_shard`` pins it in its dense
layers: there the stream is sharded over the ``model`` axis along its
sequence dim (``Shard(1)``) instead, so the pending sum arrives as a
reduce-scatter and the next norm's input is all-gathered, where plain
tensor parallelism all-reduces the whole stream.  On plain tensors (one
device) neither changes anything.
"""

from __future__ import annotations

import math

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (apply_norm, norm_decl, on_mesh,
                                       stack_decls, tree_leaves, tree_map)


# ---------------------------------------------------------------------------
# Per-layer declarations
# ---------------------------------------------------------------------------

def dense_layer_decls(cfg, d_ff=None):
    return {
        "norm1": norm_decl(cfg),
        "attn": attn.attn_decls(cfg),
        "norm2": norm_decl(cfg),
        "mlp": mlp_mod.mlp_decls(cfg, d_ff),
    }


def moe_layer_decls(cfg):
    return {
        "norm1": norm_decl(cfg),
        "attn": attn.attn_decls(cfg),
        "norm2": norm_decl(cfg),
        "moe": moe_mod.moe_decls(cfg),
    }


def ssm_layer_decls(cfg):
    return {"norm": norm_decl(cfg), "ssm": ssm_mod.ssm_decls(cfg)}


def rec_layer_decls(cfg):
    return {
        "norm1": norm_decl(cfg),
        "rec": rglru_mod.rglru_decls(cfg),
        "norm2": norm_decl(cfg),
        "mlp": mlp_mod.mlp_decls(cfg),
    }


def dec_layer_decls(cfg):
    d = dense_layer_decls(cfg)
    d["norm_cross"] = norm_decl(cfg)
    d["cross"] = attn.cross_attn_decls(cfg)
    return d


# ---------------------------------------------------------------------------
# Per-layer forward (full sequence): each returns (x, aux loss)
# ---------------------------------------------------------------------------

def _zero(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _stream(x, cfg, seq: bool):
    """The placements the residual stream keeps on a mesh: its batch dim
    sharded as it is, its sequence dim over the ``model`` axis where
    ``seq`` and ``cfg.seq_shard`` (the reference's ``_seq_shard``), every
    other dim whole, a pending sum completed."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    pl = [Shard(1) if seq and cfg.seq_shard and name == "model"
          else p if p.is_shard() and p.dim == 0 else Replicate()
          for name, p in zip(mesh.mesh_dim_names, x.placements)]
    return x if tuple(pl) == tuple(x.placements) else x.redistribute(mesh,
                                                                      pl)


def _residual(x, h, cfg, seq: bool = False):
    """``x + h``, a residual add.  On a mesh both terms are placed as the
    stream keeps them (``_stream``) first, so a layer's pending sum (the
    tensor-parallel output projection's) arrives as one all-reduce, or as
    a reduce-scatter of the sequence-sharded stream in a dense layer
    under ``cfg.seq_shard`` (the module docstring)."""
    if not on_mesh(x):
        return x + h
    return _stream(x, cfg, seq) + _stream(h, cfg, seq)


def dense_layer_fwd(p, x, cfg, positions, *, causal=True, window=0,
                    use_flash=False):
    h = attn.attn_forward(p["attn"], apply_norm(p["norm1"], x, cfg), cfg,
                          positions=positions, causal=causal, window=window,
                          use_flash=use_flash)
    x = _residual(x, h, cfg, seq=True)
    h = mlp_mod.mlp_forward(p["mlp"], apply_norm(p["norm2"], x, cfg), cfg)
    return _residual(x, h, cfg, seq=True), _zero(x)


def mla_layer_fwd(p, x, cfg, positions):
    h = attn.mla_forward(p["attn"], apply_norm(p["norm1"], x, cfg), cfg,
                         positions=positions)
    x = _residual(x, h, cfg)
    if "moe" in p:
        h, aux = moe_mod.moe_forward(p["moe"], apply_norm(p["norm2"], x, cfg),
                                     cfg)
    else:
        h = mlp_mod.mlp_forward(p["mlp"], apply_norm(p["norm2"], x, cfg), cfg)
        aux = _zero(x)
    return _residual(x, h, cfg), aux


def moe_layer_fwd(p, x, cfg, positions):
    if cfg.use_mla:
        return mla_layer_fwd(p, x, cfg, positions)
    h = attn.attn_forward(p["attn"], apply_norm(p["norm1"], x, cfg), cfg,
                          positions=positions)
    x = _residual(x, h, cfg)
    h, aux = moe_mod.moe_forward(p["moe"], apply_norm(p["norm2"], x, cfg), cfg)
    return _residual(x, h, cfg), aux


def ssm_layer_fwd(p, x, cfg, use_kernel=False):
    h = ssm_mod.ssm_forward(p["ssm"], apply_norm(p["norm"], x, cfg), cfg,
                            use_kernel=use_kernel)
    return _residual(x, h, cfg), _zero(x)


def rec_layer_fwd(p, x, cfg):
    h = rglru_mod.rglru_block_forward(p["rec"], apply_norm(p["norm1"], x, cfg),
                                      cfg)
    x = _residual(x, h, cfg)
    h = mlp_mod.mlp_forward(p["mlp"], apply_norm(p["norm2"], x, cfg), cfg)
    return _residual(x, h, cfg), _zero(x)


def dec_layer_fwd(p, x, enc_out, cfg, positions):
    h = attn.attn_forward(p["attn"], apply_norm(p["norm1"], x, cfg), cfg,
                          positions=positions, causal=True)
    x = _residual(x, h, cfg)
    h = attn.cross_attn_forward(p["cross"],
                                apply_norm(p["norm_cross"], x, cfg), enc_out,
                                cfg)
    x = _residual(x, h, cfg)
    h = mlp_mod.mlp_forward(p["mlp"], apply_norm(p["norm2"], x, cfg), cfg)
    return _residual(x, h, cfg), _zero(x)


_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _SAVED_DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, remat: str):
    """``fn(params_l, x)`` under ``cfg.remat`` (the module docstring)."""
    if remat == "none" or not torch.is_grad_enabled():
        return fn
    if remat == "full":
        return lambda p, x: ckpt.checkpoint(fn, p, x, use_reentrant=False)
    if remat == "offloadable-dots":
        return lambda p, x: ckpt.checkpoint(
            fn, p, x, use_reentrant=False,
            context_fn=lambda: ckpt.create_selective_checkpoint_contexts(
                _dots_policy))
    raise ValueError(f"unknown remat {remat!r} (none | full | "
                     f"offloadable-dots)")


def run_stack(layer_fn, stacked_params, x, remat: str = "none"):
    """Apply ``layer_fn(params_l, x) -> (x, aux)`` over a stacked parameter
    tree, layer by layer (the reference's ``scan_stack``), each layer
    rematerialised under ``remat``; each layer's parameters are views into
    the stacked tensors.  Returns (x, the sum of the layers' aux in
    f32)."""
    fn = _maybe_remat(layer_fn, remat)
    aux = _zero(x)
    for i in range(tree_leaves(stacked_params)[0].shape[0]):
        x, a = fn(tree_map(lambda t: t[i], stacked_params), x)
        aux = aux + a
    return x, aux


# ---------------------------------------------------------------------------
# Full-stack declarations + forward per family
# ---------------------------------------------------------------------------

def _hybrid_layout(cfg):
    """(groups of the block pattern, trailing recurrent layers)."""
    G = cfg.num_layers // len(cfg.block_pattern)
    return G, cfg.num_layers - G * len(cfg.block_pattern)


def stack_decls_for(cfg):
    """Stacked layer declarations for the whole backbone."""
    at = cfg.arch_type
    if at == "ssm":
        return {"layers": stack_decls(ssm_layer_decls(cfg), cfg.num_layers)}
    if at == "hybrid":
        G, tail = _hybrid_layout(cfg)
        group = {f"sub{i}": rec_layer_decls(cfg) if kind == "recurrent"
                 else dense_layer_decls(cfg)
                 for i, kind in enumerate(cfg.block_pattern)}
        decls = {"groups": stack_decls(group, G)}
        if tail:
            decls["tail"] = stack_decls(rec_layer_decls(cfg), tail)
        return decls
    if at == "moe":
        decls = {}
        nd = cfg.first_dense_layers
        if nd:
            decls["dense_layers"] = stack_decls(
                dense_layer_decls(cfg, cfg.first_dense_d_ff or cfg.d_ff), nd)
        decls["layers"] = stack_decls(moe_layer_decls(cfg),
                                      cfg.num_layers - nd)
        return decls
    if at == "audio":
        return {
            "encoder": stack_decls(dense_layer_decls(cfg),
                                   cfg.num_encoder_layers),
            "enc_norm": norm_decl(cfg),
            "decoder": stack_decls(dec_layer_decls(cfg), cfg.num_layers),
        }
    # dense / vlm
    return {"layers": stack_decls(dense_layer_decls(cfg), cfg.num_layers)}


def backbone_forward(params, x, cfg, positions, *, enc_out=None,
                     use_flash=False, use_ssm_kernel=False):
    """x: (B,S,d) embedded inputs -> (hidden (B,S,d), aux loss f32): the
    MoE routers' load-balance loss summed over layers, zero for the other
    families.  The audio decoder attends to ``enc_out`` (B,S_src,d)."""
    at = cfg.arch_type
    if at == "ssm":
        return run_stack(
            lambda p, h: ssm_layer_fwd(p, h, cfg, use_kernel=use_ssm_kernel),
            params["layers"], x, cfg.remat)

    if at == "hybrid":
        def group_fwd(gp, h):
            aux = _zero(h)
            for i, kind in enumerate(cfg.block_pattern):
                sub = gp[f"sub{i}"]
                if kind == "recurrent":
                    h, a = rec_layer_fwd(sub, h, cfg)
                else:
                    h, a = dense_layer_fwd(sub, h, cfg, positions,
                                           window=cfg.window,
                                           use_flash=use_flash)
                aux = aux + a
            return h, aux

        x, aux = run_stack(group_fwd, params["groups"], x, cfg.remat)
        if "tail" in params:
            x, a = run_stack(lambda p, h: rec_layer_fwd(p, h, cfg),
                             params["tail"], x, cfg.remat)
            aux = aux + a
        return x, aux

    if at == "moe":
        aux = _zero(x)
        if "dense_layers" in params:
            x, aux = run_stack(
                lambda p, h: (mla_layer_fwd(p, h, cfg, positions)
                              if cfg.use_mla else
                              dense_layer_fwd(p, h, cfg, positions)),
                params["dense_layers"], x, cfg.remat)
        x, a = run_stack(lambda p, h: moe_layer_fwd(p, h, cfg, positions),
                         params["layers"], x, cfg.remat)
        return x, aux + a

    if at == "audio":
        if enc_out is None:
            raise ValueError("the audio family's decoder needs enc_out")
        return run_stack(
            lambda p, h: dec_layer_fwd(p, h, enc_out, cfg, positions),
            params["decoder"], x, cfg.remat)

    # dense / vlm
    return run_stack(
        lambda p, h: dense_layer_fwd(p, h, cfg, positions, window=cfg.window,
                                     use_flash=use_flash),
        params["layers"], x, cfg.remat)


def encoder_forward(params, src, cfg, positions):
    """Bidirectional encoder over frame embeddings.  src: (B,S_src,d)."""
    x, _ = run_stack(
        lambda p, h: dense_layer_fwd(p, h, cfg, positions, causal=False),
        params["encoder"], src, cfg.remat)
    return apply_norm(params["enc_norm"], x, cfg)


# ---------------------------------------------------------------------------
# Decode (one token) per family
# ---------------------------------------------------------------------------

def dense_layer_decode(p, x, cfg, cache_l, index, window):
    h, nc = attn.attn_decode(p["attn"], apply_norm(p["norm1"], x, cfg), cfg,
                             cache_l, index, window=window)
    x = x + h
    x = x + mlp_mod.mlp_forward(p["mlp"], apply_norm(p["norm2"], x, cfg), cfg)
    return x, nc


def mla_layer_decode(p, x, cfg, cache_l, index):
    h, nc = attn.mla_decode(p["attn"], apply_norm(p["norm1"], x, cfg), cfg,
                            cache_l, index)
    x = x + h
    if "moe" in p:
        h, _ = moe_mod.moe_forward(p["moe"], apply_norm(p["norm2"], x, cfg),
                                   cfg)
    else:
        h = mlp_mod.mlp_forward(p["mlp"], apply_norm(p["norm2"], x, cfg), cfg)
    return x + h, nc


def moe_layer_decode(p, x, cfg, cache_l, index):
    if cfg.use_mla:
        return mla_layer_decode(p, x, cfg, cache_l, index)
    h, nc = attn.attn_decode(p["attn"], apply_norm(p["norm1"], x, cfg), cfg,
                             cache_l, index, window=0)
    x = x + h
    h, _ = moe_mod.moe_forward(p["moe"], apply_norm(p["norm2"], x, cfg), cfg)
    return x + h, nc


def ssm_layer_decode(p, x, cfg, cache_l):
    h, nc = ssm_mod.ssm_decode(p["ssm"], apply_norm(p["norm"], x, cfg), cfg,
                               cache_l)
    return x + h, nc


def rec_layer_decode(p, x, cfg, cache_l):
    h, nc = rglru_mod.rglru_block_decode(
        p["rec"], apply_norm(p["norm1"], x, cfg), cfg, cache_l)
    x = x + h
    x = x + mlp_mod.mlp_forward(p["mlp"], apply_norm(p["norm2"], x, cfg), cfg)
    return x, nc


def dec_layer_decode(p, x, cfg, cache_l, index):
    h, nc = attn.attn_decode(p["attn"], apply_norm(p["norm1"], x, cfg), cfg,
                             cache_l["self"], index, window=0)
    x = x + h
    # cross-attention against the cached encoder K/V
    q = attn._heads(apply_norm(p["norm_cross"], x, cfg), p["cross"]["wq"])
    k, v = cache_l["cross"]["k"], cache_l["cross"]["v"]
    mask = torch.ones((1, 1, 1, 1, k.shape[1]), dtype=torch.bool,
                      device=x.device)
    out = attn.sdpa(q, k, v, mask, 1.0 / math.sqrt(cfg.head_dim))
    x = x + attn._out_proj(out, p["cross"]["wo"])
    x = x + mlp_mod.mlp_forward(p["mlp"], apply_norm(p["norm2"], x, cfg), cfg)
    return x, {"self": nc, "cross": cache_l["cross"]}


def run_stack_cache(layer_fn, stacked_params, x, cache):
    """``layer_fn(params_l, x, cache_l) -> (x, new cache_l)`` over the
    stacked parameters and the (L, ...) cache (the reference's
    ``scan_stack_cache``); the new per-layer caches are stacked back."""
    new = []
    for i in range(tree_leaves(stacked_params)[0].shape[0]):
        x, nc = layer_fn(tree_map(lambda a: a[i], stacked_params), x,
                         tree_map(lambda c: c[i], cache))
        new.append(nc)
    return x, tree_map(lambda *ls: torch.stack(ls), *new)


def _layers(cache, a: int, b: int):
    return tree_map(lambda c: c[a:b], cache)


def backbone_decode(params, x, cfg, cache, index):
    """x: (B,1,d) -> (hidden (B,1,d), new cache); ``index`` the token's
    position (an int or one per row, see ``attention.attn_decode``)."""
    at = cfg.arch_type
    if at == "ssm":
        return run_stack_cache(
            lambda p, h, c: ssm_layer_decode(p, h, cfg, c),
            params["layers"], x, cache)

    if at == "hybrid":
        def group_dec(gp, h, gc):
            ncs, rec_i = {}, 0
            for i, kind in enumerate(cfg.block_pattern):
                sub = gp[f"sub{i}"]
                if kind == "recurrent":
                    key = "rec1" if rec_i == 0 else "rec2"
                    h, ncs[key] = rec_layer_decode(sub, h, cfg, gc[key])
                    rec_i += 1
                else:
                    h, ncs["attn"] = dense_layer_decode(
                        sub, h, cfg, gc["attn"], index, cfg.window)
            return h, ncs

        x, new_groups = run_stack_cache(group_dec, params["groups"], x,
                                        cache["groups"])
        new_cache = {"groups": new_groups}
        if "tail" in params:
            x, new_cache["tail"] = run_stack_cache(
                lambda p, h, c: rec_layer_decode(p, h, cfg, c),
                params["tail"], x, cache["tail"])
        return x, new_cache

    if at == "moe":
        nd = cfg.first_dense_layers
        if cfg.use_mla:
            dense = moe = lambda p, h, c: mla_layer_decode(p, h, cfg, c, index)
        else:
            dense = lambda p, h, c: dense_layer_decode(p, h, cfg, c, index, 0)
            moe = lambda p, h, c: moe_layer_decode(p, h, cfg, c, index)
        if nd:
            x, nc_d = run_stack_cache(dense, params["dense_layers"], x,
                                      _layers(cache, 0, nd))
        x, nc_m = run_stack_cache(moe, params["layers"], x,
                                  _layers(cache, nd, cfg.num_layers))
        if not nd:
            return x, nc_m
        return x, tree_map(lambda a, b: torch.cat([a, b]), nc_d, nc_m)

    if at == "audio":
        return run_stack_cache(
            lambda p, h, c: dec_layer_decode(p, h, cfg, c, index),
            params["decoder"], x, cache)

    # dense / vlm
    return run_stack_cache(
        lambda p, h, c: dense_layer_decode(p, h, cfg, c, index, cfg.window),
        params["layers"], x, cache)
