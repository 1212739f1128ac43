"""Layer assembly (port of the reference's ``models/transformer.py``) for the
decoder-only dense / vlm and ssm stacks.

Parameters stay stacked per layer, with a leading layer dimension, as in
the reference, so the two packages' trees are interchangeable.  The
reference's ``scan_stack`` (``lax.scan`` over that dimension) becomes a
Python loop over the layer index.  ``cfg.remat`` and ``cfg.seq_shard`` are
training and sharding levers (rematerialisation under autodiff, Megatron
sequence sharding over a mesh); an eager forward on one device has neither,
so they change nothing here.  ``backbone_decode`` runs one token through
the stack against a decode cache (``models/cache.py``), layer by layer.
Not ported yet: the MoE, MLA, hybrid (RG-LRU) and audio encoder-decoder
families (ROADMAP queue A item 12).
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (apply_norm, norm_decl, not_ported,
                                       stack_decls, tree_leaves, tree_map)

_FAMILIES = ("dense", "vlm", "ssm")


def _check_family(cfg):
    if cfg.arch_type not in _FAMILIES:
        not_ported(f"the {cfg.arch_type} family ({cfg.name}; ported: "
                   f"{', '.join(_FAMILIES)})")


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


def ssm_layer_decls(cfg):
    return {"norm": norm_decl(cfg), "ssm": ssm_mod.ssm_decls(cfg)}


# ---------------------------------------------------------------------------
# Per-layer forward (full sequence)
# ---------------------------------------------------------------------------

def dense_layer_fwd(p, x, cfg, positions, *, causal=True, window=0,
                    use_flash=False):
    h = attn.attn_forward(p["attn"], apply_norm(p["norm1"], x, cfg), cfg,
                          positions=positions, causal=causal, window=window,
                          use_flash=use_flash)
    x = x + h
    h = mlp_mod.mlp_forward(p["mlp"], apply_norm(p["norm2"], x, cfg), cfg)
    return x + h


def ssm_layer_fwd(p, x, cfg, use_kernel=False):
    h = ssm_mod.ssm_forward(p["ssm"], apply_norm(p["norm"], x, cfg), cfg,
                            use_kernel=use_kernel)
    return x + h


def run_stack(layer_fn, stacked_params, x):
    """Apply ``layer_fn(params_l, x) -> x`` over a stacked parameter tree,
    layer by layer (the reference's ``scan_stack``); each layer's
    parameters are views into the stacked tensors."""
    for i in range(tree_leaves(stacked_params)[0].shape[0]):
        x = layer_fn(tree_map(lambda a: a[i], stacked_params), x)
    return x


# ---------------------------------------------------------------------------
# Full-stack declarations + forward per family
# ---------------------------------------------------------------------------

def stack_decls_for(cfg):
    """Stacked layer declarations for the whole backbone."""
    _check_family(cfg)
    if cfg.arch_type == "ssm":
        return {"layers": stack_decls(ssm_layer_decls(cfg), cfg.num_layers)}
    return {"layers": stack_decls(dense_layer_decls(cfg), cfg.num_layers)}


def backbone_forward(params, x, cfg, positions, *, use_flash=False,
                     use_ssm_kernel=False):
    """x: (B,S,d) embedded inputs -> hidden (B,S,d).  The reference also
    returns an aux loss, which is zero for these families."""
    _check_family(cfg)
    if cfg.arch_type == "ssm":
        return run_stack(
            lambda p, h: ssm_layer_fwd(p, h, cfg, use_kernel=use_ssm_kernel),
            params["layers"], x)
    return run_stack(
        lambda p, h: dense_layer_fwd(p, h, cfg, positions, window=cfg.window,
                                     use_flash=use_flash),
        params["layers"], x)


# ---------------------------------------------------------------------------
# Decode (one token)
# ---------------------------------------------------------------------------

def dense_layer_decode(p, x, cfg, cache_l, index, window):
    h, nc = attn.attn_decode(p["attn"], apply_norm(p["norm1"], x, cfg), cfg,
                             cache_l, index, window=window)
    x = x + h
    x = x + mlp_mod.mlp_forward(p["mlp"], apply_norm(p["norm2"], x, cfg), cfg)
    return x, nc


def ssm_layer_decode(p, x, cfg, cache_l):
    h, nc = ssm_mod.ssm_decode(p["ssm"], apply_norm(p["norm"], x, cfg), cfg,
                               cache_l)
    return x + h, nc


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


def backbone_decode(params, x, cfg, cache, index):
    """x: (B,1,d) -> (hidden (B,1,d), new cache); ``index`` the token's
    position (an int or one per row, see ``attention.attn_decode``)."""
    _check_family(cfg)
    if cfg.arch_type == "ssm":
        return run_stack_cache(
            lambda p, h, c: ssm_layer_decode(p, h, cfg, c),
            params["layers"], x, cache)
    return run_stack_cache(
        lambda p, h, c: dense_layer_decode(p, h, cfg, c, index, cfg.window),
        params["layers"], x, cache)
