"""Top-level model API (port of the reference's ``models/model.py``):
declarations, init, the full-sequence forward, the loss and decode, for
every family of the zoo (dense, vlm, MoE with or without MLA, ssm, hybrid,
audio encoder-decoder).

Batch conventions: text / vlm / ssm ``{"tokens": (B,S) int, "targets":
(B,S) int}``; audio adds ``"src_embeds": (B, S // downsample, d)``, the
frame embeddings of a stubbed frontend.  ``forward`` is the prefill /
scoring forward: with ``use_flash=True`` attention runs the Hopper flash
kernel (the hybrid's hd-256 windowed attention too), with
``use_ssm_kernel=True`` the SSD scan runs the Hopper SSD kernel (each on a
CUDA tensor; a CPU tensor takes the kernel's plain version).
``decode_step`` runs one token per row against a decode cache
(``models/cache.py``, whose ``init_cache`` and ``cache_spec`` this module
re-exports); ``prefill_audio_cache`` fills the audio decoder's cross K/V
from the encoder once per request.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.cache import cache_spec, init_cache  # re-export
from repro_torch.models.common import (P, apply_norm, axes_of, build,
                                       dtype_of, norm_decl, on_mesh,
                                       settle_grad, softcap, tree_map)

__all__ = ["model_decls", "init_params", "param_logical_axes",
           "param_shapes", "forward", "loss_fn", "decode_step",
           "prefill_audio_cache", "init_cache", "cache_spec"]


def model_decls(cfg):
    d, V = cfg.d_model, cfg.vocab_size
    decls = {
        "embed": P((V, d), ("vocab", "embed_alt"), scale=0.02),
        "final_norm": norm_decl(cfg),
        **tfm.stack_decls_for(cfg),
    }
    if not cfg.tie_embeddings:
        decls["unembed"] = P((d, V), ("embed_alt", "vocab"), scale=0.02)
    return decls


def init_params(cfg, seed_or_generator, *, device=None):
    """Random parameters in ``cfg.param_dtype``, drawn leaf by leaf in the
    reference's (sorted-key) order from a generator — an int seed (a CPU
    generator: the same weights on every device) or a ``torch.Generator``
    (a CUDA one draws on its card) — and placed on ``device`` (CUDA unless
    asked)."""
    dev = resolve_device(device)
    gen = seed_or_generator
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator().manual_seed(int(seed_or_generator))
    return build(model_decls(cfg), gen, dtype_of(cfg.param_dtype), device=dev)


def param_logical_axes(cfg):
    """The tree of each parameter's logical axes (``sharding.rules``)."""
    return axes_of(model_decls(cfg))


def param_shapes(cfg):
    """The parameters as ``meta`` tensors of their shape and
    ``cfg.param_dtype``: no generator drawn, nothing allocated (the dry
    run's stand-ins)."""
    dt = dtype_of(cfg.param_dtype)
    return tree_map(lambda d: torch.empty(d.shape, dtype=dt, device="meta"),
                    model_decls(cfg))


def _check_dtypes(cfg):
    # jnp.einsum promotes mixed operands; torch.matmul does not.  Every
    # shipped config (and reduced()) keeps params and compute in one type.
    if cfg.param_dtype != cfg.compute_dtype:
        raise NotImplementedError(
            f"param_dtype {cfg.param_dtype} != compute_dtype "
            f"{cfg.compute_dtype}: mixed-type matmuls are not ported")


def _embed(params, tokens, cfg):
    """The token embeddings.  A DTensor table (a mesh) is looked up by
    ``F.embedding``, which keeps a vocab-sharded table in place: each rank
    gathers the rows it holds, zeros elsewhere, and one sum over the vocab
    axis completes every row (indexing would move the whole table to the
    embed dim first); a table sharded on its embed dim instead (a vocabulary
    the axis does not divide) gives rows sharded there, gathered whole.  The
    rows leave placed as the residual stream is kept: batch-sharded, every
    other dim whole.  The same rows either way."""
    table = params["embed"]
    if on_mesh(table):
        from torch.distributed.tensor import Replicate

        # the rows are settled at once: DTensor's masked partial keeps its
        # mask for one reduction, and the rows feed the norm and the
        # residual both; their gradient is summed into these placements
        # before it reaches the lookup's backward, which takes no other
        # pending sum (a sequence-sharded stream leaves one)
        x = F.embedding(tokens, table)
        x = settle_grad(x.redistribute(x.device_mesh, [
            p if p.is_shard() and p.dim == 0 else Replicate()
            for p in x.placements]))
    else:
        x = table[tokens]
    return x.to(dtype_of(cfg.compute_dtype))


def _logits(params, x, cfg):
    if cfg.tie_embeddings:
        logits = x @ params["embed"].t()
    else:
        logits = x @ params["unembed"]
    return softcap(logits.to(dtype_of(cfg.logits_dtype)), cfg.logit_softcap)


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def _encode(params, src_embeds, cfg):
    """The audio encoder over (B, S_src, d) frame embeddings."""
    src = src_embeds.to(dtype_of(cfg.compute_dtype))
    return tfm.encoder_forward(params, src, cfg,
                               _positions(src.shape[0], src.shape[1],
                                          src.device))


def forward(params, batch, cfg, *, use_flash=False, use_ssm_kernel=False):
    """Full-sequence forward -> (logits (B,S,V) in ``cfg.logits_dtype``,
    aux loss f32: the MoE routers' load-balance loss, zero for the other
    families)."""
    _check_dtypes(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed(params, tokens, cfg)
    enc_out = None
    if cfg.arch_type == "audio":
        enc_out = _encode(params, batch["src_embeds"], cfg)
    x, aux = tfm.backbone_forward(params, x, cfg,
                                  _positions(B, S, tokens.device),
                                  enc_out=enc_out, use_flash=use_flash,
                                  use_ssm_kernel=use_ssm_kernel)
    x = apply_norm(params["final_norm"], x, cfg)
    return _logits(params, x, cfg), aux


def loss_fn(params, batch, cfg, **kw):
    """Mean next-token cross-entropy (+ router aux) -> (loss, metrics)."""
    logits, aux = forward(params, batch, cfg, **kw)
    targets = batch["targets"].to(torch.int64)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    ce = torch.mean(nll)
    loss = ce + cfg.router_aux_coef * aux
    return loss, {"ce": ce, "aux": aux, "loss": loss}


def decode_step(params, cache, tokens, index, cfg):
    """One decode step.  tokens: (B,1), the tokens at position ``index``
    (an int, or a (B,) tensor of each row's own).  Returns (logits (B,1,V),
    the new cache)."""
    _check_dtypes(cfg)
    x = _embed(params, tokens, cfg)
    x, new_cache = tfm.backbone_decode(params, x, cfg, cache, index)
    x = apply_norm(params["final_norm"], x, cfg)
    return _logits(params, x, cfg), new_cache


def prefill_audio_cache(params, cache, src_embeds, cfg):
    """Audio serving: run the encoder once over ``src_embeds`` (B, S_src,
    d) and fill the decoder's cross K/V cache with every layer's
    projections of its output (the forward's own products, layer by
    layer)."""
    enc_out = _encode(params, src_embeds, cfg)
    cross = params["decoder"]["cross"]

    def stacked(w, like):
        return torch.stack([tfm.attn._heads(enc_out, w[l])
                            for l in range(w.shape[0])]).to(like.dtype)

    return {**cache, "cross": {"k": stacked(cross["wk"], cache["cross"]["k"]),
                               "v": stacked(cross["wv"], cache["cross"]["v"])}}
