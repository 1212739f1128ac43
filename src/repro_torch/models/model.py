"""Top-level model API (port of the reference's ``models/model.py``):
declarations, init, the full-sequence forward and the loss, for the
dense / vlm and ssm families.

Batch convention (text / vlm / ssm): ``{"tokens": (B,S) int, "targets":
(B,S) int}``.  ``forward`` is the prefill / scoring forward: with
``use_flash=True`` attention runs the Hopper flash kernel, with
``use_ssm_kernel=True`` the SSD scan runs the Hopper SSD kernel (each on a
CUDA tensor; a CPU tensor takes the kernel's plain version).  Not ported
yet: ``decode_step``, ``init_cache`` and the audio family (ROADMAP queue A
item 12).
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (P, apply_norm, build, dtype_of,
                                       norm_decl, not_ported, softcap)

__all__ = ["model_decls", "init_params", "forward", "loss_fn"]


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
    reference's (sorted-key) order from a CPU generator — an int seed or a
    ``torch.Generator`` — and placed on ``device`` (CUDA unless asked)."""
    dev = resolve_device(device)
    gen = seed_or_generator
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator().manual_seed(int(seed_or_generator))
    return build(model_decls(cfg), gen, dtype_of(cfg.param_dtype), device=dev)


def _check_dtypes(cfg):
    # jnp.einsum promotes mixed operands; torch.matmul does not.  Every
    # shipped config (and reduced()) keeps params and compute in one type.
    if cfg.param_dtype != cfg.compute_dtype:
        raise NotImplementedError(
            f"param_dtype {cfg.param_dtype} != compute_dtype "
            f"{cfg.compute_dtype}: mixed-type matmuls are not ported")


def _embed(params, tokens, cfg):
    x = params["embed"][tokens]
    return x.to(dtype_of(cfg.compute_dtype))


def _logits(params, x, cfg):
    if cfg.tie_embeddings:
        logits = x @ params["embed"].t()
    else:
        logits = x @ params["unembed"]
    return softcap(logits.to(dtype_of(cfg.logits_dtype)), cfg.logit_softcap)


def forward(params, batch, cfg, *, use_flash=False, use_ssm_kernel=False):
    """Full-sequence forward -> (logits (B,S,V) in ``cfg.logits_dtype``,
    aux loss, a zero f32 scalar for these families)."""
    _check_dtypes(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    x = _embed(params, tokens, cfg)
    x = tfm.backbone_forward(params, x, cfg, positions, use_flash=use_flash,
                             use_ssm_kernel=use_ssm_kernel)
    x = apply_norm(params["final_norm"], x, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
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


def decode_step(*args, **kwargs):
    not_ported("decode_step")


def init_cache(*args, **kwargs):
    not_ported("init_cache")
