"""The Distributed-GAN protocol over the LM backbones (port of the
reference's ``core/distgan_lm.py``).

Setup (latent-space adversarial LM, textGAN-style soft embeddings):

* generator: z -> soft token distributions (B, S, V) by a two-layer MLP
  with learned positions and a softmax;
* critic (one per user): a reduced backbone of the zoo + a final norm, a
  mean-pool over the sequence and a linear head -> a realness logit.  Real
  sequences are the user's private token stream (each user a planted
  bigram of its own); they enter as one-hot rows, the generator's as
  probability-weighted mixes of the embedding rows;
* the approaches apply unchanged: the critics are the local Ds, their
  deltas or logits cross the user boundary, the token streams never do.

The approach bodies call ``d_apply`` with the users' critics stacked on a
leading axis (``(U, L, ...)`` leaves: the user axis in front of the
layer axis) and ``real (U, B, S)`` (or a batch every user sees).  The
critic runs as a loop over users, each user's tree a view into the
stacked leaves, the logits stacked back: ``torch.func.vmap`` over
``backbone_forward`` would have to batch the MoE dispatch's gathers, the
per-layer loop and the chunked SSD for no gain at a handful of users.
The loop has no host sync and no shape that depends on data, so a round
is captured whole in the engines' CUDA graphs.

Integer tokens are one-hot encoded in f32; a floating ``(..., S, V)``
batch is taken as soft tokens, as the reference's dtype test decides.
The audio family cannot be a critic (its decoder needs the encoder's
output, which the reference's critic never computes): ``make_lm_pair``
refuses it, where the reference fails at its first apply.

``critic_lm_config`` / ``critic_lm_params`` export a trained critic as a
servable LM (``serve/service.py::GenerationService.attach_lm``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.gan import GanPair
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (P, apply_norm, norm_decl, softmax,
                                       tree_map)


@dataclasses.dataclass(frozen=True)
class LMGanConfig:
    backbone: object          # a reduced ModelConfig (the critic backbone)
    seq_len: int = 32
    z_dim: int = 64
    g_hidden: int = 128


def _critic_decls(cfg):
    bb = cfg.backbone
    return {
        "embed": P((bb.vocab_size, bb.d_model), ("vocab", "embed_alt"),
                   scale=0.02),
        **tfm.stack_decls_for(bb),
        "final_norm": norm_decl(bb),
        "head": P((bb.d_model, 1), (None, None), scale=0.02),
    }


def _critic_apply(params, soft_tokens, cfg):
    """One critic.  soft_tokens: (B, S, V) rows summing to 1 (one-hot for
    real data).  Returns realness logits (B,)."""
    bb = cfg.backbone
    embed = params["embed"]
    x = torch.matmul(soft_tokens.to(embed.dtype), embed)   # bsv,vd->bsd
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    h, _ = tfm.backbone_forward(params, x, bb, positions)
    h = apply_norm(params["final_norm"], h, bb)
    pooled = torch.mean(h, dim=1)
    return (pooled @ params["head"])[:, 0]


def _gen_decls(cfg):
    h, S, V = cfg.g_hidden, cfg.seq_len, cfg.backbone.vocab_size
    return {
        "l1": {"w": P((cfg.z_dim, h), (None, "ffn")),
               "b": P((h,), ("ffn",), "zeros")},
        "pos": P((S, h), (None, None), scale=0.02),
        "l2": {"w": P((h, h), ("ffn", None)), "b": P((h,), (None,), "zeros")},
        "out": P((h, V), (None, "vocab"), scale=0.02),
    }


def _gen_apply(params, z, cfg, temp: float = 1.0):
    """z: (B, z_dim) -> soft token distributions (B, S, V); the softmax
    by ``models.common.softmax`` (position-free on the CPU)."""
    h = torch.relu(z @ params["l1"]["w"] + params["l1"]["b"])
    h = h[:, None, :] + params["pos"][None]
    h = torch.relu(h @ params["l2"]["w"] + params["l2"]["b"])
    logits = h @ params["out"]
    return softmax(logits / temp, dim=-1)


def make_lm_pair(cfg: LMGanConfig) -> GanPair:
    """A GanPair whose D is a backbone critic: it drops into every
    approach of ``core/approaches.py`` unchanged."""
    if cfg.backbone.arch_type == "audio":
        raise ValueError("the audio family cannot be a critic: its decoder "
                         "attends to an encoder output the critic never "
                         "computes")
    V = cfg.backbone.vocab_size

    def d_apply(params, x):
        """Logits (B,) of one critic, or (U, B) of critics stacked on a
        leading user axis, against x: int tokens (B, S) or soft tokens
        (B, S, V) every user sees, or per-user (U, B, S) / (U, B, S, V)."""
        if not x.is_floating_point():
            x = F.one_hot(x.long(), V).to(torch.float32)
        if params["embed"].ndim == 2:
            return _critic_apply(params, x, cfg)
        per_user = x.ndim == 4
        return torch.stack([
            _critic_apply(tree_map(lambda t: t[u], params),
                          x[u] if per_user else x, cfg)
            for u in range(params["embed"].shape[0])])

    return GanPair(cfg, _gen_decls(cfg), _critic_decls(cfg),
                   lambda p, z: _gen_apply(p, z, cfg), d_apply, cfg.z_dim)


def critic_lm_config(cfg: LMGanConfig):
    """The critic backbone as a servable LM ``ModelConfig``.  The critic
    owns an embedding matrix but no unembed, so the served LM ties its
    logits to the embedding (``tie_embeddings=True``): exactly the tree
    :func:`critic_lm_params` exports."""
    return dataclasses.replace(cfg.backbone, tie_embeddings=True)


def critic_lm_params(critic_params):
    """A federation-trained critic's backbone as LM params: without the
    realness ``head``, what remains (embed + layer stack + final_norm) is
    a complete parameter tree for ``models.model.decode_step`` under
    :func:`critic_lm_config`, which the continuous-batching decode engine
    (``serve/decode.py``) serves."""
    return {k: v for k, v in critic_params.items() if k != "head"}


def user_token_stream(vocab: int, seq: int, *, a: int, c: int,
                      strength: float = 0.9):
    """A user's private domain: tokens following x_{t+1} = a*x_t + c mod V
    with probability ``strength`` (distinct (a, c) per user = distinct
    domains, the LM analogue of per-user digit classes); numpy, the
    reference's draws bit for bit."""

    def sample(rng: np.random.Generator, n: int):
        toks = np.empty((n, seq), np.int32)
        toks[:, 0] = rng.integers(0, vocab, n)
        for t in range(seq - 1):
            nxt = (a * toks[:, t] + c) % vocab
            rand = rng.integers(0, vocab, n)
            follow = rng.random(n) < strength
            toks[:, t + 1] = np.where(follow, nxt, rand)
        return toks

    return sample


def bigram_match_score(samples, a: int, c: int, vocab: int) -> float:
    """Fraction of adjacent pairs following a user's planted bigram:
    whether G learned that user's domain.  ``samples``: soft (n, S, V) or
    token (n, S) arrays."""
    samples = np.asarray(samples)
    toks = samples.argmax(-1) if samples.ndim == 3 else samples
    nxt = (a * toks[:, :-1] + c) % vocab
    return float((toks[:, 1:] == nxt).mean())
