"""Attention (port of the reference's ``models/attention.py``): GQA/MHA
declarations and the full-sequence forward (causal, sliding window or
none) for train / prefill / scoring.

The plain path (``sdpa`` with ``causal_mask``) is the reference's default
jnp path; ``use_flash=True`` sends q/k/v to ``kernels.ops.flash_attention``
(the Hopper kernel on a CUDA tensor).  Not ported yet: MLA, cross-attention,
``blockwise_sdpa`` and the single-token decode (ROADMAP queue A item 12).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.common import (P, apply_rope, not_ported, rms_norm,
                                       softcap)

NEG_INF = -2.0e38


# ---------------------------------------------------------------------------
# Declarations
# ---------------------------------------------------------------------------

def attn_decls(cfg):
    if cfg.use_mla:
        not_ported("MLA attention")
    d, H, K, hd = cfg.d_model, cfg.padded_heads, cfg.num_kv_heads, cfg.head_dim
    decls = {
        "wq": P((d, H, hd), ("embed", "heads", None)),
        "wk": P((d, K, hd), ("embed", "kv_heads", None)),
        "wv": P((d, K, hd), ("embed", "kv_heads", None)),
        "wo": P((H, hd, d), ("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        decls["bq"] = P((H, hd), ("heads", None), "zeros")
        decls["bk"] = P((K, hd), ("kv_heads", None), "zeros")
        decls["bv"] = P((K, hd), ("kv_heads", None), "zeros")
    if cfg.qk_norm:
        decls["q_norm"] = {"scale": P((hd,), (None,), "zeros")}
        decls["k_norm"] = {"scale": P((hd,), (None,), "zeros")}
    return decls


# ---------------------------------------------------------------------------
# Core scaled-dot-product attention (grouped)
# ---------------------------------------------------------------------------

def sdpa(q, k, v, mask, scale: float, cap: float = 0.0):
    """q: (B,S,H,dq)  k: (B,T,K,dq)  v: (B,T,K,dv)  mask: broadcastable to
    (B,K,G,S,T) with True = attend.  Scores and softmax in f32, the
    probabilities cast to v's type for the weighted sum."""
    B, S, H, dq = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, dq)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    logits = softcap(logits, cap)
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, S, K * G, v.shape[-1])


def causal_mask(S: int, T: int, q_offset=0, window: int = 0, device=None):
    """(1,1,1,S,T) boolean mask; window=0 means full causal."""
    qp = torch.arange(S, device=device)[:, None] + q_offset
    kp = torch.arange(T, device=device)[None, :]
    m = kp <= qp
    if window:
        m &= kp > qp - window
    return m[None, None, None]


def blockwise_sdpa(*args, **kwargs):
    not_ported("blockwise_sdpa (cfg.attn_impl='blockwise')")


# ---------------------------------------------------------------------------
# Standard (GQA) attention
# ---------------------------------------------------------------------------

def _heads(x, w):
    """x (B,S,d) @ w (d,H,k) -> (B,S,H,k)."""
    d, H, kd = w.shape
    return (x @ w.reshape(d, H * kd)).reshape(*x.shape[:-1], H, kd)


def _project_qkv(params, x, cfg):
    q = _heads(x, params["wq"])
    k = _heads(x, params["wk"])
    v = _heads(x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"]["scale"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"]["scale"], cfg.norm_eps)
    return q, k, v


def attn_forward(params, x, cfg, *, positions, causal=True, window=0,
                 use_flash=False):
    """Full-sequence attention (train / prefill)."""
    if cfg.attn_impl == "blockwise" and not use_flash:
        not_ported("blockwise_sdpa (cfg.attn_impl='blockwise')")
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    if use_flash:
        blk = min(128, S)
        out = kops.flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale, bq=blk, bkv=blk)
    else:
        if causal:
            mask = causal_mask(S, S, 0, window, device=x.device)
        else:
            mask = torch.ones((1, 1, 1, S, S), dtype=torch.bool,
                              device=x.device)
        out = sdpa(q, k, v, mask, scale)
    H, hd, d = params["wo"].shape
    return out.reshape(B, S, H * hd) @ params["wo"].reshape(H * hd, d)


def attn_decode(*args, **kwargs):
    not_ported("attn_decode")


def cross_attn_decls(cfg):
    not_ported("cross-attention")


def cross_attn_forward(*args, **kwargs):
    not_ported("cross-attention")


def mla_forward(*args, **kwargs):
    not_ported("MLA attention")


def mla_decode(*args, **kwargs):
    not_ported("MLA decode")
