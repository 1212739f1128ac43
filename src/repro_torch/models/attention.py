"""Attention (port of the reference's ``models/attention.py``): GQA/MHA
declarations and the full-sequence forward (causal, sliding window or
none) for train / prefill / scoring.

The plain path (``sdpa`` with ``causal_mask``) is the reference's default
jnp path; ``use_flash=True`` sends q/k/v to ``kernels.ops.flash_attention``
(the Hopper kernel on a CUDA tensor).  ``attn_decode`` is the
single-token decode against a KV cache, with a ring buffer for sliding
windows and one position per batch row.  Not ported yet: MLA,
cross-attention and ``blockwise_sdpa`` (ROADMAP queue A item 12).
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


def _row_positions(index, B: int, device) -> torch.Tensor:
    """``index`` (an int or a (B,) tensor) as (B,) int64 positions."""
    if isinstance(index, torch.Tensor):
        return index.to(device=device, dtype=torch.int64).expand(B)
    return torch.full((B,), int(index), dtype=torch.int64, device=device)


def attn_decode(params, x, cfg, cache, index, *, window=0):
    """One-token decode.  x: (B,1,d); cache: {"k": (B,T,K,hd), "v": ...}, T
    the window for sliding-window layers (a ring buffer: position i in slot
    i % T), else max_seq.  ``index`` is the new token's absolute position:
    an int, or a (B,) tensor with each row's own (the decode engine's
    slots).  Returns (y (B,1,d), the updated cache, new tensors)."""
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(params, x, cfg)
    pos = _row_positions(index, B, x.device)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k_new = apply_rope(k_new, pos[:, None], cfg.rope_theta)
    T = cache["k"].shape[1]
    # the reference's dynamic_update_slice clamps a start past the end
    slot = pos % T if window > 0 else torch.clamp(pos, max=T - 1)
    rows = torch.arange(B, device=x.device)
    k = cache["k"].index_put((rows, slot), k_new[:, 0].to(cache["k"].dtype))
    v = cache["v"].index_put((rows, slot), v_new[:, 0].to(cache["v"].dtype))
    kp = torch.arange(T, device=x.device)
    at = pos[:, None]
    if window:
        # ring buffer: slot s holds position index - ((index - s) mod T)
        pos_of_slot = at - torch.remainder(at - kp, T)
        valid = (pos_of_slot >= 0) & (pos_of_slot > at - window) & \
            (pos_of_slot <= at)
    else:
        valid = kp <= at
    out = sdpa(q, k, v, valid[:, None, None, None, :],
               1.0 / math.sqrt(cfg.head_dim))
    H, hd, d = params["wo"].shape
    y = out.reshape(B, 1, H * hd) @ params["wo"].reshape(H * hd, d)
    return y, {"k": k, "v": v}


def cross_attn_decls(cfg):
    not_ported("cross-attention")


def cross_attn_forward(*args, **kwargs):
    not_ported("cross-attention")


def mla_forward(*args, **kwargs):
    not_ported("MLA attention")


def mla_decode(*args, **kwargs):
    not_ported("MLA decode")
