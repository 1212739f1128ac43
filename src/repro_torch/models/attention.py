"""Attention (port of the reference's ``models/attention.py``): GQA/MHA
(full, causal, sliding window), MLA (DeepSeek-V2 compressed KV),
cross-attention, and single-token decode against a cache.

The plain path (``sdpa`` with ``causal_mask``) is the reference's default
jnp path; ``use_flash=True`` sends q/k/v to ``kernels.ops.flash_attention``
(the Hopper kernel on a CUDA tensor); ``cfg.attn_impl = "blockwise"``
takes ``blockwise_sdpa``, the online-softmax recurrence over kv blocks in
plain torch.  ``attn_decode`` and ``mla_decode`` take one token against a
cache, with one position per batch row (the decode engine's slots); a
sliding window keeps a ring buffer.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.common import (P, apply_norm, apply_rope,
                                       norm_decl, on_blocks, on_mesh,
                                       rms_norm, softcap)

NEG_INF = -2.0e38


# ---------------------------------------------------------------------------
# Declarations
# ---------------------------------------------------------------------------

def attn_decls(cfg):
    d, H, K, hd = cfg.d_model, cfg.padded_heads, cfg.num_kv_heads, cfg.head_dim
    if cfg.use_mla:
        qk_hd = cfg.nope_head_dim + cfg.rope_head_dim
        return {
            "wq": P((d, H, qk_hd), ("embed", "heads", None)),
            "w_dkv": P((d, cfg.kv_lora_rank), ("embed", "kv_lora")),
            "w_kr": P((d, cfg.rope_head_dim), ("embed", None)),
            "kv_norm": norm_decl(cfg, cfg.kv_lora_rank),
            "w_uk": P((cfg.kv_lora_rank, H, cfg.nope_head_dim),
                      ("kv_lora", "heads", None)),
            "w_uv": P((cfg.kv_lora_rank, H, cfg.v_head_dim),
                      ("kv_lora", "heads", None)),
            "wo": P((H, cfg.v_head_dim, d), ("heads", None, "embed")),
        }
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
    probabilities cast to v's type for the weighted sum.  On a mesh it
    runs on each rank's block of (batch, heads) (``_sdpa_blocks``); where
    q's heads are sharded, k and v are repeated to H heads first (head h
    reads kv head h // G, as the grouping does), since a shard boundary
    need not fall between kv groups (32 heads over 4 kv heads on a 16-way
    model axis)."""
    B, S, H, dq = q.shape
    K = k.shape[2]
    G = H // K
    if on_mesh(q):
        if G > 1 and any(p.is_shard() and p.dim == 2 for p in q.placements):
            k, v = (t[:, :, :, None].expand(*t.shape[:3], G, t.shape[-1])
                    .reshape(B, t.shape[1], H, t.shape[-1]) for t in (k, v))
        return _sdpa_blocks(q, k, v, mask, scale, cap)
    qg = q.reshape(B, S, K, G, dq)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    logits = softcap(logits, cap)
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, S, K * G, v.shape[-1])


_BSHD = ("b", None, "h", None)


def _sdpa_blocks(q, k, v, mask, scale: float, cap: float):
    """``sdpa`` of DTensors (q, k and v with H heads each) on each rank's
    block of (batch, heads), which attend independently
    (``common.on_blocks``): DTensor's einsum rules would flatten two
    sharded dims, which some releases refuse."""
    return on_blocks(lambda q, k, v, m: sdpa(q, k, v, m, scale, cap),
                     (q, k, v, mask), (_BSHD,) * 3 + (("b",) + (None,) * 4,),
                     _BSHD)


def causal_mask(S: int, T: int, q_offset=0, window: int = 0, device=None):
    """(1,1,1,S,T) boolean mask; window=0 means full causal."""
    qp = torch.arange(S, device=device)[:, None] + q_offset
    kp = torch.arange(T, device=device)[None, :]
    m = kp <= qp
    if window:
        m &= kp > qp - window
    return m[None, None, None]


def blockwise_sdpa(q, k, v, scale: float, *, causal=True, window=0,
                   block=512, cap: float = 0.0):
    """Online-softmax attention over kv blocks of ``block`` keys, the flash
    recurrence in plain torch (the reference's ``lax.scan`` becomes a loop
    over the blocks): never builds the (S x T) score matrix.  f32 m, l
    and accumulator; p cast to v's type for its product."""
    B, S, H, dq = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    if T % block:
        raise ValueError(f"blockwise_sdpa: T={T} is not a multiple of "
                         f"block={block}")
    f32 = torch.float32
    qg = q.reshape(B, S, K, G, dq).to(f32)
    qpos = torch.arange(S, device=q.device)
    m = torch.full((B, K, G, S), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((B, K, G, S), dtype=f32, device=q.device)
    acc = torch.zeros((B, K, G, S, v.shape[-1]), dtype=f32, device=q.device)
    for ib in range(T // block):
        kblk = k[:, ib * block:(ib + 1) * block]
        vblk = v[:, ib * block:(ib + 1) * block]
        s = torch.einsum("bskgd,btkd->bkgst", qg, kblk.to(f32)) * scale
        s = softcap(s, cap)
        kpos = ib * block + torch.arange(block, device=q.device)
        mask = torch.ones((S, block), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window:
            mask &= kpos[None, :] > qpos[:, None] - window
        s = s.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None]).masked_fill(~mask, 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + torch.sum(p, dim=-1)
        acc = alpha[..., None] * acc + torch.einsum(
            "bkgst,btkd->bkgsd", p.to(v.dtype).to(f32), vblk.to(f32))
        m = m_new
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(v.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, v.shape[-1])


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
    S = x.shape[1]
    q, k, v = _project_qkv(params, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    if use_flash:
        blk = min(128, S)
        out = kops.flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale, bq=blk, bkv=blk)
    elif cfg.attn_impl == "blockwise":
        out = blockwise_sdpa(q, k, v, scale, causal=causal, window=window,
                             block=min(cfg.attn_block, S))
    else:
        if causal:
            mask = causal_mask(S, S, 0, window, device=x.device)
        else:
            mask = torch.ones((1, 1, 1, S, S), dtype=torch.bool,
                              device=x.device)
        out = sdpa(q, k, v, mask, scale)
    return _out_proj(out, params["wo"])


def _out_proj(out, wo):
    """(B,S,H,k) @ wo (H,k,d) -> (B,S,d)."""
    B, S = out.shape[:2]
    H, kd, d = wo.shape
    return out.reshape(B, S, H * kd) @ wo.reshape(H * kd, d)


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
    return _out_proj(out, params["wo"]), {"k": k, "v": v}


# ---------------------------------------------------------------------------
# Cross-attention (enc-dec)
# ---------------------------------------------------------------------------

def cross_attn_decls(cfg):
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": P((d, H, hd), ("embed", "heads", None)),
        "wk": P((d, K, hd), ("embed", "kv_heads", None)),
        "wv": P((d, K, hd), ("embed", "kv_heads", None)),
        "wo": P((H, hd, d), ("heads", None, "embed")),
    }


def cross_attn_forward(params, x, enc_out, cfg):
    """x (B,S,d) attends to every position of enc_out (B,T,d)."""
    q = _heads(x, params["wq"])
    k = _heads(enc_out, params["wk"])
    v = _heads(enc_out, params["wv"])
    mask = torch.ones((1, 1, 1, x.shape[1], k.shape[1]), dtype=torch.bool,
                      device=x.device)
    out = sdpa(q, k, v, mask, 1.0 / math.sqrt(cfg.head_dim))
    return _out_proj(out, params["wo"])


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------

def _mla_latents(params, x, cfg, positions):
    """The compressed kv (normed c_kv (B,S,r)) and the shared rotated key
    part (B,S,rhd) of x at ``positions`` (B,S)."""
    c_kv = apply_norm(params["kv_norm"], x @ params["w_dkv"], cfg)
    k_rope = apply_rope(x @ params["w_kr"], positions, cfg.rope_theta)
    return c_kv, k_rope


def _mla_query(params, x, cfg, positions):
    nhd = cfg.nope_head_dim
    q = _heads(x, params["wq"])
    return q[..., :nhd], apply_rope(q[..., nhd:], positions, cfg.rope_theta)


def mla_forward(params, x, cfg, *, positions):
    """Full-sequence MLA, causal: k = [c_kv w_uk, k_rope], v = c_kv w_uv."""
    B, S, _ = x.shape
    H, rhd = cfg.num_heads, cfg.rope_head_dim
    q_nope, q_rope = _mla_query(params, x, cfg, positions)
    c_kv, k_rope = _mla_latents(params, x, cfg, positions)
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, params["w_uk"])
    v = torch.einsum("bsr,rhk->bshk", c_kv, params["w_uv"])
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, rhd)],
                  dim=-1)
    qfull = torch.cat([q_nope, q_rope], dim=-1)
    out = sdpa(qfull, k, v, causal_mask(S, S, device=x.device),
               1.0 / math.sqrt(cfg.nope_head_dim + rhd))
    return _out_proj(out, params["wo"])


def mla_decode(params, x, cfg, cache, index):
    """Decode against the *compressed* MLA cache {"c_kv": (B,T,r),
    "k_rope": (B,T,rhd)}, r + rhd numbers a token instead of 2 H hd.
    Absorbed form: w_uk is folded into the query, so the scores are taken
    against c_kv directly and no T-long k is built; w_uv after the
    weighted sum.  ``index`` is an int or one position per row, as
    ``attn_decode`` takes it."""
    B = x.shape[0]
    pos = _row_positions(index, B, x.device)
    q_nope, q_rope = _mla_query(params, x, cfg, pos[:, None])
    c_new, kr_new = _mla_latents(params, x, cfg, pos[:, None])
    T = cache["c_kv"].shape[1]
    # the reference's dynamic_update_slice clamps a start past the end
    slot = torch.clamp(pos, max=T - 1)
    rows = torch.arange(B, device=x.device)
    c_kv = cache["c_kv"].index_put((rows, slot),
                                   c_new[:, 0].to(cache["c_kv"].dtype))
    k_rope = cache["k_rope"].index_put((rows, slot),
                                       kr_new[:, 0].to(cache["k_rope"].dtype))
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, params["w_uk"])
    s_nope = torch.einsum("bshr,btr->bhst", q_lat, c_kv)
    s_rope = torch.einsum("bshk,btk->bhst", q_rope, k_rope)
    logits = (s_nope + s_rope) / math.sqrt(cfg.nope_head_dim
                                           + cfg.rope_head_dim)
    valid = torch.arange(T, device=x.device)[None, :] <= pos[:, None]
    logits = logits.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    ctx = torch.einsum("bhst,btr->bshr", probs.to(c_kv.dtype), c_kv)
    out = torch.einsum("bshr,rhk->bshk", ctx, params["w_uv"])
    return _out_proj(out, params["wo"]), {"c_kv": c_kv, "k_rope": k_rope}
