"""Mamba-2 SSD (state-space duality) block (port of the reference's
``models/ssm.py``): declarations, the depthwise causal conv, the model's
own chunked SSD (``ssd_chunked``, the plain path) and the full-sequence
block forward.  ``use_kernel=True`` sends the scan to
``kernels.ops.ssd_scan`` (the Hopper kernel on a CUDA tensor).  Not ported
yet: ``ssm_decode`` (ROADMAP queue A item 12).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.common import P, not_ported, rms_norm


def _a_log_init(generator, shape, dtype):
    """log of uniform(1, 16), as the reference draws ``A_log``."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return torch.log(u * 15.0 + 1.0).to(dtype)


def ssm_decls(cfg):
    d = cfg.d_model
    di = cfg.d_inner
    H = cfg.ssm_heads
    G, N, W = cfg.ssm_n_groups, cfg.ssm_state, cfg.conv_width
    return {
        "w_z": P((d, di), ("embed", "heads")),
        "w_x": P((d, di), ("embed", "heads")),
        "w_B": P((d, G * N), ("embed", None)),
        "w_C": P((d, G * N), ("embed", None)),
        "w_dt": P((d, H), ("embed", "ssm_heads")),
        "dt_bias": P((H,), ("ssm_heads",), "zeros"),
        "A_log": P((H,), ("ssm_heads",), "custom", fn=_a_log_init),
        "D": P((H,), ("ssm_heads",), "ones"),
        "conv_x": P((W, di), (None, "heads"), scale=0.2),
        "conv_B": P((W, G * N), (None, None), scale=0.2),
        "conv_C": P((W, G * N), (None, None), scale=0.2),
        "gate_norm": {"scale": P((di,), (None,), "zeros")},
        "w_out": P((di, d), ("heads", "embed")),
    }


def causal_conv1d(x, w):
    """x: (B,S,C), w: (W,C) depthwise causal conv (no bias)."""
    W = w.shape[0]
    S = x.shape[1]
    xp = torch.cat([x.new_zeros((x.shape[0], W - 1, x.shape[2])), x], dim=1)
    return sum(xp[:, i:i + S, :] * w[i] for i in range(W))


def _pad_seq(a, pad: int):
    """Zero-pad dim 1 (the sequence) at the tail."""
    return torch.cat([a, a.new_zeros((a.shape[0], pad, *a.shape[2:]))],
                     dim=1)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int):
    """SSD chunked scan, the model's plain form.

    x:  (B,S,H,P)   inputs (already conv'd + activated)
    dt: (B,S,H)     post-softplus step sizes
    A:  (H,)        negative decay rates
    Bm/Cm: (B,S,G,N)
    Returns y: (B,S,H,P) and final state (B,H,N,P).  Intermediates are
    rounded to x's type where the reference rounds them.
    """
    Bsz, S, H, P_ = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    S_orig = S
    if S % chunk:
        # zero-pad the tail: dt=0 there makes both decay (exp(0)=1) and the
        # injected input (dt*x=0) inert for causal outputs before the pad.
        pad = chunk - S % chunk
        x, dt, Bm, Cm = (_pad_seq(a, pad) for a in (x, dt, Bm, Cm))
        S = S + pad
    nc = S // chunk
    rep = H // G
    Bh = torch.repeat_interleave(Bm, rep, dim=2)
    Ch = torch.repeat_interleave(Cm, rep, dim=2)

    f32 = torch.float32
    xc = x.reshape(Bsz, nc, chunk, H, P_)
    dtc = dt.reshape(Bsz, nc, chunk, H).to(f32)
    Bc = Bh.reshape(Bsz, nc, chunk, H, N)
    Cc = Ch.reshape(Bsz, nc, chunk, H, N)

    dA = dtc * A.to(f32)                          # (B,nc,cl,H), negative
    cum = torch.cumsum(dA, dim=2)                 # inclusive cumsum
    xdt = (xc.to(f32) * dtc[..., None]).to(x.dtype)

    # --- intra-chunk (quadratic within chunk) ---
    idx = torch.arange(chunk, device=x.device)
    tri = idx[:, None] >= idx[None, :]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,i,j,H)
    # mask BEFORE exp: the i<j entries have positive diff that can overflow
    diff = diff.masked_fill(~tri[None, None, :, :, None], float("-inf"))
    L = torch.exp(diff)
    scores = torch.einsum("bcihn,bcjhn->bcijh", Cc.to(f32), Bc.to(f32))
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", (scores * L).to(x.dtype),
                           xdt)

    # --- chunk summary states ---
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)      # (B,nc,cl,H)
    S_chunk = torch.einsum(
        "bcjhn,bcjhp->bchnp",
        (Bc.to(f32) * decay_to_end[..., None]).to(x.dtype), xdt)

    # --- inter-chunk recurrence (loop over nc) ---
    total = torch.exp(cum[:, :, -1, :])                    # (B,nc,H)
    state = torch.zeros((Bsz, H, N, P_), dtype=f32, device=x.device)
    before = []
    for c in range(nc):
        before.append(state)
        state = state * total[:, c, :, None, None] + S_chunk[:, c].to(f32)
    state_before = torch.stack(before, dim=1)              # (B,nc,H,N,P)

    y_inter = torch.einsum(
        "bcihn,bchnp->bcihp",
        (Cc.to(f32) * torch.exp(cum)[..., None]).to(x.dtype),
        state_before.to(x.dtype))
    y = (y_intra + y_inter).reshape(Bsz, S, H, P_)
    return y[:, :S_orig], state


def ssm_forward(params, x, cfg, use_kernel: bool = False):
    """Full-sequence Mamba-2 block. x: (B,S,d) -> (B,S,d)."""
    B, S, _ = x.shape
    H, P_, G, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_n_groups, cfg.ssm_state

    z = x @ params["w_z"]
    xin = x @ params["w_x"]
    Bm = x @ params["w_B"]
    Cm = x @ params["w_C"]
    dt_raw = x @ params["w_dt"]

    xin = F.silu(causal_conv1d(xin, params["conv_x"]))
    Bm = F.silu(causal_conv1d(Bm, params["conv_B"]))
    Cm = F.silu(causal_conv1d(Cm, params["conv_C"]))

    dt = F.softplus(dt_raw.to(torch.float32) + params["dt_bias"])
    A = -torch.exp(params["A_log"].to(torch.float32))

    xh = xin.reshape(B, S, H, P_)
    Bh = Bm.reshape(B, S, G, N)
    Ch = Cm.reshape(B, S, G, N)

    if use_kernel:
        y = kops.ssd_scan(xh, dt, A, Bh, Ch, chunk=cfg.chunk_size)
    else:
        y, _ = ssd_chunked(xh, dt, A, Bh, Ch, cfg.chunk_size)
    y = y + xh * params["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(B, S, cfg.d_inner)
    y = rms_norm(y * F.silu(z.to(torch.float32)).to(y.dtype),
                 params["gate_norm"]["scale"], cfg.norm_eps)
    return y @ params["w_out"]


def ssm_decode(*args, **kwargs):
    not_ported("ssm_decode")
