"""Mamba-2 SSD (state-space duality) block (port of the reference's
``models/ssm.py``): declarations, the depthwise causal conv, the model's
own chunked SSD (``ssd_chunked``, the plain path) and the full-sequence
block forward.  ``use_kernel=True`` sends the scan to
``kernels.ops.ssd_scan`` (the Hopper kernel on a CUDA tensor).
``conv_step`` and ``ssm_decode`` are the one-token recurrence against the
(conv, SSD state) cache.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.common import (P, on_blocks, on_mesh, rms_norm,
                                       silu, softplus)


def _a_log_init(generator, shape, dtype):
    """log of uniform(1, 16), as the reference draws ``A_log``."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=generator.device)
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


_BSHX = ("b", None, "h", None)


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

    xin = silu(causal_conv1d(xin, params["conv_x"]))
    Bm = silu(causal_conv1d(Bm, params["conv_B"]))
    Cm = silu(causal_conv1d(Cm, params["conv_C"]))

    dt = softplus(dt_raw.to(torch.float32) + params["dt_bias"])
    A = -torch.exp(params["A_log"].to(torch.float32))

    xh = xin.reshape(B, S, H, P_)
    Bh = Bm.reshape(B, S, G, N)
    Ch = Cm.reshape(B, S, G, N)

    if use_kernel:
        y = kops.ssd_scan(xh, dt, A, Bh, Ch, chunk=cfg.chunk_size)
    elif on_mesh(xh):
        # each rank scans its block of (batch, heads), B and C repeated to
        # the heads first (head h reads group h // (H / G))
        Bh, Ch = (t[:, :, :, None].expand(B, S, G, H // G, N)
                  .reshape(B, S, H, N) for t in (Bh, Ch))
        y, _ = on_blocks(
            lambda *a: ssd_chunked(*a, cfg.chunk_size),
            (xh, dt, A, Bh, Ch),
            (_BSHX, ("b", None, "h"), ("h",), _BSHX, _BSHX),
            (_BSHX, ("b", "h", None, None)))
    else:
        y, _ = ssd_chunked(xh, dt, A, Bh, Ch, cfg.chunk_size)
    y = y + xh * params["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(B, S, cfg.d_inner)
    y = rms_norm(y * silu(z.to(torch.float32)).to(y.dtype),
                 params["gate_norm"]["scale"], cfg.norm_eps)
    return y @ params["w_out"]


def conv_step(x_new, conv_state, w):
    """x_new: (B,C); conv_state: (B,W-1,C) of the previous inputs, oldest
    first; w: (W,C).  Returns (y (B,C), the new state).  The taps are
    summed in order, as ``causal_conv1d`` sums them."""
    full = torch.cat([conv_state, x_new[:, None, :]], dim=1)   # (B,W,C)
    y = sum(full[:, i, :] * w[i] for i in range(w.shape[0]))
    return y, full[:, 1:, :]


def ssm_decode(params, x, cfg, state):
    """One-step decode.  x: (B,1,d); state = {"ssd": (B,H,N,P) f32,
    "conv_x": (B,W-1,di), "conv_B": ..., "conv_C": ...}.  Returns (y
    (B,1,d), the new state)."""
    B = x.shape[0]
    H, P_, G, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_n_groups, cfg.ssm_state
    f32 = torch.float32
    xt = x[:, 0, :]

    z = xt @ params["w_z"]
    xin = xt @ params["w_x"]
    Bm = xt @ params["w_B"]
    Cm = xt @ params["w_C"]
    dt_raw = xt @ params["w_dt"]

    xin, conv_x = conv_step(xin, state["conv_x"], params["conv_x"])
    Bm, conv_B = conv_step(Bm, state["conv_B"], params["conv_B"])
    Cm, conv_C = conv_step(Cm, state["conv_C"], params["conv_C"])
    xin, Bm, Cm = silu(xin), silu(Bm), silu(Cm)

    dt = softplus(dt_raw.to(f32) + params["dt_bias"])      # (B,H)
    A = -torch.exp(params["A_log"].to(f32))
    dA = torch.exp(dt * A)                                    # (B,H)

    xh = xin.reshape(B, H, P_)
    rep = H // G
    Bh = torch.repeat_interleave(Bm.reshape(B, G, N), rep, dim=1)   # (B,H,N)
    Ch = torch.repeat_interleave(Cm.reshape(B, G, N), rep, dim=1)

    upd = Bh.to(f32)[..., :, None] * (xh.to(f32) * dt[..., None])[..., None, :]
    ssd = state["ssd"] * dA[..., None, None] + upd
    y = on_blocks(lambda c, st: torch.einsum("bhn,bhnp->bhp", c, st),
                  (Ch.to(f32), ssd),
                  (("b", "h", None), ("b", "h", None, None)),
                  ("b", "h", None))
    y = y.to(x.dtype) + xh * params["D"].to(x.dtype)[None, :, None]
    y = y.reshape(B, cfg.d_inner)
    y = rms_norm(y * silu(z.to(f32)).to(y.dtype),
                 params["gate_norm"]["scale"], cfg.norm_eps)
    out = y @ params["w_out"]
    return out[:, None, :], {"ssd": ssd, "conv_x": conv_x,
                             "conv_B": conv_B, "conv_C": conv_C}
