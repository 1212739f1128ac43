"""RG-LRU recurrent block (port of the reference's ``models/rglru.py``,
Griffin / RecurrentGemma).

The gated linear recurrence h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t *
x_t) runs as a log-depth doubling scan over time for train / prefill (the
reference uses ``jax.lax.associative_scan``, whose tree pairs the steps in
another order, so the two agree to f32 rounding), and as a single step for
decode.  Plain PyTorch: the reference has no kernel here.

As in the reference, the gate projections are dense (lru_width x
lru_width) where Griffin's are block-diagonal.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import P, activation, exp, log_sigmoid, sigmoid
from repro_torch.prng import fma
from repro_torch.models.ssm import causal_conv1d, conv_step

_C = 8.0  # Griffin's fixed recurrence exponent


def _lambda_init(generator, shape, dtype):
    """a = sigmoid(L)^c in about (0.9, 0.999): draw a uniform target and
    invert it, as the reference draws ``lam``."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=generator.device) * (0.999 - 0.9) + 0.9
    s = u ** (1.0 / _C)
    return torch.log(s / (1 - s)).to(dtype)


def rglru_decls(cfg):
    d, r = cfg.d_model, cfg.lru_width
    return {
        "w_gelu": P((d, r), ("embed", "lru_dim")),
        "w_rec": P((d, r), ("embed", "lru_dim")),
        "conv_w": P((cfg.conv_width, r), (None, "lru_dim"), scale=0.2),
        "w_a": P((r, r), ("lru_dim", None)),
        "b_a": P((r,), (None,), "zeros"),
        "w_i": P((r, r), ("lru_dim", None)),
        "b_i": P((r,), (None,), "zeros"),
        "lam": P((r,), ("lru_dim",), "custom", fn=_lambda_init),
        "w_out": P((r, d), ("lru_dim", "embed")),
    }


def _gates(params, x):
    """x: (..., r) -> (a, gated input b), both f32."""
    f32 = torch.float32
    r = sigmoid(x @ params["w_a"].to(x.dtype) + params["b_a"].to(x.dtype))
    i = sigmoid(x @ params["w_i"].to(x.dtype) + params["b_i"].to(x.dtype))
    log_lam = log_sigmoid(params["lam"].to(f32))
    log_a = _C * r.to(f32) * log_lam                     # (..., r), negative
    a = exp(log_a)
    # a^2 as exp(2 log a), which is what the reference's jitted XLA makes
    # of a * a (exp(u) exp(v) -> exp(u + v)): near a = 1, 1 - a^2 keeps
    # only the bits that a^2 carries below 1
    b = torch.sqrt(torch.clamp(1.0 - exp(log_a + log_a), min=1e-12)) * \
        (i.to(f32) * x.to(f32))
    return a, b


def rglru_scan(params, x):
    """x: (B, S, r) -> h: (B, S, r) with h_0 = 0, in x's type.  Doubling
    scan over time: after the step of stride s, (a_t, b_t) composes the
    steps t - 2s + 1 .. t, each pair combined as the reference's
    ``combine`` does, (a1 a2, a2 b1 + b2), the latter one fused
    multiply-add."""
    a, b = _gates(params, x)
    S = x.shape[1]
    s = 1
    while s < S:
        b = torch.cat([b[:, :s], fma(a[:, s:], b[:, :-s], b[:, s:])], dim=1)
        a = torch.cat([a[:, :s], a[:, :-s] * a[:, s:]], dim=1)
        s *= 2
    return b.to(x.dtype)


def rglru_block_forward(params, x, cfg):
    """Griffin recurrent block: (gelu branch) * (conv -> RG-LRU branch)."""
    g = activation("gelu")(x @ params["w_gelu"])
    u = causal_conv1d(x @ params["w_rec"], params["conv_w"])
    h = rglru_scan(params, u)
    return (g * h) @ params["w_out"]


def rglru_block_decode(params, x, cfg, state):
    """One-step decode.  x: (B, 1, d); state = {"h": (B, r) f32, "conv":
    (B, W-1, r)}.  Returns (y (B, 1, d), the new state)."""
    xt = x[:, 0, :]
    g = activation("gelu")(xt @ params["w_gelu"])
    u, conv = conv_step(xt @ params["w_rec"], state["conv"],
                        params["conv_w"])
    a, b = _gates(params, u)
    h = fma(a, state["h"], b)
    out = (g * h.to(g.dtype)) @ params["w_out"]
    return out[:, None, :], {"h": h, "conv": conv}
