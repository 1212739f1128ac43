"""Plain reference of ``paper-mlp``: the MNIST MLP pair of Distributed-GAN
(arXiv:1911.08128, section 6, Tables 1-2), and the operations a round of
approach 1 needs, counted from the layer shapes.

D: x -> Linear 256 -> LeakyReLU(0.2) -> Linear 256 -> LeakyReLU(0.2) ->
Linear 1 (a logit).  G: z -> Linear 256 -> ReLU -> Linear 256 -> ReLU ->
Linear 784 -> tanh.  Weights are ``(in, out)``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _widths(cfg):
    h, g = cfg["d_hidden"], cfg["g_hidden"]
    d = [(cfg["data_dim"], h), (h, h), (h, 1)]
    return d, [(cfg["z_dim"], g), (g, g), (g, cfg["data_dim"])]


def _mlp(gen, widths):
    out = {}
    for i, (a, b) in enumerate(widths, 1):
        w = torch.randn((a, b), generator=gen, dtype=torch.float32)
        out[f"l{i}"] = {"b": torch.zeros(b), "w": w * (1.0 / math.sqrt(a))}
    return out


def init(cfg, gen):
    """``(g, d)`` drawn from ``gen``: G's leaves before D's, each tree's
    leaves in sorted-key order (a bias, all zeros, draws nothing)."""
    d_w, g_w = _widths(cfg)
    g = _mlp(gen, g_w)
    return g, _mlp(gen, d_w)


def _linear(x, layer, prec):
    return torch.matmul(prec.operand(x), prec.operand(layer["w"])) + layer["b"]


def d_apply(cfg, d, x, prec):
    """``x (B, data_dim)`` -> logits ``(B,)``."""
    h = F.leaky_relu(_linear(x, d["l1"], prec), 0.2)
    h = F.leaky_relu(_linear(h, d["l2"], prec), 0.2)
    return _linear(h, d["l3"], prec)[:, 0]


def g_apply(cfg, g, z, prec):
    """``z (B, z_dim)`` -> samples ``(B, data_dim)`` in [-1, 1]."""
    h = torch.relu(_linear(z, g["l1"], prec))
    h = torch.relu(_linear(h, g["l2"], prec))
    return torch.tanh(_linear(h, g["l3"], prec))


def _macs(widths):
    return [a * b for a, b in widths]


def round_flops(cfg, members: int, batch: int) -> dict:
    """Multiply-add FLOPs (2 a product) of one round, every product that
    autograd computes: each member's D step on ``2 batch`` rows (forward,
    weight gradients, input gradients of all layers but the first), the
    fake batch's G forward, and G's step (G forward, D forward and input
    gradients, G's weight gradients and input gradients of all layers but
    the first)."""
    d_w, g_w = _widths(cfg)
    d, g = _macs(d_w), _macs(g_w)
    d_step = 2 * batch * 2 * (2 * sum(d) + sum(d[1:]))
    g_fake = 2 * batch * sum(g)
    g_step = 2 * batch * (2 * sum(g) + sum(g[1:]) + 2 * sum(d))
    return {"total": members * d_step + g_fake + g_step}
