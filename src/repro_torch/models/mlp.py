"""Gated-MLP (SwiGLU / GeGLU) feed-forward blocks (port of the reference's
``models/mlp.py``)."""

from __future__ import annotations

from repro_torch.models.common import P, activation


def mlp_decls(cfg, d_ff: int | None = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w_gate": P((d, f), ("embed", "ffn")),
        "w_up": P((d, f), ("embed", "ffn")),
        "w_down": P((f, d), ("ffn", "embed")),
    }


def mlp_forward(params, x, cfg):
    act = activation(cfg.act)
    g = act(x @ params["w_gate"])
    u = x @ params["w_up"]
    return (g * u) @ params["w_down"]
