"""The paper's MLP generator / discriminator pair (port of the reference's
``core/gan.py:29-83,168-197``; the DCGAN pair comes in a later slice).

    D: in -> Linear -> LeakyReLU(0.2) -> Linear -> LeakyReLU(0.2) -> Linear
    G: z  -> Linear -> ReLU -> Linear -> ReLU -> Linear -> tanh

Weights keep the reference's layout: ``{"l1": {"w": (in, out), "b":
(out,)}, ...}``.  ``d_apply`` / ``g_apply`` also take stacked parameters
with leading user dims: ``w (U, in, out)`` against ``x (U, B, in)`` (or a
shared ``(B, in)`` batch) runs all U networks as one batched matmul —
the port's form of the reference's ``vmap`` over users.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.common import P, build


@dataclasses.dataclass(frozen=True)
class MLPGanConfig:
    data_dim: int = 784          # 28*28
    z_dim: int = 64
    g_hidden: int = 256
    d_hidden: int = 256
    name: str = "mlp_gan"


def mlp_d_decls(cfg: MLPGanConfig):
    h = cfg.d_hidden
    return {
        "l1": {"w": P((cfg.data_dim, h), (None, "ffn")),
               "b": P((h,), ("ffn",), "zeros")},
        "l2": {"w": P((h, h), ("ffn", None)), "b": P((h,), (None,), "zeros")},
        "l3": {"w": P((h, 1), (None, None)), "b": P((1,), (None,), "zeros")},
    }


def mlp_g_decls(cfg: MLPGanConfig):
    h = cfg.g_hidden
    return {
        "l1": {"w": P((cfg.z_dim, h), (None, "ffn")),
               "b": P((h,), ("ffn",), "zeros")},
        "l2": {"w": P((h, h), ("ffn", None)), "b": P((h,), (None,), "zeros")},
        "l3": {"w": P((h, cfg.data_dim), (None, None)),
               "b": P((cfg.data_dim,), (None,), "zeros")},
    }


def _linear(x, layer):
    b = layer["b"]
    if b.ndim > 1:                      # stacked: (U, out) -> (U, 1, out)
        b = b.unsqueeze(-2)
    return torch.matmul(x, layer["w"]) + b


def mlp_d_apply(params, x):
    """x: (..., B, data_dim) -> logits (..., B)."""
    h = F.leaky_relu(_linear(x, params["l1"]), 0.2)
    h = F.leaky_relu(_linear(h, params["l2"]), 0.2)
    return _linear(h, params["l3"])[..., 0]


def mlp_g_apply(params, z):
    """z: (B, z_dim) -> samples (B, data_dim) in [-1, 1]."""
    h = torch.relu(_linear(z, params["l1"]))
    h = torch.relu(_linear(h, params["l2"]))
    return torch.tanh(_linear(h, params["l3"]))


@dataclasses.dataclass(frozen=True)
class GanPair:
    """Callable bundle: init + apply for one (G, D) family."""

    cfg: object
    g_decls: object
    d_decls: object
    g_apply: object
    d_apply: object
    z_dim: int

    def init(self, generator: torch.Generator, device=None,
             dtype=torch.float32):
        """(g, d) parameter dicts; G's leaves are drawn before D's."""
        g = build(self.g_decls, generator, dtype, device)
        d = build(self.d_decls, generator, dtype, device)
        return g, d

    def sample_z(self, generator: torch.Generator, n: int, device=None):
        """Standard-normal latents, drawn on the host generator and moved
        to ``device`` (the same draws on every device)."""
        z = torch.randn((n, self.z_dim), generator=generator,
                        dtype=torch.float32)
        return z.to(device)


def make_mlp_pair(cfg: MLPGanConfig | None = None) -> GanPair:
    cfg = cfg or MLPGanConfig()
    return GanPair(cfg, mlp_g_decls(cfg), mlp_d_decls(cfg),
                   mlp_g_apply, mlp_d_apply, cfg.z_dim)
