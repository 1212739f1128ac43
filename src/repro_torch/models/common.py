"""Shared building blocks (port of the reference's ``models/common.py``):
typed parameter declarations and ``build``, norms, activations, RoPE and
softcap.

Parameter trees are plain nested dicts of tensors.  ``build`` walks the
declarations in sorted-key order, the order jax flattens a dict in, so the
n-th leaf drawn here is the n-th leaf of the reference's tree.  The draws
themselves come from a CPU ``torch.Generator`` (jax's threefry stream
cannot be reproduced), so one seed gives the same weights on every device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


@dataclasses.dataclass(frozen=True)
class P:
    """A parameter declaration: shape, per-dim logical axes, initializer."""

    shape: tuple[int, ...]
    logical: tuple[str | None, ...]
    init: str = "normal"          # normal | zeros | ones | uniform_scaled | custom
    scale: float | None = None    # stddev override for "normal"
    fn: Callable | None = None    # custom init fn(generator, shape, dtype)

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)

    def materialize(self, generator: torch.Generator, dtype: torch.dtype):
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype)
        if self.init == "custom":
            return self.fn(generator, self.shape, dtype)
        fan_in = self.shape[0]
        if self.init == "uniform_scaled":
            bound = math.sqrt(3.0 / fan_in)
            u = torch.rand(self.shape, generator=generator, dtype=torch.float32)
            return (u * (2 * bound) - bound).to(dtype)
        std = self.scale
        if std is None:
            std = 1.0 / math.sqrt(max(fan_in, 1))
        z = torch.randn(self.shape, generator=generator, dtype=torch.float32)
        return (z * std).to(dtype)


def tree_leaves(tree) -> list:
    """Leaves of a nested dict in jax's flatten order (sorted keys)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """``jax.tree.map`` over nested dicts (structure taken from ``tree``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def build(decls, generator: torch.Generator, dtype=torch.float32,
          device=None):
    """Materialize a nested dict of :class:`P` declarations into tensors,
    drawing leaves in sorted-key order from ``generator`` (a CPU
    generator), then moving them to ``device``."""
    return tree_map(
        lambda d: d.materialize(generator, dtype).to(device), decls)


def not_ported(what: str):
    """Raise for a part of the reference's LM zoo the port does not have
    yet."""
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP queue A "
                              f"item 12, LM zoo and decode)")


def stack_decls(decls, n: int, axis_name: str = "layers"):
    """Lift a per-layer declaration tree to an n-layer stacked tree: prepend
    a ``layers`` dim to every leaf."""
    return tree_map(lambda d: P((n,) + d.shape, (axis_name,) + d.logical,
                                d.init, d.scale, d.fn), decls)


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float):
    """RMSNorm in f32; ``scale`` stores (scale - 1), applied as ``1 + scale``."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(torch.float32))).to(dt)


def layer_norm(x, scale, bias, eps: float):
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * scale.to(torch.float32)
            + bias.to(torch.float32)).to(dt)


def norm_decl(cfg, width: int | None = None):
    d = width or cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": P((d,), (None,), "ones"),
                "bias": P((d,), (None,), "zeros")}
    return {"scale": P((d,), (None,), "zeros")}  # rmsnorm stores (scale-1)


def apply_norm(params, x, cfg):
    if cfg.norm == "layernorm":
        return layer_norm(x, params["scale"], params["bias"], cfg.norm_eps)
    return rms_norm(x, params["scale"], cfg.norm_eps)


def _gelu_tanh(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def activation(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    """(head_dim // 2,) f32 inverse frequencies."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd) or (..., S, hd); positions: (..., S).  Rotates the
    two halves of hd (not interleaved pairs) with f32 angles."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, device=x.device)
    ang = positions[..., None].to(torch.float32) * inv   # (..., S, hd/2)
    sin, cos = torch.sin(ang), torch.cos(ang)
    if x.ndim == positions.ndim + 2:                     # head axis present
        sin, cos = sin[..., None, :], cos[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x, cap: float):
    if cap and cap > 0:
        return torch.tanh(x / cap) * cap
    return x
