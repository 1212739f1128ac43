"""Typed parameter declarations and ``build`` (port of the parts of the
reference's ``models/common.py`` that the GAN pairs use).

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
