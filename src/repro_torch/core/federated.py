"""Selective parameter sharing on flat delta rows (port of the reference's
``core/federated.py``: ``FlatLayout``, the selection masks, the transport
codecs, the server combiners and the upload pricing table).

Users compute local weight deltas; only a selected subset crosses the user
boundary (``topk`` — the largest-|delta| fraction, ``threshold``,
``random``).  The server folds the uploads with the paper's elementwise
argmax-|.| rule or a mean.  Every function here works on stacked
``(C, N)`` rows, one row per user: the reference's per-row Python list of
top-k calls becomes one row-batched kernel launch.

``CohortStore``, the participation schedulers and the host backend come
with the cohort slice (ROADMAP queue A items 4 and 6).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

import torch

from repro_torch.core.spec import register_combiner
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models.common import tree_leaves

Selection = Literal["topk", "threshold", "random", "none"]


# ---------------------------------------------------------------------------
# Flat-buffer discriminator layout
# ---------------------------------------------------------------------------

def _paths(tree, prefix=()) -> list[tuple]:
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], prefix + (k,))]
    return [prefix]


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Static flatten/unflatten spec for one parameter tree.

    Leaf order is jax's tree order — dict keys sorted, so for the MLP D
    ``l1.b, l1.w, l2.b, l2.w, l3.b, l3.w`` — which makes flat indices
    interchangeable with the reference (the stochastic-rounding hash keys
    on the column index).  ``_stacked`` variants handle trees with a
    leading user axis and ``(U, N)`` rows."""

    paths: tuple
    shapes: tuple
    sizes: tuple
    n: int

    def flatten(self, tree) -> torch.Tensor:
        return torch.cat([leaf.reshape(-1) for leaf in tree_leaves(tree)])

    def flatten_stacked(self, tree) -> torch.Tensor:
        leaves = tree_leaves(tree)
        u = leaves[0].shape[0]
        return torch.cat([leaf.reshape(u, -1) for leaf in leaves], dim=1)

    def _build(self, parts):
        out: dict = {}
        for path, part in zip(self.paths, parts):
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = part
        return out

    def unflatten(self, flat: torch.Tensor):
        """(N,) -> tree of views into ``flat``."""
        parts = torch.split(flat, self.sizes)
        return self._build([p.view(s) for p, s in zip(parts, self.shapes)])

    def unflatten_stacked(self, flat: torch.Tensor):
        """(U, N) -> tree with a leading user axis."""
        u = flat.shape[0]
        parts = torch.split(flat, self.sizes, dim=1)
        return self._build([p.reshape((u,) + s)
                            for p, s in zip(parts, self.shapes)])


def make_flat_layout(example_tree) -> FlatLayout:
    """Build the static layout from a tree of tensors (shapes only)."""
    leaves = tree_leaves(example_tree)
    shapes = tuple(tuple(leaf.shape) for leaf in leaves)
    sizes = tuple(math.prod(s) for s in shapes)
    return FlatLayout(tuple(_paths(example_tree)), shapes, sizes, sum(sizes))


# ---------------------------------------------------------------------------
# Selection masks (row-batched)
# ---------------------------------------------------------------------------

def threshold_mask(rows: torch.Tensor, tau: float) -> torch.Tensor:
    return torch.abs(rows) > tau


def random_mask(rows: torch.Tensor, frac: float,
                generator: torch.Generator) -> torch.Tensor:
    """Uniform draws from the host ``generator``, moved to the rows'
    device (jax's per-user keys cannot be reproduced)."""
    u = torch.rand(rows.shape, generator=generator, dtype=torch.float32)
    return u.to(rows.device) < frac


def select_delta_flat(rows: torch.Tensor, policy: Selection, *, frac=0.1,
                      tau=0.0, generator=None, use_kernel: bool = False):
    """Apply a selection policy to stacked ``(C, N)`` delta rows.

    Returns ``(masked (C, N), kept_fraction (C,))``.  ``use_kernel``
    routes top-k through ``kernels.ops.topk_mask`` — the Hopper kernel on
    a CUDA tensor, its plain version on a CPU tensor — one launch for all
    C rows; without it, top-k is the ``torch.topk`` version on any
    device (the reference's non-kernel ``topk_mask``)."""
    if policy == "none":
        return rows, torch.ones(rows.shape[0], device=rows.device)
    if policy == "topk":
        mask = (kops.topk_mask(rows, frac) if use_kernel
                else kref.topk_mask_global_ref(rows, frac))
    elif policy == "threshold":
        mask = threshold_mask(rows, tau)
    elif policy == "random":
        assert generator is not None
        mask = random_mask(rows, frac, generator)
    else:
        raise ValueError(policy)
    kept = mask.to(torch.float32).mean(dim=1)
    return rows * mask, kept


# ---------------------------------------------------------------------------
# Transport codecs
# ---------------------------------------------------------------------------

def codec_transport(rows: torch.Tensor, codec: str, *,
                    stochastic: bool = False, seed=None,
                    use_kernel: bool = False) -> torch.Tensor:
    """Stacked (R, N) rows -> what the receiver reconstructs after the
    lossy wire round-trip: identity for ``none``, a double cast for
    ``bf16``, per-row absmax int8 for the int8 codecs — through
    ``kernels.ops`` when ``use_kernel`` (the flag that also routes
    top-k), else the plain version.  ``seed`` (int) drives stochastic
    rounding."""
    if codec == "none":
        return rows
    if codec == "bf16":
        return rows.to(torch.bfloat16).to(torch.float32)
    if codec in ("int8", "topk_int8"):
        if use_kernel:
            q, scale = kops.quantize_rows(rows, stochastic=stochastic,
                                          seed=seed)
            return kops.dequantize_rows(q, scale)
        q, scale = kref.quantize_rows_ref(rows, stochastic=stochastic,
                                          seed=seed)
        return kref.dequantize_rows_ref(q, scale)
    raise ValueError(f"unknown codec {codec!r}")


# ---------------------------------------------------------------------------
# Server combination rules, on stacked (C, ...) rows
# ---------------------------------------------------------------------------

def combine_max_abs(rows: torch.Tensor) -> torch.Tensor:
    """Paper's rule: per coordinate, the single user's delta with the
    largest magnitude (first user on ties, like ``jnp.argmax``)."""
    idx = torch.argmax(torch.abs(rows), dim=0, keepdim=True)
    return torch.take_along_dim(rows, idx, dim=0)[0]


def combine_mean(rows: torch.Tensor) -> torch.Tensor:
    """FedAvg baseline: mean over users."""
    return torch.mean(rows, dim=0)


def combine_masked_mean(rows: torch.Tensor) -> torch.Tensor:
    """Mean over the users that uploaded each coordinate."""
    nz = (rows != 0).to(rows.dtype)
    cnt = torch.clamp(torch.sum(nz, dim=0), min=1)
    return torch.sum(rows, dim=0) / cnt


def _age_weights(ages: torch.Tensor, decay: float, ndim: int):
    """(C,) ages -> ``decay**age`` weights broadcastable over (C, ...)."""
    w = torch.pow(torch.full(ages.shape, decay, dtype=torch.float32,
                             device=ages.device), ages.to(torch.float32))
    return w.reshape(w.shape + (1,) * (ndim - 1))


def combine_staleness_mean(rows, ages=None, decay: float = 0.5):
    """Staleness-weighted mean, weights relative to the youngest member;
    ``ages=None`` is ``combine_mean``."""
    if ages is None:
        return torch.mean(rows, dim=0)
    ages = ages - torch.min(ages)
    w = _age_weights(ages, decay, rows.ndim)
    return torch.sum(w * rows, dim=0) / torch.sum(w, dim=0)


def combine_staleness_max_abs(rows, ages=None, decay: float = 0.5):
    """Argmax-|.| fold with deltas scaled by ``decay**age`` first."""
    scaled = rows if ages is None else _age_weights(ages, decay,
                                                    rows.ndim) * rows
    idx = torch.argmax(torch.abs(scaled), dim=0, keepdim=True)
    return torch.take_along_dim(scaled, idx, dim=0)[0]


combine_staleness_mean.needs_ages = True
combine_staleness_max_abs.needs_ages = True

register_combiner("max_abs", combine_max_abs)
register_combiner("mean", combine_mean)
register_combiner("masked_mean", combine_masked_mean)
register_combiner("staleness_mean", combine_staleness_mean)
register_combiner("staleness_max_abs", combine_staleness_max_abs)


# ---------------------------------------------------------------------------
# Communication accounting
# ---------------------------------------------------------------------------

# bytes per transported value on the wire, by codec
_CODEC_VALUE_BYTES = {"none": 4, "bf16": 2, "int8": 1, "topk_int8": 1}


def upload_bytes_flat(n: int, policy: Selection | str, frac: float = 0.1, *,
                      kept_frac: float | None = None,
                      codec: str = "none") -> int:
    """Per-user upload bytes from the flat buffer size: dense ``none``
    ships one value per entry; sparse policies ship (4 B index, value)
    pairs per kept entry (``threshold`` needs the measured
    ``kept_frac``); ``shared_random`` ships values only; int8 codecs add
    one 4 B f32 scale per row."""
    vb = _CODEC_VALUE_BYTES[codec]
    sb = 4 if codec in ("int8", "topk_int8") else 0   # per-row f32 scale
    if policy == "none":
        return n * vb + sb
    if policy == "threshold":
        assert kept_frac is not None, \
            "threshold accounting needs the measured kept_frac"
        kept = int(round(n * float(kept_frac)))
    elif policy == "shared_random":
        return max(int(n * frac), 1) * vb + sb
    else:
        kept = int(n * frac)
    return kept * (4 + vb) + sb
