"""Public kernel entry points (port of the reference's ``kernels/ops.py``).

A tensor on the CPU goes to the plain PyTorch version in ``ref.py``; a
tensor on a CUDA device goes to the Hopper kernel, which builds on first
use and raises if it cannot build or launch.  There is no fallback from a
CUDA tensor to the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import quantize as _quantize
from repro_torch.kernels import ref
from repro_torch.kernels import topk_select as _topk


def _route(t: torch.Tensor) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def topk_mask(rows: torch.Tensor, frac: float) -> torch.Tensor:
    """Row-batched exact global top-k magnitude mask: ``(C, N)`` -> bool
    ``(C, N)`` (an ``(N,)`` vector is one row)."""
    if rows.ndim == 1:
        return topk_mask(rows[None], frac)[0]
    if _route(rows):
        return _topk.topk_mask_rows(rows.contiguous(), frac)
    return ref.topk_mask_global_ref(rows, frac)


def quantize_rows(x: torch.Tensor, *, stochastic: bool = False, seed=None):
    """(R, N) f32 -> (q int8 (R, N), scale f32 (R,))."""
    if _route(x):
        return _quantize.quantize_rows(x.contiguous(), stochastic=stochastic,
                                       seed=seed)
    return ref.quantize_rows_ref(x, stochastic=stochastic, seed=seed)


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(q int8 (R, N), scale f32 (R,)) -> f32 (R, N)."""
    if _route(q):
        return _quantize.dequantize_rows(q.contiguous(), scale.contiguous())
    return ref.dequantize_rows_ref(q, scale)


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by wrapper (plain-version calls not
    counted)."""
    return {"topk_mask_rows": _topk.launches, **_quantize.launches}


def reset_launch_counts() -> None:
    _topk.launches = 0
    for k in _quantize.launches:
        _quantize.launches[k] = 0
