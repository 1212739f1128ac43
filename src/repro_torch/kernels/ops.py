"""Public kernel entry points (port of the reference's ``kernels/ops.py``).

A tensor on the CPU goes to the plain PyTorch version in ``ref.py``; a
tensor on a CUDA device goes to the Hopper kernel, which builds on first
use and raises if it cannot build or launch.  There is no fallback from a
CUDA tensor to the plain version.  ``plain_counts()`` counts the calls that
went to a plain version, by the keys of ``launch_counts()``: the contract
checker (``repro_torch.analysis.tracecheck``) holds a CPU round's kernel
calls to them, and a CUDA round's to zero.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import quantize as _quantize
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import topk_select as _topk


_plain = {"topk_mask_rows": 0, "topk_mask_block": 0, "quantize_rows": 0,
          "dequantize_rows": 0, "flash_attention": 0, "ssd_scan": 0}


def _route(t: torch.Tensor, key: str) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU), whose
    call is counted under ``key``."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        _plain[key] += 1
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def topk_mask(rows: torch.Tensor, frac: float,
              mode: str = "global") -> torch.Tensor:
    """Row-batched top-k magnitude mask: ``(C, N)`` -> bool ``(C, N)`` (an
    ``(N,)`` vector is one row).  ``mode="global"`` (default): each row's
    exact top-k, ties kept.  ``mode="block"``: the block-local variant,
    each ``BLOCK``-element slice of a row selects its own k."""
    if mode not in ("global", "block"):
        raise ValueError(f"unknown top-k mode {mode!r} (global or block)")
    if rows.ndim == 1:
        return topk_mask(rows[None], frac, mode)[0]
    if mode == "block":
        if _route(rows, "topk_mask_block"):
            return _topk.topk_mask_block_rows(rows.contiguous(), frac)
        return ref.topk_mask_block_ref(rows, frac)
    if _route(rows, "topk_mask_rows"):
        return _topk.topk_mask_rows(rows.contiguous(), frac)
    return ref.topk_mask_global_ref(rows, frac)


def quantize_rows(x: torch.Tensor, *, stochastic: bool = False, seed=None):
    """(R, N) f32 -> (q int8 (R, N), scale f32 (R,))."""
    if _route(x, "quantize_rows"):
        return _quantize.quantize_rows(x.contiguous(), stochastic=stochastic,
                                       seed=seed)
    return ref.quantize_rows_ref(x, stochastic=stochastic, seed=seed)


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(q int8 (R, N), scale f32 (R,)) -> f32 (R, N)."""
    if _route(q, "dequantize_rows"):
        return _quantize.dequantize_rows(q.contiguous(), scale.contiguous())
    return ref.dequantize_rows_ref(q, scale)


def flash_attention(q, k, v, *, causal=True, window=0, scale=None, bq=128,
                    bkv=128):
    """q (B,S,H,hd), k/v (B,T,K,hd) -> (B,S,H,hd) online-softmax attention;
    ``bq``/``bkv`` are the reference's tiling hints (see the wrapper)."""
    if _route(q, "flash_attention"):
        return _flash.flash_attention(q, k, v, causal=causal, window=window,
                                      scale=scale, bq=bq, bkv=bkv)
    if q.shape[1] % bq or k.shape[1] % bkv:
        raise ValueError(f"flash_attention: S={q.shape[1]} and T="
                         f"{k.shape[1]} must be multiples of bq={bq} and "
                         f"bkv={bkv}")
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk=256):
    """Mamba-2 SSD scan: x (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm (B,S,G,N)
    -> y (B,S,H,P); ``S % chunk == 0``."""
    if _route(x, "ssd_scan"):
        return _ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    if x.shape[1] % chunk:
        raise ValueError(f"ssd_scan: S={x.shape[1]} must be a multiple of "
                         f"chunk={chunk}")
    return ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk)


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by wrapper (plain-version calls not
    counted)."""
    return {"topk_mask_rows": _topk.launches,
            "topk_mask_block": _topk.block_launches, **_quantize.launches,
            "flash_attention": _flash.launches, "ssd_scan": _ssd.launches}


def plain_counts() -> dict[str, int]:
    """Calls that went to a plain version (a CPU tensor) so far, by the
    keys of ``launch_counts()``."""
    return dict(_plain)


def flash_route_counts() -> dict[str, int]:
    """Flash-attention launches by route (``wgmma`` for bf16, ``f32``); they
    sum to ``launch_counts()["flash_attention"]``."""
    return dict(_flash.route_launches)


def ssd_route_counts() -> dict[str, int]:
    """SSD-scan launches by route (``wgmma`` for bf16, ``f32``); they sum to
    ``launch_counts()["ssd_scan"]``."""
    return dict(_ssd.route_launches)


def add_launch_counts(delta: dict[str, int]) -> None:
    """Add ``delta`` (keys of ``launch_counts()``; negative to take counts
    back out) to the counts.  A CUDA graph's kernels bump their wrappers'
    counts once, at capture: the graph engines take those out and add the
    launches a graph holds at each replay (``core/engine.py``).  No graph
    holds flash attention or the SSD scan, whose route splits it would
    leave behind."""
    for key, n in delta.items():
        if not n:
            continue
        if key == "topk_mask_rows":
            _topk.launches += n
        elif key == "topk_mask_block":
            _topk.block_launches += n
        elif key in _quantize.launches:
            _quantize.launches[key] += n
        else:
            raise ValueError(f"no graph adds launches of {key!r}")


def reset_launch_counts() -> None:
    _topk.launches = 0
    _topk.block_launches = 0
    for mod in (_flash, _ssd):
        mod.launches = 0
        for k in mod.route_launches:
            mod.route_launches[k] = 0
    for k in _quantize.launches:
        _quantize.launches[k] = 0
    for k in _plain:
        _plain[k] = 0
