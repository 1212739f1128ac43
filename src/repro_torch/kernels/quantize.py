"""Wrappers for the Hopper int8 row codec (``csrc/quantize.cu``), the port
of the reference's ``kernels/quantize.py::quantize_rows_pallas`` and
``dequantize_rows_pallas``.

``quantize_rows(x, stochastic=, seed=)`` maps ``(R, N)`` f32 CUDA rows to
``(q int8 (R, N), scale f32 (R,))`` in one launch of one 8-CTA thread-block
cluster per row (``row_cluster::kCluster`` in ``csrc/row_cluster.cuh``);
``dequantize_rows(q, scale)`` maps back.  Each keeps a launch count.  The
plain versions are ``kernels/ref.py::quantize_rows_ref`` /
``dequantize_rows_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_THREADS = 256      # per block of dequantize

launches = {"quantize_rows": 0, "dequantize_rows": 0}

# each wrapper's plain version in kernels/ref.py (lint rule RPR006)
PLAIN_VERSIONS = {"quantize_rows": "quantize_rows_ref",
                  "dequantize_rows": "dequantize_rows_ref"}


def bind(lib: ctypes.CDLL):
    """``lib``'s ``(quantize_rows, dequantize_rows)`` (a build of
    ``csrc/quantize.cu``) with their C signatures set."""
    q, dq = lib.quantize_rows, lib.dequantize_rows
    if q.argtypes is None:
        q.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_uint, ctypes.c_void_p]
        q.restype = ctypes.c_int
        dq.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        dq.restype = ctypes.c_int
    return q, dq


def blocks_per_row(x: torch.Tensor) -> int:
    """About four 256-thread blocks per SM over the whole (R, N) grid, and
    no block without work."""
    rows, n = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    per_row = -(-4 * sms // rows)
    return max(1, min(per_row, -(-n // _THREADS)))


def _check_rows(t: torch.Tensor, dtype, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} launches a CUDA kernel; got a {t.device} "
                         f"tensor")
    if t.dtype != dtype or t.ndim != 2 or not t.is_contiguous() \
            or t.shape[0] < 1 or t.shape[1] < 1:
        raise ValueError(f"{what} wants contiguous non-empty (R, N) {dtype}, "
                         f"got {tuple(t.shape)} {t.dtype} "
                         f"contiguous={t.is_contiguous()}")


def _seed_args(seed, device: torch.device) -> tuple[int | None, int]:
    """(device pointer or None, by-value uint32) for the kernel's seed: an
    int goes by value; a one-element int32/uint32 tensor on ``device`` is
    read by the kernel, so a captured CUDA graph sees what it holds at each
    replay."""
    if isinstance(seed, torch.Tensor):
        if seed.device != device or seed.numel() != 1 or \
                seed.dtype not in (torch.int32, torch.uint32):
            raise ValueError(f"a tensor seed must be one int32/uint32 element"
                             f" on {device}, got {tuple(seed.shape)} "
                             f"{seed.dtype} on {seed.device}")
        return seed.data_ptr(), 0
    return None, int(seed) & 0xFFFFFFFF


def quantize_rows(x: torch.Tensor, *, stochastic: bool = False, seed=None):
    """Per-row absmax int8: ``scale = max|x[r]| * f32(1/127)`` (the
    reference's codec under jit), ``q = clip(round(x * (1 / scale)))``;
    stochastic rounding is keyed by
    ``seed`` (required iff ``stochastic``): an int32 value, or a
    one-element int32/uint32 tensor on ``x``'s device that the kernel
    reads."""
    _check_rows(x, torch.float32, "quantize_rows")
    rows, n = x.shape
    if rows > 65535:
        raise ValueError(f"quantize_rows takes at most 65535 rows, got {rows}")
    if stochastic and seed is None:
        raise ValueError("stochastic rounding needs a seed")
    seed_ptr, seed_u32 = _seed_args(seed, x.device) if stochastic \
        else (None, 0)
    fn, _ = bind(build.load("quantize"))
    q = torch.empty((rows, n), dtype=torch.int8, device=x.device)
    scale = torch.empty((rows,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(), rows, n,
                int(bool(stochastic)), seed_ptr, seed_u32, stream)
    build.check(rc, "quantize_rows")
    launches["quantize_rows"] += 1
    return q, scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``q * scale[r]`` -> (R, N) f32."""
    _check_rows(q, torch.int8, "dequantize_rows")
    if scale.device != q.device or scale.dtype != torch.float32 \
            or tuple(scale.shape) != (q.shape[0],) \
            or not scale.is_contiguous():
        raise ValueError(f"dequantize_rows wants a contiguous ({q.shape[0]},) "
                         f"float32 scale on {q.device}, got "
                         f"{tuple(scale.shape)} {scale.dtype} {scale.device}")
    _, fn = bind(build.load("quantize"))
    rows, n = q.shape
    out = torch.empty((rows, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, n,
                blocks_per_row(q), stream)
    build.check(rc, "dequantize_rows")
    launches["dequantize_rows"] += 1
    return out
