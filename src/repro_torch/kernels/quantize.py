"""Wrappers for the Hopper int8 row codec (``csrc/quantize.cu``), the port
of the reference's ``kernels/quantize.py::quantize_rows_pallas`` and
``dequantize_rows_pallas``.

``quantize_rows(x, stochastic=, seed=)`` maps ``(R, N)`` f32 CUDA rows to
``(q int8 (R, N), scale f32 (R,))``; ``dequantize_rows(q, scale)`` maps
back.  Each keeps a launch count.  The plain versions are
``kernels/ref.py::quantize_rows_ref`` / ``dequantize_rows_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.topk_select import blocks_per_row

launches = {"quantize_rows": 0, "dequantize_rows": 0}


def _fns():
    lib = build.load("quantize")
    q, dq = lib.quantize_rows, lib.dequantize_rows
    if q.argtypes is None:
        q.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint,
            ctypes.c_int, ctypes.c_void_p]
        q.restype = ctypes.c_int
        dq.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        dq.restype = ctypes.c_int
    return q, dq


def _check_rows(t: torch.Tensor, dtype, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} launches a CUDA kernel; got a {t.device} "
                         f"tensor")
    if t.dtype != dtype or t.ndim != 2 or not t.is_contiguous() \
            or t.shape[0] < 1 or t.shape[1] < 1:
        raise ValueError(f"{what} wants contiguous non-empty (R, N) {dtype}, "
                         f"got {tuple(t.shape)} {t.dtype} "
                         f"contiguous={t.is_contiguous()}")


def quantize_rows(x: torch.Tensor, *, stochastic: bool = False, seed=None):
    """Per-row absmax int8: ``scale = max|x[r]| / 127``,
    ``q = clip(round(x / scale))``; stochastic rounding is keyed by the
    int32 ``seed`` (required iff ``stochastic``)."""
    _check_rows(x, torch.float32, "quantize_rows")
    if stochastic and seed is None:
        raise ValueError("stochastic rounding needs a seed")
    seed_u32 = (int(seed) & 0xFFFFFFFF) if stochastic else 0
    fn, _ = _fns()
    rows, n = x.shape
    q = torch.empty((rows, n), dtype=torch.int8, device=x.device)
    scale = torch.empty((rows,), dtype=torch.float32, device=x.device)
    absmax = torch.zeros((rows,), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                absmax.data_ptr(), rows, n, int(bool(stochastic)), seed_u32,
                blocks_per_row(x), stream)
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
    _, fn = _fns()
    rows, n = q.shape
    out = torch.empty((rows, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, n,
                blocks_per_row(q), stream)
    build.check(rc, "dequantize_rows")
    launches["dequantize_rows"] += 1
    return out
