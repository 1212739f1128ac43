"""Wrapper for the Hopper flash-attention kernel (``csrc/flash_attention.cu``),
the port of the reference's ``kernels/flash_attention.py::
flash_attention_pallas``.

``flash_attention(q, k, v, causal=, window=, scale=, bq=, bkv=)`` takes
q ``(B, S, H, hd)`` and k/v ``(B, T, K, hd)`` on a CUDA device (f32 or
bf16, one type, hd in {32, 64, 128}, H % K == 0) and returns
``(B, S, H, hd)`` in q's type; ``launches`` counts its calls.  The plain
version is ``kernels/ref.py::flash_attention_ref``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)

launches = 0


def _lib():
    fn = build.load("flash_attention").flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, scale=None,
                    bq: int = 128, bkv: int = 128) -> torch.Tensor:
    """Online-softmax attention, causal / sliding window / none, GQA by
    ``h // (H // K)``.  ``bq``/``bkv`` are the TPU kernel's tiling hints:
    they are checked as the reference checks them (``S % bq == 0``,
    ``T % bkv == 0``) and do not reach the CUDA kernel, whose 64 x 64 tile
    is its own."""
    global launches
    for t in (q, k, v):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention launches a CUDA kernel; got a "
                             f"{t.device} tensor")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention wants q (B,S,H,hd) and k, v "
                         f"(B,T,K,hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % K:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)} (H % K must be 0)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention wants f32 or bf16 q, k, v of one "
                         f"type; got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"flash_attention supports hd in {_HEAD_DIMS}, "
                         f"got {hd}")
    if S % bq or T % bkv:
        raise ValueError(f"flash_attention: S={S} and T={T} must be "
                         f"multiples of bq={bq} and bkv={bkv}")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _DTYPES[q.dtype], B, S, T, H, K, hd, float(scale),
                int(bool(causal)), int(window), stream)
    build.check(rc, "flash_attention")
    launches += 1
    return out
