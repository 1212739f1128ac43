"""Wrapper for the Hopper flash-attention kernels, the port of the
reference's ``kernels/flash_attention.py::flash_attention_pallas``.

``flash_attention(q, k, v, causal=, window=, scale=, bq=, bkv=)`` takes
q ``(B, S, H, hd)`` and k/v ``(B, T, K, hd)`` on a CUDA device (f32 or
bf16, one type, hd in {32, 64, 128, 256}, H % K == 0) and returns
``(B, S, H, hd)`` in q's type.  The route depends on the type alone:

* bf16 -> ``csrc/flash_attention_wgmma.cu`` (tensor cores: wgmma fed by
  TMA; p rounded to bf16 before the p.v product);
* f32 -> ``csrc/flash_attention_tf32.cu`` (tensor cores: mma.sync fed by
  cp.async, both products in split TF32, each operand hi + lo so that
  three TF32 products give a near-f32 product).  A base that is not
  16-byte aligned is copied first (cp.async reads 16-byte words).

If the build fails or a launch is refused the wrapper raises; a bf16
tensor never reaches the f32 kernel.  ``launches`` counts the calls of
both routes, ``route_launches`` each route.  The plain version is
``kernels/ref.py::flash_attention_ref``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

_HEAD_DIMS = (32, 64, 128, 256)
# dtype -> (route name, kernel source, C entry point)
ROUTES = {torch.bfloat16: ("wgmma", "flash_attention_wgmma",
                           "flash_attention_wgmma_fwd"),
          torch.float32: ("f32", "flash_attention_tf32",
                          "flash_attention_tf32_fwd")}

launches = 0
route_launches = {name: 0 for name, _, _ in ROUTES.values()}

# the wrapper's plain version in kernels/ref.py (lint rule RPR006)
PLAIN_VERSIONS = {"flash_attention": "flash_attention_ref"}


def route(dtype: torch.dtype) -> tuple[str, str]:
    """(route name, kernel source) that a CUDA tensor of ``dtype`` takes."""
    if dtype not in ROUTES:
        raise ValueError(f"flash_attention wants f32 or bf16 q, k, v of one "
                         f"type; got {dtype}")
    name, source, _ = ROUTES[dtype]
    return name, source


def _lib(dtype: torch.dtype):
    _, source, entry = ROUTES[dtype]
    fn = getattr(build.load(source), entry)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, scale=None,
                    bq: int = 128, bkv: int = 128) -> torch.Tensor:
    """Online-softmax attention, causal / sliding window / none, GQA by
    ``h // (H // K)``.  ``bq``/``bkv`` are the TPU kernel's tiling hints:
    they are checked as the reference checks them (``S % bq == 0``,
    ``T % bkv == 0``) and do not reach the CUDA kernels, whose tiles are
    their own (128 query rows on both routes, kv tiles of 128 or 64 keys
    at hd 256 on the bf16 route, 32, 16 or 8 on the f32 route; ragged ends
    are masked)."""
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
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention wants f32 or bf16 q, k, v of one "
                         f"type; got {q.dtype}, {k.dtype}, {v.dtype}")
    name, _ = route(q.dtype)
    if hd not in _HEAD_DIMS:
        raise ValueError(f"flash_attention supports hd in {_HEAD_DIMS}, "
                         f"got {hd}")
    if S % bq or T % bkv:
        raise ValueError(f"flash_attention: S={S} and T={T} must be "
                         f"multiples of bq={bq} and bkv={bkv}")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if name == "wgmma" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: TMA reads bf16 q, k, v from "
                         "16-byte aligned bases only")
    if name == "f32":
        q, k, v = (t.clone() if t.data_ptr() % 16 else t for t in (q, k, v))
    out = torch.empty_like(q)
    fn = _lib(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, S, T, H, K, hd, float(scale), int(bool(causal)),
                int(window), stream)
    build.check(rc, f"flash_attention ({name})")
    launches += 1
    route_launches[name] += 1
    return out
