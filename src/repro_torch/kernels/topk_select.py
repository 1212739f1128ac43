"""Wrappers for the Hopper top-k mask kernels: ``csrc/topk_select.cu``, the
port of the reference's ``kernels/topk_select.py::topk_mask_pallas_global``,
and ``csrc/topk_block.cu``, the port of its ``topk_mask_pallas``.

``topk_mask_rows(x, frac)`` takes ``(C, N)`` rows on a CUDA device and
returns the ``(C, N)`` bool mask of every row's exact global top-k by
magnitude (ties kept) in one launch of one 8-CTA thread-block cluster per
row (``row_cluster::kCluster`` in ``csrc/row_cluster.cuh``); ``launches``
counts its calls.  ``topk_mask_block_rows(x, frac)`` is the block-local
variant in one launch; ``block_launches`` counts its calls.  Both take f32
rows, and bf16 or f16 rows cast to f32 first as the reference casts them.
The plain versions are ``kernels/ref.py::topk_mask_global_ref`` and
``topk_mask_block_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import BLOCK, topk_k

launches = 0
block_launches = 0

# each wrapper's plain version in kernels/ref.py (lint rule RPR006)
PLAIN_VERSIONS = {"topk_mask_rows": "topk_mask_global_ref",
                  "topk_mask_block_rows": "topk_mask_block_ref"}


def bind(lib: ctypes.CDLL):
    """``lib``'s ``topk_mask_rows`` (a build of ``csrc/topk_select.cu``)
    with its C signature set."""
    fn = lib.topk_mask_rows
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 2 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def bind_block(lib: ctypes.CDLL):
    """``lib``'s ``topk_mask_block_rows`` (a build of ``csrc/topk_block.cu``)
    with its C signature set."""
    fn = lib.topk_mask_block_rows
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _f32_rows(x: torch.Tensor, what: str) -> torch.Tensor:
    """``x`` as the kernels take it: contiguous (C, N) f32 on a CUDA device,
    bf16 and f16 cast to f32 (exact), anything else refused."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} launches a CUDA kernel; got a {x.device} "
                         f"tensor")
    if (x.dtype not in (torch.float32, torch.bfloat16, torch.float16)
            or x.ndim != 2 or not x.is_contiguous()):
        raise ValueError(f"{what} wants contiguous (C, N) float32, bfloat16 "
                         f"or float16, got {tuple(x.shape)} {x.dtype} "
                         f"contiguous={x.is_contiguous()}")
    return x.to(torch.float32)


def topk_mask_rows(x: torch.Tensor, frac: float) -> torch.Tensor:
    """(C, N) CUDA rows -> (C, N) bool: ``|x| >=`` the row's k-th
    largest magnitude, ``k = max(int(N * frac), 1)`` (over N keeps every
    entry, as k = N does)."""
    global launches
    x = _f32_rows(x, "topk_mask_rows")
    rows, n = x.shape
    k = min(topk_k(n, frac), n)
    if not (0 < rows <= 65535 and 0 < n):
        raise ValueError(f"bad top-k problem: rows={rows} n={n} k={k}")
    fn = bind(build.load("topk_select"))
    out = torch.empty((rows, n), dtype=torch.bool, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), out.data_ptr(), rows, n, k, stream)
    build.check(rc, "topk_mask_rows")
    launches += 1
    return out


def topk_mask_block_rows(x: torch.Tensor, frac: float) -> torch.Tensor:
    """(C, N) CUDA rows -> (C, N) bool: per ``BLOCK`` slice of each row
    (zero-padded), ``|x| >=`` the slice's 32-step bisection threshold for
    ``k = max(int(BLOCK * frac), 1)``."""
    global block_launches
    x = _f32_rows(x, "topk_mask_block_rows")
    rows, n = x.shape
    if not (0 < rows <= 65535 and 0 < n):
        raise ValueError(f"bad block top-k problem: rows={rows} n={n}")
    fn = bind_block(build.load("topk_block"))
    out = torch.empty((rows, n), dtype=torch.bool, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), out.data_ptr(), rows, n, topk_k(BLOCK, frac),
                stream)
    build.check(rc, "topk_mask_block_rows")
    block_launches += 1
    return out
