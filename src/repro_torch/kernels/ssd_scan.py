"""Wrapper for the Hopper Mamba-2 SSD chunked-scan kernel
(``csrc/ssd_scan.cu``), the port of the reference's
``kernels/ssd_scan.py::ssd_scan_pallas``.

``ssd_scan(x, dt, A, Bm, Cm, chunk=)`` takes x ``(B, S, H, P)``, dt
``(B, S, H)``, A ``(H,)`` and Bm/Cm ``(B, S, G, N)`` on a CUDA device and
returns y ``(B, S, H, P)`` in x's type; ``launches`` counts its calls.  The
plain version is ``kernels/ref.py::ssd_scan_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)

launches = 0


def _lib():
    lib = build.load("ssd_scan")
    fn, smem = lib.ssd_scan_fwd, lib.ssd_scan_smem_bytes
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        smem.argtypes = [ctypes.c_int] * 3
        smem.restype = ctypes.c_int
    return fn, smem


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *,
             chunk: int = 256) -> torch.Tensor:
    """Chunked SSD scan; ``S % chunk == 0`` as the reference asserts (only
    the model's ``ssd_chunked`` pads).  dt and A are taken in f32."""
    global launches
    for t in (x, dt, A, Bm, Cm):
        if t.device.type != "cuda":
            raise ValueError(f"ssd_scan launches a CUDA kernel; got a "
                             f"{t.device} tensor")
    if x.ndim != 4 or dt.ndim != 3 or A.ndim != 1 or Bm.ndim != 4 \
            or Bm.shape != Cm.shape:
        raise ValueError(f"ssd_scan wants x (B,S,H,P), dt (B,S,H), A (H,), "
                         f"Bm/Cm (B,S,G,N); got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if tuple(dt.shape) != (Bsz, S, H) or tuple(A.shape) != (H,) \
            or tuple(Bm.shape[:2]) != (Bsz, S) or H % G:
        raise ValueError(f"ssd_scan: shapes do not agree: x {tuple(x.shape)}"
                         f", dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
                         f"Bm {tuple(Bm.shape)} (H % G must be 0)")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"ssd_scan wants f32 or bf16 x, Bm, Cm of one type; "
                         f"got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if P not in _HEAD_DIMS or N % 4:
        raise ValueError(f"ssd_scan supports P in {_HEAD_DIMS} and N a "
                         f"multiple of 4; got P={P}, N={N}")
    if S % chunk:
        raise ValueError(f"ssd_scan: S={S} must be a multiple of "
                         f"chunk={chunk}")
    fn, smem = _lib()
    if smem(P, N, chunk) < 0:
        raise ValueError(f"ssd_scan: P={P}, N={N}, chunk={chunk} need more "
                         f"than the 227 KB of shared memory a block may use")
    x, Bm, Cm = x.contiguous(), Bm.contiguous(), Cm.contiguous()
    dt = dt.to(torch.float32).contiguous()
    A = A.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), y.data_ptr(), _DTYPES[x.dtype], Bsz, S, H, P,
                G, N, chunk, stream)
    build.check(rc, "ssd_scan")
    launches += 1
    return y
