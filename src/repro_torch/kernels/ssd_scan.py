"""Wrapper for the Hopper Mamba-2 SSD chunked-scan kernels, the port of the
reference's ``kernels/ssd_scan.py::ssd_scan_pallas``.

``ssd_scan(x, dt, A, Bm, Cm, chunk=)`` takes x ``(B, S, H, P)``, dt
``(B, S, H)``, A ``(H,)`` and Bm/Cm ``(B, S, G, N)`` on a CUDA device and
returns y ``(B, S, H, P)`` in x's type.  The route depends on the type
alone:

* bf16 -> ``csrc/ssd_scan_wgmma.cu`` (tensor cores: the chunked dual form
  chunk-parallel on wgmma fed by TMA, three launches behind one call;
  ``chunk`` a multiple of 64 up to 256, P in {32, 64, 128}, N a multiple
  of 16 up to 256, 16-byte aligned bases);
* f32 -> ``csrc/ssd_scan.cu`` (CUDA cores, one CTA per (b, h)).

If the build fails or a launch is refused the wrapper raises; a bf16
tensor never reaches the f32 kernel.  ``launches`` counts the calls of both
routes, ``route_launches`` each route.  The plain version is
``kernels/ref.py::ssd_scan_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# dtype -> (route name, kernel source, C entry point)
ROUTES = {torch.bfloat16: ("wgmma", "ssd_scan_wgmma", "ssd_scan_wgmma_fwd"),
          torch.float32: ("f32", "ssd_scan", "ssd_scan_fwd")}
_F32_HEAD_DIMS = (16, 32, 64, 128)
_WGMMA_HEAD_DIMS = (32, 64, 128)
_WGMMA_ROWS = 128                 # rows of a chunk-scan CTA (phase 3)
# the bf16 route's launches as the C entry point's mask: chunk states,
# state passing, chunk scan
PHASES = {"chunk_state": 1, "state_passing": 2, "chunk_scan": 4}
ALL_PHASES = 7

launches = 0
route_launches = {name: 0 for name, _, _ in ROUTES.values()}


def route(dtype: torch.dtype) -> tuple[str, str]:
    """(route name, kernel source) that a CUDA tensor of ``dtype`` takes."""
    if dtype not in ROUTES:
        raise ValueError(f"ssd_scan wants f32 or bf16 x, Bm, Cm of one type;"
                         f" got {dtype}")
    name, source, _ = ROUTES[dtype]
    return name, source


def _lib(dtype: torch.dtype):
    _, source, entry = ROUTES[dtype]
    lib = build.load(source)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        if dtype == torch.float32:
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
                ctypes.c_void_p]
            lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int] * 3
            lib.ssd_scan_smem_bytes.restype = ctypes.c_int
        else:
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
                ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, fn


def check_wgmma_shape(S: int, P: int, N: int, chunk: int) -> None:
    """Raise ValueError unless the bf16 route takes these sizes."""
    if chunk % 64 or not 64 <= chunk <= 256:
        raise ValueError(f"ssd_scan (bf16, wgmma): chunk must be a multiple "
                         f"of 64 up to 256, got {chunk}")
    if P not in _WGMMA_HEAD_DIMS:
        raise ValueError(f"ssd_scan (bf16, wgmma) supports P in "
                         f"{_WGMMA_HEAD_DIMS}, got P={P}")
    if N % 16 or not 16 <= N <= 256:
        raise ValueError(f"ssd_scan (bf16, wgmma): N must be a multiple of "
                         f"16 up to 256, got N={N}")
    if S % chunk:
        raise ValueError(f"ssd_scan: S={S} must be a multiple of "
                         f"chunk={chunk}")


def wgmma_ctas(B: int, S: int, H: int, P: int, N: int,
               chunk: int) -> dict[str, int]:
    """CTAs of the bf16 route's three launches."""
    nc = S // chunk
    return {"chunk_state": B * H * nc,
            "state_passing": B * H * -(-(N * P // 4) // 256),
            "chunk_scan": B * H * nc * -(-chunk // _WGMMA_ROWS)}


def _check(x, dt, A, Bm, Cm, chunk):
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
    if Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"ssd_scan wants f32 or bf16 x, Bm, Cm of one type; "
                         f"got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    name, _ = route(x.dtype)
    if name == "wgmma":
        check_wgmma_shape(S, P, N, chunk)
    else:
        if P not in _F32_HEAD_DIMS or N % 4:
            raise ValueError(f"ssd_scan (f32) supports P in {_F32_HEAD_DIMS}"
                             f" and N a multiple of 4; got P={P}, N={N}")
        if S % chunk:
            raise ValueError(f"ssd_scan: S={S} must be a multiple of "
                             f"chunk={chunk}")
    return name


def _run(name, x, dt, A, Bm, Cm, chunk):
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    lib, fn = _lib(x.dtype)
    if name == "f32" and lib.ssd_scan_smem_bytes(P, N, chunk) < 0:
        raise ValueError(f"ssd_scan: P={P}, N={N}, chunk={chunk} need more "
                         f"than the 227 KB of shared memory a block may use")
    x, Bm, Cm = x.contiguous(), Bm.contiguous(), Cm.contiguous()
    dt = dt.to(torch.float32).contiguous()
    A = A.to(torch.float32).contiguous()
    if name == "wgmma" and any(t.data_ptr() % 16 for t in (x, Bm, Cm)):
        raise ValueError("ssd_scan: TMA reads bf16 x, Bm, Cm from 16-byte "
                         "aligned bases only")
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if name == "f32":
            rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                    Cm.data_ptr(), y.data_ptr(), Bsz, S, H, P, G, N, chunk,
                    stream)
        else:
            states, decay, before = wgmma_scratch(Bsz, S, H, P, N, chunk,
                                                  x.device)
            rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                    Cm.data_ptr(), y.data_ptr(), states.data_ptr(),
                    decay.data_ptr(), before.data_ptr(), Bsz, S, H, P, G, N,
                    chunk, ALL_PHASES, stream)
    build.check(rc, f"ssd_scan ({name})")
    return y


def wgmma_scratch(Bsz, S, H, P, N, chunk, device):
    """The bf16 route's scratch: f32 chunk states (B*H, nc, N, P), f32 chunk
    decays (B*H, nc) and bf16 states before each chunk (B*H, nc, N, P)."""
    nc = S // chunk
    return (torch.empty((Bsz * H, nc, N, P), dtype=torch.float32,
                        device=device),
            torch.empty((Bsz * H, nc), dtype=torch.float32, device=device),
            torch.empty((Bsz * H, nc, N, P), dtype=torch.bfloat16,
                        device=device))


def wgmma_entry():
    """The bf16 route's C entry point (built on first use), for callers that
    time its launches apart (``repro_torch.profile_ssd``)."""
    return _lib(torch.bfloat16)[1]


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *,
             chunk: int = 256) -> torch.Tensor:
    """Chunked SSD scan; ``S % chunk == 0`` as the reference asserts (only
    the model's ``ssd_chunked`` pads).  dt and A are taken in f32."""
    global launches
    name = _check(x, dt, A, Bm, Cm, chunk)
    y = _run(name, x, dt, A, Bm, Cm, chunk)
    launches += 1
    route_launches[name] += 1
    return y
