"""Wrapper for the Hopper Mamba-2 SSD chunked-scan kernels, the port of the
reference's ``kernels/ssd_scan.py::ssd_scan_pallas``.

``ssd_scan(x, dt, A, Bm, Cm, chunk=)`` takes x ``(B, S, H, P)``, dt
``(B, S, H)``, A ``(H,)`` and Bm/Cm ``(B, S, G, N)`` on a CUDA device and
returns y ``(B, S, H, P)`` in x's type.  The route depends on the type
alone; both run the chunked dual form chunk-parallel on tensor cores,
several launches behind one call:

* bf16 -> ``csrc/ssd_scan_wgmma.cu`` (wgmma fed by TMA; chunk states,
  state passing, chunk scan; ``chunk`` a multiple of 64 up to 256, P in
  {32, 64, 128}, N a multiple of 16 up to 256, 16-byte aligned bases);
* f32 -> ``csrc/ssd_scan_tf32.cu`` (mma.sync with split-TF32 operands,
  near-f32 products; C B^T once per group, then the same three phases;
  P in {16, 32, 64, 128}, N a multiple of 4, any chunk that divides S,
  within the device's shared memory: :func:`tf32_plan` picks the chunk-scan
  CTA rows and the chunk-state key-tile rows, or raises).  A base that is
  not 16-byte aligned is copied first (cp.async reads 16-byte words).

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
          torch.float32: ("f32", "ssd_scan_tf32", "ssd_scan_tf32_fwd")}
_F32_HEAD_DIMS = (16, 32, 64, 128)
# f32 route plans, tried in order, the fastest first (PERF.md): phase-3
# rows per CTA and phase-1 key-tile rows
_TF32_SCAN_ROWS = (128, 64, 32, 16)
_TF32_STATE_KEYS = (32, 16)
_TF32_SCAN_KEYS = 16              # phase-3 key-tile rows (kScanKeys)
_WGMMA_HEAD_DIMS = (32, 64, 128)
_WGMMA_ROWS = 128                 # rows of a chunk-scan CTA (phase 3)
# both routes' launches as the C entry points' mask: chunk states, state
# passing, chunk scan
PHASES = {"chunk_state": 1, "state_passing": 2, "chunk_scan": 4}
ALL_PHASES = 7
# the f32 route's launches: the chunk scores (C B^T per group) first
TF32_PHASES = {"chunk_scores": 8, **PHASES}
TF32_ALL_PHASES = 15

launches = 0
route_launches = {name: 0 for name, _, _ in ROUTES.values()}


def route(dtype: torch.dtype) -> tuple[str, str]:
    """(route name, kernel source) that a CUDA tensor of ``dtype`` takes."""
    if dtype not in ROUTES:
        raise ValueError(f"ssd_scan wants f32 or bf16 x, Bm, Cm of one type;"
                         f" got {dtype}")
    name, source, _ = ROUTES[dtype]
    return name, source


def bind(lib, dtype: torch.dtype):
    """Set the ctypes signatures of the C entry points of ``dtype``'s route
    on ``lib`` (the f32 route's shared-memory report too); returns the
    forward entry point."""
    fn = getattr(lib, ROUTES[dtype][2])
    if dtype == torch.float32:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [
            ctypes.c_void_p]
        lib.ssd_scan_tf32_smem.argtypes = [ctypes.c_int] * 5 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.ssd_scan_tf32_smem.restype = ctypes.c_int
    else:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _lib(dtype: torch.dtype):
    lib = build.load(ROUTES[dtype][1])
    fn = getattr(lib, ROUTES[dtype][2])
    if fn.argtypes is None:
        bind(lib, dtype)
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


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def tf32_smem(P: int, N: int, chunk: int, rows: int,
              keys1: int) -> tuple[int, int, int]:
    """Shared-memory bytes of the f32 route's chunk-scores, chunk-state and
    chunk-scan launches for a plan, the sums of ``csrc/ssd_scan_tf32.cu``
    (``score_smem``, ``state_smem``, ``scan_smem``; :func:`device_smem`
    reads the kernel's own): the scores raw C and B rows of 64-row blocks
    (round_up(N, 8) + 4 floats); the chunk states a two-stage ring of raw
    key tiles (B's 128 columns in rows of 136 floats, x) and x split into
    pairs (rows of P + 4); the chunk scan raw C rows (round_up(N, 16) + 4
    floats), a two-stage ring of (score rows of 16 + 4 floats, raw x or
    S_before rows) and that tile split into pairs; both the dt / cum arrays
    with their 32-step segment totals."""
    keys = _TF32_SCAN_KEYS
    span = _round_up(chunk, 64)
    arrays = 4 * (2 * span + span // 32)
    scores = 4 * 2 * 64 * (_round_up(N, 8) + 4)
    state = 4 * 2 * keys1 * (136 + P) + 8 * keys1 * (P + 4) + arrays
    scan = (4 * (rows * (_round_up(N, keys) + 4)
                 + 2 * (rows * (keys + 4) + keys * P))
            + 8 * keys * (P + 4) + arrays)
    return scores, state, scan


def device_smem(P: int, N: int, chunk: int, rows: int, keys1: int,
                device: torch.device) -> tuple[int, int, int, int]:
    """What the f32 kernel reckons for a plan on ``device`` (a CUDA
    device): its three launches' shared-memory bytes, as
    :func:`tf32_smem`, and the bytes a block may take there."""
    lib, _ = _lib(torch.float32)
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        build.check(lib.ssd_scan_tf32_smem(P, N, chunk, rows, keys1, out),
                    "ssd_scan_tf32_smem")
    return tuple(out)


_smem_limits: dict[int, int] = {}


def smem_limit(device: torch.device) -> int:
    """The shared memory a block may take on ``device``, as the f32 kernel
    reads it (``cudaDevAttrMaxSharedMemoryPerBlockOptin``)."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _smem_limits:
        _smem_limits[index] = device_smem(16, 4, 16, 16, 16,
                                          torch.device("cuda", index))[3]
    return _smem_limits[index]


def tf32_plan(P: int, N: int, chunk: int, limit: int) -> dict[str, int]:
    """The f32 route's launch plan: the first phase-1 key-tile rows (32,
    else 16; 16 for a chunk of 16 rows or fewer) and phase-3 rows per CTA
    (128, 64, 32 or 16, at most the chunk rounded up to 16) whose shared
    memory is within ``limit`` bytes, or ValueError."""
    c16 = _round_up(chunk, 16)

    def too_big(what):
        return ValueError(f"ssd_scan (f32): {what} need more than the "
                          f"{limit} bytes of shared memory a block may use")

    if tf32_smem(P, N, chunk, 16, 16)[0] > limit:
        raise too_big(f"N={N}")
    for keys1 in _TF32_STATE_KEYS if c16 > 16 else (16,):
        if tf32_smem(P, N, chunk, 16, keys1)[1] <= limit:
            break
    else:
        raise too_big(f"P={P}, chunk={chunk}")
    for rows in _TF32_SCAN_ROWS:
        rows = min(rows, c16)
        if tf32_smem(P, N, chunk, rows, keys1)[2] <= limit:
            return {"rows": rows, "keys1": keys1}
    raise too_big(f"P={P}, N={N}, chunk={chunk}")


def tf32_ctas(B: int, S: int, H: int, P: int, G: int, N: int,
              chunk: int, rows: int) -> dict[str, int]:
    """CTAs of the f32 route's four launches with ``rows`` chunk-scan rows
    per CTA (the scores' blocks right of the diagonal exit at once)."""
    nc = S // chunk
    nb = -(-chunk // 64)
    return {"chunk_scores": B * nc * G * nb * nb,
            "chunk_state": B * H * nc * -(-N // 128),
            "state_passing": B * H * -(-(N * P // 4) // 256),
            "chunk_scan": B * H * nc * -(-_round_up(chunk, 16) // rows)}


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
    _, fn = _lib(x.dtype)
    x, Bm, Cm = x.contiguous(), Bm.contiguous(), Cm.contiguous()
    if name == "f32":
        x, Bm, Cm = (t.clone() if t.data_ptr() % 16 else t
                     for t in (x, Bm, Cm))
    dt = dt.to(torch.float32).contiguous()
    A = A.to(torch.float32).contiguous()
    if name == "wgmma" and any(t.data_ptr() % 16 for t in (x, Bm, Cm)):
        raise ValueError("ssd_scan: TMA reads bf16 x, Bm, Cm from 16-byte "
                         "aligned bases only")
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if name == "f32":
            plan = tf32_plan(P, N, chunk, smem_limit(x.device))
            scratch = tf32_scratch(Bsz, S, H, P, G, N, chunk, x.device)
            rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                    Cm.data_ptr(), y.data_ptr(),
                    *(t.data_ptr() for t in scratch), Bsz, S, H, P, G, N,
                    chunk,
                    *tf32_plan_args(plan), TF32_ALL_PHASES, stream)
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


def tf32_scratch(Bsz, S, H, P, G, N, chunk, device):
    """The f32 route's scratch, f32: chunk states (B*H, nc, N, P), which the
    state passing overwrites in place with the states before each chunk,
    chunk decays (B*H, nc) and the chunk scores C B^T (B, nc, G, L, L),
    L = chunk rounded up to 64."""
    nc, L = S // chunk, _round_up(chunk, 64)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=device)

    return (empty(Bsz * H, nc, N, P), empty(Bsz * H, nc),
            empty(Bsz, nc, G, L, L))


def tf32_plan_args(plan: dict[str, int]) -> tuple[int, ...]:
    """A plan as the C entry point's arguments, in order."""
    return plan["rows"], plan["keys1"]


def tf32_entry():
    """The f32 route's C entry point (built on first use), for callers that
    time its launches apart (``repro_torch.profile_ssd``)."""
    return _lib(torch.float32)[1]


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
