"""CUDA-event timing of one call, shared by ``chip_smoke.py`` and the
profilers (``profile_codec``, ``profile_ssd``, ``profile_flash``), and the
least time the card could take for a kernel's work.

``event_ms`` is what a host-bound caller pays: the median event time of one
call, the host's enqueue included.  ``graph_ms`` is the device's own time:
calls captured in one CUDA graph, the replay timed with events.
``bound_ms`` and ``f32_bounds`` reckon a kernel's bound from its bytes and
operations at the H100 SXM's published rates.
"""

from __future__ import annotations

import statistics

import torch

# H100 SXM data sheet, dense rates at the full 700 W
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12            # f32 on the CUDA cores
TF32_OPS_PER_S = 495e12          # TF32 tensor cores
BF16_OPS_PER_S = 989e12          # bf16 tensor cores
SPLIT_TF32_PRODUCTS = 3          # TF32 products per split-TF32 product


def bound_ms(nbytes: float, ops: float, peak: float) -> tuple[float, str]:
    """The larger of the bytes' time at HBM_BYTES_PER_S and the operations'
    time at ``peak``, in ms, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def f32_bounds(nbytes: float, ops: float) -> dict:
    """Bounds of an f32 kernel: on the tensor cores in split TF32 (three
    TF32 products per product, at TF32_OPS_PER_S) and on the CUDA cores (at
    F32_OPS_PER_S).  ``bound_ms`` / ``bound_by`` are the lower of the two,
    the least time either way of doing the work could take."""
    tf32 = bound_ms(nbytes, SPLIT_TF32_PRODUCTS * ops, TF32_OPS_PER_S)
    cores = bound_ms(nbytes, ops, F32_OPS_PER_S)
    low = min(tf32, cores)
    return {"bound_ms": low[0], "bound_by": low[1],
            "split_tf32_bound_ms": tf32[0], "cuda_core_bound_ms": cores[0]}


def event_ms(fn, reps: int = 30, warm: int = 5) -> float:
    """Median CUDA-event time of one call of ``fn`` (host enqueue included,
    inputs resident in L2 as on the main path, where the rows were just
    written), ``reps`` calls after ``warm``."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def graph_ms(fn, reps: int = 30, replays: int = 5) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in one CUDA
    graph, the best of ``replays`` event-timed replays divided by ``reps``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):            # warm-up outside the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(replays):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        torch.cuda.synchronize()
        best = min(best, s.elapsed_time(e) / reps)
    del graph
    return best
