"""CUDA-event timing of one call, shared by ``chip_smoke.py`` and the
profilers (``profile_codec``, ``profile_ssd``).

``event_ms`` is what a host-bound caller pays: the median event time of one
call, the host's enqueue included.  ``graph_ms`` is the device's own time:
calls captured in one CUDA graph, the replay timed with events.
"""

from __future__ import annotations

import statistics

import torch


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
