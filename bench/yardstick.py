"""The yardstick: the card's published rates, a kernel's bound, and the
reduction of a ``torch.profiler`` trace to busy time, idle gaps and
kernel times.

Frozen copies, so that a change to the program cannot move them: the
rates and ``bound_ms`` of ``repro_torch/timing.py``, and the busy-interval
union and the host-stage clocks of ``repro_torch/profile_round.py``
(``_busy_ms``, ``_host_stages``).
"""

from __future__ import annotations

import time

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W: HBM bytes a
# second, and operations a second by the type the products run in (f32 on
# the CUDA cores, TF32 and bf16 on the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12}


def bound_ms(nbytes: float, ops: float, peak: float) -> tuple[float, str]:
    """The larger of the bytes' time at ``HBM_BYTES_PER_S`` and the
    operations' time at ``peak``, in ms, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def merge(intervals) -> list[tuple[float, float]]:
    """The union of ``[start, end)`` intervals as disjoint sorted ones."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_us(intervals) -> float:
    """Length of the union of ``[start, end)`` intervals."""
    return sum(e - s for s, e in merge(intervals))


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """``intervals`` cut to ``[lo, hi)``, empty ones dropped."""
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def idle_gaps(busy, lo: float, hi: float) -> list[tuple[float, float]]:
    """The gaps of ``[lo, hi)`` that no interval of ``busy`` covers."""
    gaps, cur = [], lo
    for s, e in merge(clip(busy, lo, hi)):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        gaps.append((cur, hi))
    return gaps


class HostClock:
    """Host seconds spent inside wrapped callables, by key."""

    def __init__(self):
        self.seconds: dict[str, float] = {}

    def wrap(self, fn, key: str, label=None):
        """``fn`` timed under ``key``; ``label`` (a context manager
        factory, such as ``torch.profiler.record_function``) marks each
        call in a trace."""
        self.seconds.setdefault(key, 0.0)

        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                if label is None:
                    return fn(*args, **kwargs)
                with label(f"bench.{key}"):
                    return fn(*args, **kwargs)
            finally:
                self.seconds[key] += time.perf_counter() - t0
        return run


def durations(ctx: dict, match) -> list[float]:
    """Seconds of each device operation in the traced window whose name
    ``match`` accepts."""
    lo, hi = ctx["window_us"]
    return [(e - s) / 1e6 for name, s, e in ctx["device_ops"]
            if lo <= s < hi and match(name)]


# the program's own kernels: B1 (csrc/topk_select.cu) and B2
# (csrc/quantize.cu)
TOPK = "topk_mask_cluster"
QUANTIZE = "quantize_cluster"
DEQUANTIZE = "dequantize("


def is_topk(name: str) -> bool:
    return TOPK in name


def is_codec(name: str) -> bool:
    return QUANTIZE in name or DEQUANTIZE in name
