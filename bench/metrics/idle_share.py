"""``idle_share``: 1 - (the device's busy seconds a round in the traced
calls: the union of its kernel, copy and fill intervals) / (the untraced
window's seconds a round).  The profiler slows the host's side of a
traced call, not the device's operations, so the busy time is read from
the trace and the wall time from the window."""

from bench import yardstick


def read(ctx):
    lo, hi = ctx["window_us"]
    busy = yardstick.busy_us(yardstick.clip(
        [(s, e) for _, s, e in ctx["device_ops"]], lo, hi))
    if not busy or not ctx["rounds"]:
        return None
    return 1.0 - busy / 1e6 / ctx["rounds"] / ctx["round_s"]
