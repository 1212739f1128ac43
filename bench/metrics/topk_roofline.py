"""``topk_roofline``, in percent: B1's bound (the C x N f32 delta rows
read once, the C x N one-byte mask written once, at the HBM rate) / the
mean device time of one top-k launch in the traced window."""

from bench import yardstick


def read(ctx):
    times = yardstick.durations(ctx, yardstick.is_topk)
    if not times:
        return None
    rows = ctx["members"] * ctx["config"]["d_params"]
    bound_s = yardstick.bound_ms(5 * rows, 0, 1.0)[0] / 1e3
    return 100 * bound_s / (sum(times) / len(times))
