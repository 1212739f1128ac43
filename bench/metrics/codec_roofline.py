"""``codec_roofline``, in percent: B2's bound for a round (quantize: C x N
f32 read, C x N int8 and C f32 scales written; dequantize: those read,
C x N f32 written; at the HBM rate) / the device time of the quantize and
dequantize launches a round in the traced window."""

from bench import yardstick


def read(ctx):
    times = yardstick.durations(ctx, yardstick.is_codec)
    if not times or not ctx["rounds"]:
        return None
    c, n = ctx["members"], ctx["config"]["d_params"]
    bound_s = yardstick.bound_ms(10 * c * n + 8 * c, 0, 1.0)[0] / 1e3
    return 100 * bound_s / (sum(times) / ctx["rounds"])
