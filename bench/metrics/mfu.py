"""``mfu``, in percent: a round's model FLOPs (counted by the
configuration's plain model from its layer shapes) / (the untraced
window's seconds a round x the configuration's peak, f32 on the CUDA
cores).  The whole round's share of the peak, host work included; the
profiler's own cost is not in it."""

from bench import yardstick


def read(ctx):
    peak = yardstick.PEAK_OPS_PER_S[ctx["config"]["peak"]]
    return 100 * ctx["flops"]["total"] / (ctx["round_s"] * peak)
