"""The model's least time for the flows served in the traced sub-window
over the sub-window's wall time, in percent: the whole step's share of the
card's peak, whatever kernels carry it."""

from bench.metrics_util import bound_s


def read(ctx):
    t = ctx.trace
    if t is None or not t["flows"]:
        return None
    return 100.0 * bound_s(ctx, t["flows"]) / t["window"]
