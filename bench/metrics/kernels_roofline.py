"""The model's least time for the flows served in the traced sub-window
(the larger of its bytes over the HBM peak and its operations over the f32
peak, ``configs/<config>.py`` ``work``) over the device time of every
computing kernel (not a copy or memset) in that sub-window, in percent."""

from bench.metrics_util import bound_s, compute_s


def read(ctx):
    t = ctx.trace
    if t is None or not t["flows"] or not compute_s(t):
        return None
    return 100.0 * bound_s(ctx, t["flows"]) / compute_s(t)
