"""95th percentile of the requests' queue waits, submit to dispatch
(``scheduler.queue`` spans), over the requests dispatched in the window
before the traced sub-window (``ctx.spans``); None without span records."""

import numpy as np

from bench.span_reduce import named


def read(ctx):
    recs = getattr(ctx, "spans", None)
    if recs is None:
        return None
    m = named(recs, "scheduler.queue") & (recs.end >= ctx.t0) & (recs.end <= ctx.upto)
    if not m.any():
        return None
    return float(np.percentile(recs.end[m] - recs.start[m], 95)) * 1e3
