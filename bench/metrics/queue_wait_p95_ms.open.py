"""95th percentile of the scheduler's queue wait (submit to dispatch, as
each request's ``InferResult.queue_wait_ms`` reports it) over the requests
sent in the window before the traced sub-window."""

import numpy as np


def read(ctx):
    q = ctx.log.view("qwait")[ctx.ok & (ctx.log.view("sent") < ctx.upto)]
    q = q[np.isfinite(q)]
    return float(np.percentile(q, 95)) if q.size else None
