"""Time in plan calls (``plan.call`` spans: copy-in, graph replay, clone)
per 1,000 flows served, over the window before the traced sub-window
(``ctx.spans``); None without span records."""

from bench.span_reduce import named, window


def read(ctx):
    recs = getattr(ctx, "spans", None)
    s0, s1 = ctx.serving
    flows = s1["flows_served"] - s0["flows_served"]
    if recs is None or not flows:
        return None
    m = window(recs, named(recs, "plan.call"), ctx.t0, ctx.upto)
    return float((recs.end[m] - recs.start[m]).sum()) * 1e9 / flows
