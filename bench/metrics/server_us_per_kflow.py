"""The server's own time per 1,000 flows served: the drain thread's
``server.round`` spans less the ``scheduler.*`` and ``plan.*`` spans they
opened, over the window before the traced sub-window (``ctx.spans``, the
program's span records); None without them."""

from bench.span_reduce import server_self_s


def read(ctx):
    recs = getattr(ctx, "spans", None)
    s0, s1 = ctx.serving
    flows = s1["flows_served"] - s0["flows_served"]
    if recs is None or not flows:
        return None
    return server_self_s(recs, ctx.t0, ctx.upto) * 1e9 / flows
