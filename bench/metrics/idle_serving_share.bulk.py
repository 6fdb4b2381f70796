"""The device's idle time in the traced sub-window while the server's
drain thread was inside a ``server.round`` span, over the sub-window's
length: the part of ``idle_share.bulk`` the server's own rounds leave, the
rest being idle while it was parked or between rounds. Needs the device
trace and the program's span records (``ctx.spans``)."""

from bench.span_reduce import idle_in_rounds_s


def read(ctx):
    recs, t = getattr(ctx, "spans", None), ctx.trace
    if recs is None or t is None:
        return None
    t_a = ctx.upto                     # the sub-window starts where counters stop
    return idle_in_rounds_s(t["spans"], recs, t_a, t_a + t["window"]) / t["window"]
