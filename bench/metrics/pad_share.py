"""The share of the rows the plan dispatched that were padding: 1 - the
rows asked for over the rows dispatched, summed over every bucket of
``compile_stats()["rows"]`` read at the ends of the window before the
traced sub-window (``ctx.plan_rows``); None without those counts."""


def read(ctx):
    rows = getattr(ctx, "plan_rows", None)
    if rows is None:
        return None
    r0, r1 = rows
    asked = sum(v[0] for v in r1.values()) - sum(v[0] for v in r0.values())
    dispatched = sum(v[1] for v in r1.values()) - sum(v[1] for v in r0.values())
    return 1.0 - asked / dispatched if dispatched else None
