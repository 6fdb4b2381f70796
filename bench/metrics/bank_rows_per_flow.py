"""Rows the per-bank kernels were launched on (``stats()["serving"]
["bank_rows"]``: each replayed graph's per-bank kernel rows, bucket padding
included) per flow served, over the window before the traced sub-window;
None where the program keeps no such counter or counted none (the CPU),
or served no flow."""


def read(ctx):
    s0, s1 = ctx.serving
    if "bank_rows" not in s1:
        return None
    rows = s1["bank_rows"] - s0["bank_rows"]
    flows = s1["flows_served"] - s0["flows_served"]
    return rows / flows if rows and flows else None
