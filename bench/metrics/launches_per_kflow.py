"""Kernel launches (``repro_torch.kernels.fuzzy_lut._lib.LAUNCHES``, graph
replays included) per 1,000 flows served, over the window before the traced
sub-window."""


def read(ctx):
    (s0, s1), (l0, l1) = ctx.serving, ctx.launches
    flows = s1["flows_served"] - s0["flows_served"]
    return (l1 - l0) / (flows / 1000.0) if flows else None
