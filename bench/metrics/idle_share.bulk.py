"""1 - the device's busy time (the union of its kernels, copies and memsets)
over the traced sub-window's length."""


def read(ctx):
    return None if ctx.trace is None else ctx.trace["idle_share"]
