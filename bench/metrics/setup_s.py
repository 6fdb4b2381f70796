"""Seconds from the start of the process to the start of the window:
imports and device set-up, the kernels' load, the banks and the flow pool,
the plan's build and audit, its graph captures, the warm-up traffic."""


def read(ctx):
    return ctx.setup_s
