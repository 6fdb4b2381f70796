"""Flows whose requests completed inside the window, per second of it."""


def read(ctx):
    return ctx.flows_done_in_window / ctx.seconds
