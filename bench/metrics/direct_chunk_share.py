"""Of the chunks the server dispatched, the share whose data crossed the
plan boundary once each way (the stage's slot straight into the graph's
static inputs, the static output straight into a pinned output slot):
Δ``chunks_direct`` / Δ``batches_dispatched`` of ``stats()["serving"]``,
over the window before the traced sub-window. None where the program keeps
no such counter or dispatched no batch, and where the run took no device
trace: on the CPU no chunk takes that path."""


def read(ctx):
    s0, s1 = ctx.serving
    if ctx.trace is None or "chunks_direct" not in s1:
        return None
    batches = s1["batches_dispatched"] - s0["batches_dispatched"]
    return (s1["chunks_direct"] - s0["chunks_direct"]) / batches if batches else None
