"""Kernels the plans' CUDA graph replays launched
(``stats()["serving"]["graph_kernels"]``: the kernel nodes of each graph
replayed, the port's own kernels and the torch ops captured between them)
per 1,000 flows served, over the window before the traced sub-window; None
where the program keeps no such counter or counted none (the CPU)."""


def read(ctx):
    s0, s1 = ctx.serving
    if "graph_kernels" not in s1:
        return None
    kernels = s1["graph_kernels"] - s0["graph_kernels"]
    flows = s1["flows_served"] - s0["flows_served"]
    return kernels / (flows / 1000.0) if kernels and flows else None
