"""Of the bytes the server copied to the device, the share that went
through its pinned stage: Δ``h2d_staged_bytes`` over Δ``h2d_staged_bytes``
+ Δ``h2d_pageable_bytes`` of ``stats()["serving"]``, over the window before
the traced sub-window; None where the program keeps no such counter or
staged nothing (a CPU plan counts its requests as pageable and stages
none)."""


def read(ctx):
    s0, s1 = ctx.serving
    if "h2d_staged_bytes" not in s1 or "h2d_pageable_bytes" not in s1:
        return None
    staged = s1["h2d_staged_bytes"] - s0["h2d_staged_bytes"]
    pageable = s1["h2d_pageable_bytes"] - s0["h2d_pageable_bytes"]
    return staged / (staged + pageable) if staged else None
