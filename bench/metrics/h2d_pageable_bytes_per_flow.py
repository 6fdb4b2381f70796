"""Bytes the server copied to the device from pageable host memory
(``stats()["serving"]["h2d_pageable_bytes"]``) per flow served, over the
window before the traced sub-window; None where the program keeps no such
counter."""


def read(ctx):
    s0, s1 = ctx.serving
    flows = s1["flows_served"] - s0["flows_served"]
    if "h2d_pageable_bytes" not in s1 or not flows:
        return None
    return (s1["h2d_pageable_bytes"] - s0["h2d_pageable_bytes"]) / flows
