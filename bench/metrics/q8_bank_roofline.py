"""The int8 bank kernel's share of its roofline: the model's least time for
the flows served in the traced sub-window (``configs/<config>.py`` ``work``
with int8 tables; at RNN-B's widths the bytes bound it, so the chain adds
among its operations do not enter) over the device time of the kernels
whose name holds ``fuzzy_lut_q8``, in percent. None without a trace,
without flows, or where no such kernel ran."""

from bench.metrics_util import bound_s


def read(ctx):
    t = ctx.trace
    if t is None or not t["flows"]:
        return None
    q8_s = sum(v for k, v in t["by_name"].items() if "fuzzy_lut_q8" in k)
    if not q8_s:
        return None
    return 100.0 * bound_s(ctx, t["flows"]) / q8_s
