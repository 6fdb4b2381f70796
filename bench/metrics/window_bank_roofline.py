"""The CNN window bank's share of its roofline: its least time for the flows
served in the traced sub-window (``configs/cnn-b.py`` ``window_bank_work``:
the bank at (1, 6, 4096, 16) and 6 rows a flow, its trees and whole table
counted once; bytes bound it) over the device time of the kernels named
``fuzzy_lut_f32_bank``, the per-bank f32 entry, in percent. None without a
trace, without flows, without that helper, or where no such kernel ran."""

from bench.ref.bounds import F32_OPS_PER_S, HBM_BYTES_PER_S


def read(ctx):
    t = ctx.trace
    work = getattr(ctx.cell.model, "window_bank_work", None)
    if t is None or not t["flows"] or work is None:
        return None
    bank_s = sum(v for k, v in t["by_name"].items() if "fuzzy_lut_f32_bank" in k)
    if not bank_s:
        return None
    nbytes, ops = work(ctx.config, t["flows"])
    return 100.0 * max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) / bank_s
