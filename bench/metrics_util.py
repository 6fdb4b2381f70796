"""Arithmetic that several metric readers share."""

from __future__ import annotations

import numpy as np

from bench.ref.bounds import F32_OPS_PER_S, HBM_BYTES_PER_S
from bench.ref.trace_reduce import is_copy


def latency_quantile(lat_ms: np.ndarray, q: float) -> float | None:
    """The ``q`` quantile of request latencies, missing requests infinite;
    None when it would be infinite or there is no request."""
    if not lat_ms.size:
        return None
    if np.isfinite(lat_ms).all():
        return float(np.quantile(lat_ms, q))
    v = float(np.quantile(lat_ms, q, method="higher"))
    return v if np.isfinite(v) else None


def flows_per_batch(ctx) -> float | None:
    s0, s1 = ctx.serving
    batches = s1["batches_dispatched"] - s0["batches_dispatched"]
    return (s1["flows_served"] - s0["flows_served"]) / batches if batches else None


def bound_s(ctx, flows: int) -> float:
    """Least seconds of the model's work on ``flows`` flows at the peaks."""
    nbytes, ops = ctx.work(flows)
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def compute_s(trace: dict) -> float:
    """Device seconds of computing kernels in the traced sub-window."""
    return sum(v for k, v in trace["by_name"].items() if not is_copy(k))
