"""Median, over every request due in the window, of its completion time
less its due time (a failed request counts as infinitely late)."""

from bench.metrics_util import latency_quantile


def read(ctx):
    return latency_quantile(ctx.latency_ms, 0.50)
