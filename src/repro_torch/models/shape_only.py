"""Loops run as one shape-only step on the meta device.

The dry-run (:mod:`repro_torch.launch.dryrun`) runs a model's step on
tensors whose local shards live on the ``meta`` device: every op computes
shapes only, at a Python cost of ~0.1 ms. The chunked attention (nq · nk
tiles) and the recurrences (one step per token) would issue hundreds of
thousands of such ops at the dry-run's 32k-token shapes. On meta inputs
those loops call :func:`loop_on_meta` instead: it returns empty meta
outputs of the loop's shapes, empty gradients of its inputs' shapes in the
backward, and hands the FLOPs that the loop's matrix products would run
(forward; twice that in the backward) to the counters listening in
:data:`FLOP_SINKS`. On real tensors the loops run as written.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["FLOP_SINKS", "loop_on_meta"]

# callables taking a FLOP count: LocalOpCounter adds one while entered
FLOP_SINKS: list[Callable[[int], None]] = []


def _report(flops: int) -> None:
    for sink in FLOP_SINKS:
        sink(int(flops))


class _LoopOnMeta(torch.autograd.Function):
    @staticmethod
    def forward(ctx, outputs, flops, *inputs):
        ctx.shapes = [(x.shape, x.dtype) for x in inputs]
        ctx.flops = flops
        _report(flops)
        out = tuple(torch.empty(shape, dtype=dtype, device="meta") for shape, dtype in outputs)
        return out if len(out) > 1 else out[0]

    @staticmethod
    def backward(ctx, *grads):
        _report(2 * ctx.flops)      # each product's two gradient products
        return (None, None, *(torch.empty(shape, dtype=dtype, device="meta")
                              for shape, dtype in ctx.shapes))


def loop_on_meta(outputs, flops: int, *inputs):
    """Empty meta tensors of ``outputs`` (``(shape, dtype)`` pairs; one
    tensor for one pair) standing for a loop over ``inputs`` whose matrix
    products take ``flops``."""
    return _LoopOnMeta.apply(tuple(outputs), int(flops), *inputs)
