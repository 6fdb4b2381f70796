"""Least device time of the fuzzy-LUT work, from shapes and the leaves the
data reaches.

Frozen copy of ``_rows_touched``, ``bank_bound``, ``stack_bound`` and
``bound_ms`` from ``chip_smoke.py`` (with its two peaks), taken unchanged:
each input byte is counted once, each output byte once, the trees whole
and only the LUT rows that the leaves touch. ``p`` needs only
``.shape`` on ``p["x"]``, ``p["features"]`` and ``p["lut"]``, so shape-only
(meta) tensors do.

Peaks: one NVIDIA H100 SXM, 3.35 TB/s of HBM and 67 TFLOP/s in float32
outside the tensor cores (NVIDIA's data sheet).
"""

from __future__ import annotations

import torch

__all__ = ["HBM_BYTES_PER_S", "F32_OPS_PER_S", "bank_bound", "stack_bound", "bound_ms",
           "rows_touched"]

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def rows_touched(leaves, c) -> int:
    """Distinct (group, leaf) LUT rows this run's data reads."""
    k = leaves.shape[-1]
    flat = leaves.reshape(-1, k).long() + torch.arange(k, device=leaves.device) * c
    return int(torch.unique(flat).numel())


def bank_bound(p, leaves, q8: bool):
    """(bytes, ops) the per-bank function needs on these inputs."""
    t, k, v = p["x"].shape
    i = p["features"].shape[1]
    n = p["lut"].shape[2]
    nbytes = (4 * t * k * v + 8 * k * i + rows_touched(leaves, i + 1) * n * (1 if q8 else 4)
              + (4 * k if q8 else 0) + 4 * t * n)
    depth = (i + 1).bit_length() - 1
    ops = t * k * depth + t * k * n * (2 if q8 else 1)
    return nbytes, ops


def stack_bound(p, leaves, ks, n_out, q8: bool):
    t, k0, v = p["x"].shape
    c = p["lut"].shape[2]
    depth = c.bit_length() - 1
    nbytes, ops = 4 * t * k0 * v + 4 * t * n_out, 0
    for l, k in enumerate(ks):
        n_eff = n_out if l == len(ks) - 1 else ks[l + 1] * v
        rows = rows_touched(leaves[l, :, :k], c)
        nbytes += 8 * k * (c - 1) + rows * n_eff * (1 if q8 else 4) + 4 * n_eff + (4 * k if q8 else 0)
        ops += t * k * depth + t * k * n_eff * (2 if q8 else 1) + t * n_eff
    return nbytes, ops


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")
