"""Plain PyTorch oracle for the fuzzy-LUT kernels.

Semantics (port of ``repro.kernels.fuzzy_lut.ref``): for grouped input
``x: [T, K, v]``, stacked depth-d trees (``features: [K, 2^d - 1]`` int32,
``thresholds: [K, 2^d - 1]`` f32) and a LUT bank ``lut: [K, C, N]``:

    leaf[t, k] = leaf index of x[t, k] under tree k       (hard descent)
    y[t]       = sum_k lut[k, leaf[t, k]]  (+ bias)

The sum over k runs in ascending k, one add at a time — the order the CUDA
kernels use — so on one device the oracle, the ``gather`` backend and the
kernels give the same bits, and a chain of banks cannot flip a later
descent through rounding alone.
"""

from __future__ import annotations

import torch

__all__ = ["fuzzy_lut_matmul_ref", "lut_gather_sum", "tree_descent_ref"]


def tree_descent_ref(x: torch.Tensor, features: torch.Tensor,
                     thresholds: torch.Tensor) -> torch.Tensor:
    """Hard tree descent. ``x: [..., K, v]`` → leaf index ``[..., K]`` int64."""
    k, n_internal = features.shape[-2:]
    depth = (n_internal + 1).bit_length() - 1
    feat_flat = features.reshape(-1).long()
    thr_flat = thresholds.reshape(-1)
    base = torch.arange(k, device=x.device) * n_internal
    node = torch.zeros(x.shape[:-1], dtype=torch.long, device=x.device)
    for _ in range(depth):
        idx = node + base
        val = torch.gather(x, -1, feat_flat[idx].unsqueeze(-1)).squeeze(-1)
        node = 2 * node + 1 + (val > thr_flat[idx]).long()
    return node - n_internal


def lut_gather_sum(lut: torch.Tensor, leaves: torch.Tensor,
                   scales: torch.Tensor | None = None) -> torch.Tensor:
    """Map + SumReduce: ``Σ_k lut[k, leaves[:, k]]`` in ascending k.

    ``lut`` is ``[K, C, N]`` (f32, or int8 codes with per-group f32
    ``scales [K]``: each term is ``float(q) * s_k``). Returns ``[T, N]`` f32.
    One group's ``[T, N]`` rows at a time: no ``[T, K, N]`` intermediate,
    so the plain version runs at LM widths (K·N in the millions).
    """
    acc = torch.zeros((leaves.shape[0], lut.shape[2]), dtype=torch.float32,
                      device=lut.device)
    for j in range(lut.shape[0]):
        row = lut[j, leaves[:, j]].to(torch.float32)
        if scales is not None:
            row = row * scales[j]
        acc = acc + row
    return acc


def fuzzy_lut_matmul_ref(x: torch.Tensor, features: torch.Tensor,
                         thresholds: torch.Tensor, lut: torch.Tensor,
                         bias: torch.Tensor | None = None) -> torch.Tensor:
    """Oracle: descend, gather leaf rows per group and sum. ``[T, N]`` f32."""
    y = lut_gather_sum(lut, tree_descent_ref(x, features, thresholds))
    if bias is not None:
        y = y + bias
    return y
