"""LUT construction: Map results precomputed at the leaf centroids with
full-precision weights (paper §4.2/§4.4). Port of ``repro.core.lut``."""

from __future__ import annotations

import torch

__all__ = ["build_matmul_lut"]


def build_matmul_lut(trees_centroids: torch.Tensor, weight: torch.Tensor,
                     group_size: int) -> torch.Tensor:
    """Weighted-aggregation LUT bank for an approximate matmul.

    ``trees_centroids`` ``[K, C, v]`` and ``weight`` ``[D, N]`` with
    ``D = K * v`` give ``[K, C, N]`` where
    ``lut[k, c] = centroids[k, c] @ W[kv:(k+1)v]``.
    """
    k, c, v = trees_centroids.shape
    d, n = weight.shape
    if d != k * v or v != group_size:
        raise ValueError(f"weight rows {d} != K*v = {k}*{group_size}")
    return torch.einsum("kcv,kvn->kcn", trees_centroids, weight.reshape(k, v, n))
