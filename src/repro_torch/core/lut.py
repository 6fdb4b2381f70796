"""LUT construction: Map results precomputed at the leaf centroids with
full-precision weights (paper §4.2/§4.4); only the stored outputs are
optionally quantized to fixed point. Port of ``repro.core.lut``."""

from __future__ import annotations

from typing import Callable

import torch

from .fuzzy_tree import FuzzyTree
from .quantization import FixedPointSpec, choose_qspec, dequantize, quantize

__all__ = ["build_lut", "build_matmul_lut", "quantize_lut", "dequantize_lut"]


def build_lut(tree: FuzzyTree, fn: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Table of ``fn`` at every centroid: ``[C, out_dim]`` (``fn`` is
    batched over the centroids ``[C, v]``)."""
    out = fn(tree.centroids)
    return out[:, None] if out.dim() == 1 else out


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


def quantize_lut(lut: torch.Tensor, bits: int = 16) -> tuple[torch.Tensor, FixedPointSpec]:
    """Fixed-point codes of the stored outputs, with the binary point
    chosen from the LUT's own range (adaptive, §4.4)."""
    spec = choose_qspec(lut, bits=bits)
    return quantize(lut, spec), spec


def dequantize_lut(qlut: torch.Tensor, spec: FixedPointSpec) -> torch.Tensor:
    return dequantize(qlut, spec)
