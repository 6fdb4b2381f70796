"""Pegasus primitives (paper §4.1): Partition, Map, SumReduce (port of
``repro.core.primitives``).

Two layers:

1. **Functional forms** (``partition``, ``map_apply``, ``sum_reduce``) on
   tensors.

2. **PrimitiveGraph IR** — a straight-line op list describing a model as a
   primitive program. The fusion passes (``repro_torch.core.fusion``)
   rewrite it. The IR mirrors the paper's Figure 5 boxes so fusion results
   can be checked against the paper's worked example.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch

__all__ = [
    "partition",
    "unpartition",
    "map_apply",
    "sum_reduce",
    "Prim",
    "PartitionOp",
    "MapOp",
    "SumReduceOp",
    "PrimitiveGraph",
]


# ---------------------------------------------------------------------------
# Functional primitives
# ---------------------------------------------------------------------------


def partition(x: torch.Tensor, dim: int, stride: int | None = None) -> torch.Tensor:
    """Partition(X) = {X_1 .. X_k}: split the last axis into groups of width
    ``dim``, ``stride`` apart (default ``dim``: disjoint groups). With
    ``stride < dim`` the groups overlap, which is how a 1-D convolution's
    sliding window is a Partition (paper §6.2). Returns ``[..., K, dim]``."""
    stride = dim if stride is None else stride
    k = (x.shape[-1] - dim) // stride + 1
    idx = (torch.arange(k, device=x.device)[:, None] * stride
           + torch.arange(dim, device=x.device)[None, :])            # [K, dim]
    return x[..., idx]


def unpartition(xg: torch.Tensor) -> torch.Tensor:
    """Inverse of a disjoint partition: ``[..., K, v] → [..., K*v]``."""
    return xg.reshape(*xg.shape[:-2], xg.shape[-2] * xg.shape[-1])


def map_apply(fns: Sequence[Callable[[torch.Tensor], torch.Tensor]] | Callable,
              xg: torch.Tensor) -> torch.Tensor:
    """Map(F, {X_1..X_k}): apply ``fns[i]`` to group ``i`` (the last-but-one
    axis); a single callable applies to every group."""
    k = xg.shape[-2]
    if callable(fns):
        fns = [fns] * k
    return torch.stack([fns[i](xg[..., i, :]) for i in range(k)], dim=-2)


def sum_reduce(xg: torch.Tensor) -> torch.Tensor:
    """SumReduce({X_1..X_k}) = sum_i X_i over the group axis (last-but-one)."""
    return xg.sum(dim=-2)


# ---------------------------------------------------------------------------
# Primitive IR
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Prim:
    """Base IR node."""

    name: str = dataclasses.field(default="", kw_only=True)


@dataclasses.dataclass
class PartitionOp(Prim):
    """Split the last axis into K groups of width ``dim`` (stride ``stride``)."""

    dim: int
    stride: int | None = None


@dataclasses.dataclass
class MapOp(Prim):
    """Per-group function application.

    Attributes:
      fn: group-batched callable ``[..., v] → [..., o]``.
      linear: whether ``fn(a + b) == fn(a) + fn(b)`` (enables Linear
        Reordering, paper §4.3(1)); an affine map is ``linear=True`` with
        its constant in ``bias``.
      in_dim / out_dim: per-group widths (for table sizing).
      table_entries: entries a dataplane lookup needs (2**tree_depth under
        fuzzy matching).
    """

    fn: Callable[[torch.Tensor], torch.Tensor]
    linear: bool
    in_dim: int
    out_dim: int
    table_entries: int
    bias: Any = None  # constant term hoisted by linear reordering


@dataclasses.dataclass
class SumReduceOp(Prim):
    """Sum over the group axis."""


@dataclasses.dataclass
class PrimitiveGraph:
    """A straight-line primitive program (the paper's Fig. 5 boxes).

    ``ops`` run left to right. ``evaluate`` interprets the program on a
    tensor: the semantics every Basic fusion pass must preserve.
    """

    ops: list[Prim]

    def evaluate(self, x: torch.Tensor) -> torch.Tensor:
        for op in self.ops:
            if isinstance(op, PartitionOp):
                x = partition(x, op.dim, op.stride)
            elif isinstance(op, MapOp):
                x = op.fn(x)
                if op.bias is not None:
                    x = x + op.bias
            elif isinstance(op, SumReduceOp):
                x = sum_reduce(x)
            else:
                raise TypeError(f"unknown primitive {op!r}")
        return x

    def num_lookups(self) -> int:
        """Dataplane table lookups = number of Map ops (paper counts these)."""
        return sum(isinstance(op, MapOp) for op in self.ops)

    def table_entries(self) -> int:
        return sum(op.table_entries for op in self.ops if isinstance(op, MapOp))

    def describe(self) -> str:
        parts = []
        for op in self.ops:
            if isinstance(op, PartitionOp):
                parts.append(f"Partition(dim={op.dim})")
            elif isinstance(op, MapOp):
                tag = "lin" if op.linear else "nonlin"
                parts.append(f"Map[{tag}]({op.name or op.fn.__name__})")
            elif isinstance(op, SumReduceOp):
                parts.append("SumReduce")
        return " -> ".join(parts)
