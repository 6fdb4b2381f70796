"""Pegasus Syntax (paper §6.2, Fig. 6): a declarative model description
that translates to primitives (port of ``repro.core.syntax``).

The paper's snippet

    meta.output_vec = SumReduce(
        Map(
            Partition(meta.input_vec, dim=2, stride=2),
            clustering_depth=4, CNN_dimension=3, ...))

maps one to one onto the spec dicts accepted here. ``translate`` checks the
shapes, works out the output widths it is not given, and builds a
``PrimitiveGraph``.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from .primitives import MapOp, PartitionOp, Prim, PrimitiveGraph, SumReduceOp

__all__ = ["partition", "map_op", "sumreduce", "program", "translate",
           "SyntaxError_"]


class SyntaxError_(ValueError):
    """Raised when a Pegasus-Syntax program is ill-formed."""


def partition(*, dim: int, stride: int | None = None) -> dict:
    return {"op": "Partition", "dim": dim, "stride": stride}


def map_op(*, clustering_depth: int, fn: Callable, out_dim: int | None = None,
           linear: bool = False, bias: Any = None, name: str = "") -> dict:
    return {"op": "Map", "clustering_depth": clustering_depth, "fn": fn,
            "out_dim": out_dim, "linear": linear, "bias": bias, "name": name}


def sumreduce() -> dict:
    return {"op": "SumReduce"}


def program(*ops: dict) -> list[dict]:
    return list(ops)


def _infer_out_dim(fn: Callable, in_dim: int) -> int:
    """The output width of ``fn`` on one group of width ``in_dim``: ``fn``
    runs once on a zero ``[1, 1, in_dim]`` CPU tensor."""
    with torch.no_grad():
        return int(fn(torch.zeros(1, 1, in_dim)).shape[-1])


def translate(spec: Sequence[dict], *, input_dim: int) -> PrimitiveGraph:
    """Pegasus Syntax → PrimitiveGraph, with dimension and shape checks."""
    ops: list[Prim] = []
    cur_dim = input_dim          # width of the current (per-group) vector
    grouped = False
    for i, node in enumerate(spec):
        kind = node.get("op")
        if kind == "Partition":
            if grouped:
                raise SyntaxError_(f"op {i}: nested Partition is not supported")
            dim, stride = node["dim"], node["stride"] or node["dim"]
            if (cur_dim - dim) % stride != 0:
                raise SyntaxError_(
                    f"op {i}: Partition(dim={dim}, stride={stride}) does not "
                    f"tile an input of width {cur_dim}")
            ops.append(PartitionOp(dim=dim, stride=node["stride"]))
            cur_dim = dim
            grouped = True
        elif kind == "Map":
            depth = node["clustering_depth"]
            if not (1 <= depth <= 16):
                raise SyntaxError_(f"op {i}: clustering_depth {depth} out of range")
            out_dim = node["out_dim"] or _infer_out_dim(node["fn"], cur_dim)
            ops.append(MapOp(
                fn=node["fn"], linear=node["linear"], in_dim=cur_dim,
                out_dim=out_dim, table_entries=2**depth, bias=node["bias"],
                name=node["name"] or f"map{i}"))
            cur_dim = out_dim
        elif kind == "SumReduce":
            if not grouped:
                raise SyntaxError_(f"op {i}: SumReduce before any Partition")
            ops.append(SumReduceOp())
            grouped = False
        else:
            raise SyntaxError_(f"op {i}: unknown op {kind!r}")
    return PrimitiveGraph(ops)
