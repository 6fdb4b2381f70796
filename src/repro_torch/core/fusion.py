"""Primitive Fusion (paper §4.3); port of ``repro.core.fusion``.

Basic Primitive Fusion — semantics-preserving rewrites:
  (1) *Linear Reordering*: ``Map_f(SumReduce(xs)) == SumReduce(Map_f(xs))``
      for linear ``f``, so the f-lookup can merge into the per-group
      lookups before the SumReduce. An affine map's bias is added once,
      after the reduce, not once per group.
  (2) *Map Merging*: consecutive Maps compose into one Map (one lookup).

Advanced Primitive Fusion — architecture-modifying rewrites:
  (a) *Nonlinear Removal*: delete nonlinear Maps; everything collapses to
      a single linear lookup (fast, but a linear model).
  (b) *SumReduce Reduction* (NAM form): keep only the final SumReduce;
      each partition group becomes an independent sub-model folded into
      one Map — the structure of CNN-M/L and the AutoEncoder.

Every pass takes and returns a :class:`PrimitiveGraph`.
"""

from __future__ import annotations

import dataclasses

from .primitives import MapOp, PartitionOp, Prim, PrimitiveGraph, SumReduceOp

__all__ = [
    "identity",
    "fuse_basic",
    "merge_consecutive_maps",
    "linear_reorder",
    "advanced_remove_nonlinear",
    "advanced_nam",
]


def identity(x):
    """Marker fn for pure bias-add ops (constant adds are actions, not lookups)."""
    return x


def _compose(outer: MapOp, inner: MapOp) -> MapOp:
    """Map merging: ``outer(inner(x) + b_i)`` as one table (one lookup).

    If ``outer`` is linear, the inner bias hoists:
    ``fo(fi(x) + b_i) = fo(fi(x)) + fo(b_i)``, which keeps the fused op's
    linearity flag honest (fn strictly linear, constants in ``bias``).
    """
    fi, fo = inner.fn, outer.fn
    bi = inner.bias

    if outer.linear and bi is not None:
        def fused(x):
            return fo(fi(x))

        hoisted = fo(bi)
        bias = hoisted if outer.bias is None else hoisted + outer.bias
        lin = inner.linear  # fn part is fo∘fi: linear iff both are
    else:
        def fused(x):
            y = fi(x)
            if bi is not None:
                y = y + bi
            return fo(y)

        bias = outer.bias
        lin = outer.linear and inner.linear and bi is None

    return MapOp(
        fn=fused,
        linear=lin,
        in_dim=inner.in_dim,
        out_dim=outer.out_dim,
        # the fused table is indexed by the INNER input → inner's entry count
        table_entries=inner.table_entries,
        bias=bias,
        name=f"{outer.name or 'map'}∘{inner.name or 'map'}",
    )


def merge_consecutive_maps(graph: PrimitiveGraph) -> PrimitiveGraph:
    """Basic fusion (2): collapse runs of Maps into single Maps."""
    ops: list[Prim] = []
    for op in graph.ops:
        if isinstance(op, MapOp) and ops and isinstance(ops[-1], MapOp):
            ops[-1] = _compose(op, ops[-1])
        else:
            ops.append(dataclasses.replace(op) if isinstance(op, MapOp) else op)
    return PrimitiveGraph(ops)


def linear_reorder(graph: PrimitiveGraph) -> PrimitiveGraph:
    """Basic fusion (1): swap ``SumReduce ; Map_linear`` → ``Map ; SumReduce``.

    After the swap the Map sits next to whatever produced the groups, and a
    later :func:`merge_consecutive_maps` absorbs it into the per-group
    tables. An affine map's bias must not be distributed over the k groups
    (it would be added k times): it becomes a bias-only Map after the
    reduce.
    """
    ops: list[Prim] = []
    i = 0
    while i < len(graph.ops):
        op = graph.ops[i]
        nxt = graph.ops[i + 1] if i + 1 < len(graph.ops) else None
        if (
            isinstance(op, SumReduceOp)
            and isinstance(nxt, MapOp)
            and nxt.linear
            and nxt.fn is not identity  # pure bias-adds don't benefit
        ):
            ops.append(dataclasses.replace(nxt, bias=None, name=(nxt.name or "map") + "<swap"))
            ops.append(SumReduceOp())
            if nxt.bias is not None:
                ops.append(MapOp(fn=identity, linear=True, in_dim=nxt.out_dim,
                                 out_dim=nxt.out_dim,
                                 table_entries=0,  # constant add: an action, not a lookup
                                 bias=nxt.bias, name="bias"))
            i += 2
        else:
            ops.append(op)
            i += 1
    return PrimitiveGraph(ops)


def fuse_basic(graph: PrimitiveGraph, max_iters: int = 10) -> PrimitiveGraph:
    """Iterate linear-reorder + map-merge to a fixed point (paper Fig. 5 ①)."""
    prev = -1
    g = graph
    for _ in range(max_iters):
        g = merge_consecutive_maps(linear_reorder(g))
        if len(g.ops) == prev:
            break
        prev = len(g.ops)
    return g


# ---------------------------------------------------------------------------
# Advanced fusion (architecture-modifying)
# ---------------------------------------------------------------------------


def advanced_remove_nonlinear(graph: PrimitiveGraph) -> PrimitiveGraph:
    """Advanced fusion (a): delete every nonlinear Map, then basic-fuse.

    The result is a purely linear pipeline, a single lookup once basic
    fusion runs (paper Fig. 5 ②: accuracy "may significantly drop").
    """
    ops = [op for op in graph.ops if not (isinstance(op, MapOp) and not op.linear)]
    return fuse_basic(PrimitiveGraph(ops))


def advanced_nam(graph: PrimitiveGraph, sub_model_fns=None) -> PrimitiveGraph:
    """Advanced fusion (b): NAM reduction (paper Fig. 5 ③).

    Structure: ``Partition → Map(sub-model per group) → SumReduce``. Every
    inner SumReduce goes and each group's whole chain becomes one Map.
    Since that changes the semantics, the per-group sub-model is either the
    caller's (``sub_model_fns``, typically a retrained per-group network)
    or the original chain run on one group alone, inner SumReduces taken
    as identity (the structural surrogate that backprop then refines).
    """
    part = next((op for op in graph.ops if isinstance(op, PartitionOp)), None)
    if part is None:
        raise ValueError("NAM reduction needs a leading Partition")
    maps = [op for op in graph.ops if isinstance(op, MapOp)]
    out_dim = graph.ops[-1].out_dim if isinstance(graph.ops[-1], MapOp) else None

    if sub_model_fns is None:
        def sub_model(xg):
            y = xg
            for op in maps:
                y = op.fn(y)
                if op.bias is not None:
                    y = y + op.bias
            return y

        fn = sub_model
    else:
        fn = sub_model_fns

    fused_map = MapOp(fn=fn, linear=False, in_dim=part.dim,
                      out_dim=out_dim or maps[0].out_dim,
                      table_entries=maps[0].table_entries, name="nam-submodel")
    return PrimitiveGraph([part, fused_map, SumReduceOp()])
