"""DTensor helpers for the LM stack on a mesh.

The models run unchanged on plain tensors. On DTensors (parameters placed
by :func:`repro_torch.launch.mesh.param_specs`) most ops propagate their
shardings through DTensor's rules; the helpers here are the places where
the port states a placement itself, each a collective the dry-run counts:

  * :func:`constrain` — the reference's ``with_sharding_constraint``: a
    DTensor is redistributed to a spec's placements, a plain tensor is
    returned as it is (the reference's ``try/except`` without a mesh).
  * :func:`replicate` — an all-gather for an op with no rule for a sharded
    operand (``argmax`` over the vocab; the caller says why).
  * :func:`batch_only`, :func:`keep_only_model_shards` — the LM head's
    input keeps only its batch shards and the head is gathered over the
    fsdp axes, so the product splits the vocab over "model".
  * :func:`split_heads` — projections viewed as heads; gathered over mesh
    dims that would split a head.
  * :func:`vocab_parallel_embed`, :func:`vocab_parallel_ce_terms` — the
    embedding gather and the loss's logsumexp and label logit over a
    vocab-sharded table or logits, each rank on its own columns (Megatron's
    vocab-parallel embedding and cross-entropy): DTensor's rules for
    ``aten.embedding`` and ``aten.gather`` leave a masked partial that
    fails when it is reduced after a reshape, and those for ``aten.index``
    gather the whole table.
  * :func:`local_region`, :func:`tp_region` — a block run on each rank's
    shards as plain tensors (the attention core; the mLSTM over its heads;
    the sLSTM and Mamba recurrences, whose mixing is dense, on every
    "model" rank): their loops issue per-tile and per-step ops that would
    each pay DTensor's dispatch, and some of them (a transposed gradient
    into a ``view``) fail on DTensor.
  * :func:`implicit` — plain tensors built inside the models meet DTensors
    as replicated ones.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

__all__ = ["batch_only", "constrain", "implicit", "is_dtensor", "keep_only_model_shards",
           "local_region", "mesh_dims", "replicate",
           "shard_offset", "split_heads", "tp_region", "vocab_parallel_ce_terms",
           "vocab_parallel_embed"]


@contextlib.contextmanager
def implicit(x):
    """A context in which plain tensors meet DTensors as replicated ones
    (the rotary tables, masks and positions the models build on the fly)
    when ``x`` is a DTensor; a no-op otherwise. It nests, where
    ``implicit_replication()`` switches the flag off at every exit."""
    if not is_dtensor(x):
        yield
        return
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def constrain(x, spec):
    """``x`` redistributed to ``spec`` (a :class:`~repro_torch.launch.mesh.P`
    over the mesh's axis names; axes a spec does not name are replicated);
    a plain tensor is returned as it is."""
    if not is_dtensor(x):
        return x
    from repro_torch.launch.mesh import placements

    return x.redistribute(x.device_mesh, placements(x.device_mesh, spec))


def batch_only(x):
    """``x`` with its batch shards (dim 0) over the fsdp axes kept and
    everything else gathered over every mesh dim, "model" included (where
    DTensor may have split the batch too), pending sums reduced; a plain
    tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    names = x.device_mesh.mesh_dim_names
    pl = [p if p == Shard(0) and names[i] != "model" else Replicate()
          for i, p in enumerate(x.placements)]
    return x.redistribute(x.device_mesh, pl)


def keep_only_model_shards(x):
    """``x`` gathered over every mesh dim but "model" (FSDP's all-gather of
    a weight before its use; tensor-parallel shards stay); a plain tensor
    as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    names = x.device_mesh.mesh_dim_names
    pl = [p if names[i] == "model" and not p.is_partial() else Replicate()
          for i, p in enumerate(x.placements)]
    return x.redistribute(x.device_mesh, pl)


def replicate(x):
    """``x`` replicated over every mesh dim (a plain tensor as it is)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def mesh_dims(x, dim: int) -> list[int]:
    """The mesh dims over which DTensor ``x`` shards tensor dim ``dim``."""
    from torch.distributed.tensor import Shard

    return [i for i, p in enumerate(x.placements) if p == Shard(dim % x.ndim)]


def local_region(fn, args, in_placements, out_placements):
    """``fn`` on the local shards of ``args``: each DTensor arg is
    redistributed to its entry of ``in_placements`` (None: passed as it
    is), ``fn`` runs on plain tensors, and each output (a tensor or a tuple
    of them) comes back as a DTensor with its entry of ``out_placements``.
    The redistributions are the region's only collectives; the caller
    chooses placements under which ``fn``'s rows and heads are
    independent, so the local results are the shards of the global ones."""
    from torch.distributed.tensor import DTensor

    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    outs = out_placements if isinstance(out_placements[0], (list, tuple)) else [out_placements]
    local = [_ContiguousGrad.apply(_local(a.redistribute(mesh, pl), outs))
             if pl is not None else a for a, pl in zip(args, in_placements)]
    out = fn(*local)
    if isinstance(out, tuple):
        return tuple(DTensor.from_local(o.contiguous(), mesh, pl, run_check=False)
                     for o, pl in zip(out, out_placements))
    return DTensor.from_local(out.contiguous(), mesh, out_placements, run_check=False)


def _local(x, out_placements):
    """``x.to_local()``, its gradient's placements stated: along a mesh dim
    where ``x`` is replicated but some output is not, the ranks compute
    from other rows or heads, so ``x``'s gradient is their sum
    (``Partial``); DTensor's default would call it replicated and drop the
    other ranks' parts."""
    from torch.distributed.tensor import Partial, Replicate

    grad = [Partial("sum") if pl == Replicate()
            and any(o[i] != Replicate() for o in out_placements) else pl
            for i, pl in enumerate(x.placements)]
    return x.to_local(grad_placements=grad)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose gradient is made contiguous. A local gradient with
    other strides (a permute's backward) would come back as a DTensor whose
    global strides claim contiguity, and DTensor's ``view`` in the matmul
    backward fails on its shard."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def tp_region(fn, x, weights, split_dims, n_heads: int, **kwargs):
    """``fn(x, *weights, **kwargs)`` for a block whose rows (batch) and
    heads are independent; on a DTensor ``x`` it runs as a
    tensor-parallel region. ``x`` keeps its batch shards and is gathered
    elsewhere; each weight is gathered over the fsdp axes (FSDP's gather
    before use) and, when the "model" axis splits ``n_heads`` whole heads,
    sharded there on its dim in ``split_dims`` (column-parallel in, a
    row-parallel out whose output stays ``Partial(sum)`` over "model").
    ``split_dims=None``, or heads the axis does not split, gathers the
    weights over "model" too and every "model" rank computes the whole
    block on its batch shard."""
    if not is_dtensor(x):
        return fn(x, *weights, **kwargs)
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = x.device_mesh
    batch = mesh_dims(x, 0)
    model = [i for i, name in enumerate(mesh.mesh_dim_names)
             if name == "model" and i not in batch]
    split = (split_dims is not None and bool(model)
             and n_heads % int(np.prod([mesh.size(i) for i in model])) == 0)
    x_pl = [Shard(0) if i in batch else Replicate() for i in range(mesh.ndim)]
    w_pls = [[Shard(d) if split and i in model else Replicate() for i in range(mesh.ndim)]
             for d in (split_dims or (None,) * len(weights))]
    out_pl = [Shard(0) if i in batch else Partial("sum") if split and i in model
              else Replicate() for i in range(mesh.ndim)]
    return local_region(lambda xl, *wl: fn(xl, *wl, **kwargs), (x, *weights),
                        (x_pl, *w_pls), out_pl)


def split_heads(x, n: int, hd: int):
    """``x`` [..., n·hd] reshaped to [..., n, hd]. A DTensor whose last dim
    is sharded over mesh dims that do not split ``n`` whole heads (GQA's
    few KV heads on a wide "model" axis) is first gathered over those mesh
    dims: DTensor cannot view a shard that holds part of a head, where
    GSPMD shards head_dim."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate

        last = x.ndim - 1
        dims = mesh_dims(x, last)
        if dims and n % int(np.prod([x.device_mesh.size(i) for i in dims])):
            pl = [Replicate() if i in dims else p for i, p in enumerate(x.placements)]
            x = x.redistribute(x.device_mesh, pl)
    return x.reshape(*x.shape[:-1], n, hd)


def _as_dtensor(x, mesh):
    from torch.distributed.tensor import DTensor, Replicate

    if is_dtensor(x):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def shard_offset(shape, mesh, placements) -> tuple[list[int], list[int]]:
    """(local shape, global offset) of this rank's shard of a tensor of
    ``shape`` placed evenly by ``placements``: mesh dims that shard one
    tensor dim split it in mesh order. Reads the rank's mesh coordinate
    only (DTensor's own helper builds tensors, which ``FakeTensorMode``
    cannot turn into offsets)."""
    from torch.distributed.tensor import Shard

    local, offset = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            d = pl.dim % len(shape)
            local[d] //= mesh.size(i)
            offset[d] += coord[i] * local[d]
    return local, offset


def vocab_parallel_ce_terms(logits, labels):
    """``(logsumexp(logits, -1), logits[..., labels])`` for DTensor logits
    [..., V] whose vocab dim may be sharded, without gathering them: each
    rank reduces the columns it holds, and the max (detached, as
    logsumexp's shift), the sum of exponentials and the label's logit are
    all-reduced over the vocab axes, [...]-sized each. DTensor's rule for
    ``aten.gather`` on a sharded index dim fails like ``aten.embedding``'s."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = logits.device_mesh
    vd = logits.ndim - 1
    pl = [Replicate() if p.is_partial() else p for p in logits.placements]
    logits = logits.redistribute(mesh, pl)
    vocab_dims = mesh_dims(logits, vd)
    out_pl = [Replicate() if i in vocab_dims else p for i, p in enumerate(pl)]
    part_pl = [Partial("sum") if i in vocab_dims else p for i, p in enumerate(pl)]
    max_pl = [Partial("max") if i in vocab_dims else p for i, p in enumerate(pl)]
    labels = _as_dtensor(labels, mesh).redistribute(mesh, out_pl)
    shape = tuple(logits.shape[:-1])
    stride = torch.empty(shape, device="meta").stride()

    def reduce(local, placements):
        return DTensor.from_local(local, mesh, placements, run_check=False, shape=shape,
                                  stride=stride).redistribute(mesh, out_pl)

    local = _local(logits, [out_pl]).to(torch.float32)
    m = reduce(local.amax(-1).detach(), max_pl)
    se = reduce(torch.exp(local - m.to_local()[..., None]).sum(-1), part_pl)
    logz = torch.log(se) + m
    cols, offset = shard_offset(logits.shape, mesh, pl)
    lab = labels.to_local().long() - offset[vd]
    hit = (lab >= 0) & (lab < cols[vd])
    picked = torch.gather(local, -1, torch.where(hit, lab, 0)[..., None])[..., 0]
    return logz, reduce(picked * hit.to(picked.dtype), part_pl)


def vocab_parallel_embed(table, tokens: torch.Tensor):
    """``table[tokens]`` for a DTensor ``table`` [V, D] whose vocab dim may
    be sharded. The table's other shardings (d_model on the fsdp axes) are
    all-gathered first, as FSDP gathers every weight before its use; the
    tokens are replicated over the vocab axes. Each rank then looks up the
    rows it holds, zeroes the others, and the result is ``Partial(sum)``
    over the vocab axes, reduced by the first op that needs it whole."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    vocab_dims = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    if not is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim, run_check=False)
    tab_pl = [Shard(0) if i in vocab_dims else Replicate() for i in range(mesh.ndim)]
    tok_pl = [Replicate() if i in vocab_dims else p for i, p in enumerate(tokens.placements)]
    if any(p.is_partial() for p in tok_pl):
        raise ValueError(f"token placements {tokens.placements} are partial")
    table = table.redistribute(mesh, tab_pl)
    tokens = tokens.redistribute(mesh, tok_pl)
    if not vocab_dims:
        return table[tokens.long()]
    local_rows, offset = shard_offset(table.shape, mesh, tab_pl)
    tok = tokens.to_local().long() - offset[0]
    hit = (tok >= 0) & (tok < local_rows[0])
    out_pl = [Partial("sum") if i in vocab_dims else p for i, p in enumerate(tok_pl)]
    rows = _local(table, [out_pl])[torch.where(hit, tok, 0)] * hit[..., None].to(table.dtype)
    shape = (*tokens.shape, table.shape[1])
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(rows, mesh, out_pl, run_check=False, shape=shape, stride=stride)
