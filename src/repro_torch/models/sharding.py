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
  * :func:`dense` — every weight product of the attention, the FFN and
    the LM head, its strategy stated per mesh dim from the layouts of its
    operands, never left to DTensor's propagation (which picks one per call
    from the tensor sizes). Over a mesh dim that splits the input's tokens
    the weight is gathered (ZeRO-3), or, with ``stationary=True`` (the
    decode step, whose activations are a few rows), the weight stays and
    the rows move; over the other mesh dims the product follows the
    weight's own shards (tensor parallel). :func:`add_bias` adds a bias on
    the output's shards.
  * :func:`split_tokens` — the layout of the residual stream between the
    layers of a full-sequence forward: rows on the mesh dims that carry the
    batch, the sequence on "model", the features whole. :func:`like`
    brings a block's output to the residual stream's placements before
    the add.
  * :func:`batch_only` — the LM head's input keeps only its batch shards,
    so the head product splits the vocab over "model".
  * :func:`write_at` — one position written into a decode cache by the
    rank that holds it.
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

__all__ = ["add_bias", "batch_only", "constrain", "dense", "implicit", "is_dtensor", "like",
           "local_region", "mesh_dims", "replicate", "shard_offset", "split_heads",
           "split_tokens", "tp_region", "vocab_parallel_ce_terms", "vocab_parallel_embed",
           "write_at"]


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
    """``x`` with its rows (dim 0) split over the mesh dims other than
    "model" that split its rows, or its features where its rows divide
    (the feature-sharded decode stream), and everything else gathered over
    every mesh dim, pending sums reduced; a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    last = Shard(x.ndim - 1)
    pl = [p if mesh.size(i) == 1 and not p.is_partial() else
          Shard(0) if names[i] != "model" and (p == Shard(0) or p == last
                                               and x.shape[0] % mesh.size(i) == 0)
          else Replicate() for i, p in enumerate(x.placements)]
    return x.redistribute(mesh, pl)


def split_tokens(x):
    """The residual stream ``x`` [B, S, D] of a full-sequence forward at its
    layout between layers: rows split over the mesh dims other than
    "model" that split them now (the fsdp axes, as ``batch_specs`` places
    the batch), the sequence over "model" when it divides, the features
    whole, pending sums reduced. Every dense product of a layer then runs
    on each rank's tokens with its weights gathered, so a rank's work is
    its share of the tokens however the batch is cut. A plain tensor as it
    is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    pl = []
    for i, p in enumerate(x.placements):
        if mesh.size(i) == 1:
            pl.append(Replicate() if p.is_partial() else p)
        elif names[i] != "model":
            pl.append(Shard(0) if p == Shard(0) else Replicate())
        else:
            pl.append(Shard(1) if x.shape[1] % mesh.size(i) == 0 else Replicate())
    return x.redistribute(mesh, pl)


def like(y, x):
    """``y`` redistributed to ``x``'s placements (a block's output before
    it is added to the residual stream ``x``); ``y`` as it is off a mesh."""
    if not is_dtensor(y):
        return y
    return y.redistribute(y.device_mesh, x.placements)


def dense(x, w, *, stationary: bool = False):
    """``x [..., K] @ w [K, N]`` with its strategy stated per mesh dim:

      * where ``x``'s tokens (a dim but the last) are split, the weight is
        gathered and the output split like ``x`` (ZeRO-3: FSDP's gather
        before use). With ``stationary`` a sharded weight stays where it
        is and ``x``'s rows move instead: they become slices of K where
        the weight splits K, and are gathered where it splits N;
      * where ``x``'s features or the weight's K are split, each rank
        contracts its slice of K and the sums are reduced;
      * where the weight's N is split, each rank computes its columns and
        the output's features are split (column-parallel);
      * elsewhere each rank computes the same product.

    Sums are reduced onto ``x``'s token split where it had one, else
    replicated, so the output holds no pending sum. Mesh dims of size 1
    keep every placement. A layout no rule takes (a pending sum in ``x``,
    ``x``'s features split where the weight splits N) raises: the choice
    is never DTensor's. Plain tensors multiply as they are."""
    if not (is_dtensor(x) or is_dtensor(w)):
        return x @ w
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = w.device_mesh if is_dtensor(w) else x.device_mesh
    x, w = _as_dtensor(x, mesh), _as_dtensor(w, mesh)
    last = Shard(x.ndim - 1)
    x_in, w_in, out, settled = [], [], [], []
    for i, (xp, wp) in enumerate(zip(x.placements, w.placements)):
        if mesh.size(i) == 1:
            x_in.append(xp)
            w_in.append(wp)
            out.append(Replicate())
            settled.append(Replicate())
            continue
        if xp.is_partial() or (xp == last and wp == Shard(1)):
            raise ValueError(f"dense: no stated strategy for x {tuple(x.placements)} "
                             f"and w {tuple(w.placements)} on mesh dim {i}")
        tokens = isinstance(xp, Shard) and xp != last
        if tokens and not (stationary and wp in (Shard(0), Shard(1))):
            x_in.append(xp)                          # ZeRO-3: the weight gathered
            w_in.append(Replicate())
            out.append(xp)
        elif xp == last or wp == Shard(0):
            x_in.append(last)                        # each rank's slice of K
            w_in.append(Shard(0))
            out.append(Partial("sum"))
        elif wp == Shard(1):
            x_in.append(Replicate())                 # column-parallel
            w_in.append(Shard(1))
            out.append(last)
        else:
            x_in.append(Replicate())
            w_in.append(Replicate())
            out.append(Replicate())
        settled.append(xp if tokens else Replicate() if out[-1].is_partial() else out[-1])
    y = local_region(torch.matmul, (x, w), (x_in, w_in), out)
    return y.redistribute(mesh, settled) if settled != out else y


def add_bias(y, b):
    """``y + b`` for a bias ``b`` [N] over ``y``'s last dim, the bias placed
    on ``y``'s feature shards; plain tensors add as they are."""
    if not is_dtensor(y):
        return y + b
    from torch.distributed.tensor import Replicate, Shard

    mesh = y.device_mesh
    last = Shard(y.ndim - 1)
    b_pl = [bp if mesh.size(i) == 1 else Shard(0) if p == last else Replicate()
            for i, (p, bp) in enumerate(zip(y.placements, b.placements))]
    return local_region(torch.add, (y, b), (y.placements, b_pl), y.placements)


def write_at(cache, pos: int, value) -> None:
    """``cache[:, pos] = value`` in place, for a decode cache [B, T, ...]
    and ``value`` [B, ...]. On a mesh ``value`` is placed as the cache
    without its dim 1 and only the rank whose shard of T holds ``pos``
    writes it: the cache never moves."""
    if not is_dtensor(cache):
        cache[:, pos] = value.to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard

    mesh = cache.device_mesh
    pl = [Replicate() if p == Shard(1) else Shard(p.dim - 1)
          if isinstance(p, Shard) and p.dim > 1 else p for p in cache.placements]
    val = _as_dtensor(value, mesh).redistribute(mesh, pl).to_local()
    local, off = shard_offset(cache.shape, mesh, cache.placements)
    if off[1] <= pos < off[1] + local[1]:
        cache.to_local()[:, pos - off[1]] = val.to(cache.dtype)


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
    local = []
    for a, pl in zip(args, in_placements):
        if pl is not None and torch.is_grad_enabled():
            # a redistribution to the same placements still reduces a
            # pending-sum gradient in its backward
            a = _ContiguousGrad.apply(_local(a.redistribute(mesh, pl), outs))
        elif pl is not None:
            a = (a if tuple(a.placements) == tuple(pl) else a.redistribute(mesh, pl)).to_local()
        local.append(a)
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
