"""Top-k MoE FFN with grouped capacity-based one-hot dispatch
(Switch/GShard style; port of ``repro.models.moe``).

Tokens are split into groups of ``group_size``; routing positions and the
one-hot dispatch/combine tensors are per group, so dispatch memory is
O(T·E·C_g) with C_g ∝ group_size/E. Capacity bounds the dispatch tensor.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

from .layers import Params, activation, dense_init
from .sharding import is_dtensor, local_region, mesh_dims, replicate, shard_offset

__all__ = ["init_moe", "moe_forward"]


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, num_experts: int, *,
             gated: bool = True, dtype=torch.bfloat16) -> Params:
    p = dict(
        router=dense_init(gen, (d_model, num_experts), dtype=torch.float32),
        w_in=dense_init(gen, (num_experts, d_model, d_ff), in_axis=1, dtype=dtype),
        w_out=dense_init(gen, (num_experts, d_ff, d_model), in_axis=1, dtype=dtype),
    )
    if gated:
        p["w_gate"] = dense_init(gen, (num_experts, d_model, d_ff), in_axis=1, dtype=dtype)
    return Params(**p)


def moe_forward(
    p: Params,
    x: torch.Tensor,              # [B, S, D]
    *,
    top_k: int,
    act: str = "silu",
    capacity_factor: float = 1.25,
    group_size: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output [B,S,D], aux_loss scalar).

    On a mesh (DTensor ``x``) the block runs on each rank's shards
    (:func:`_moe_on_mesh`): experts split over "model" when it divides them
    (expert parallelism), else each expert's d_ff (tensor parallelism)."""
    b, s, d = x.shape
    t = b * s
    g = min(group_size, t)
    if t % g:
        raise ValueError(f"{t} tokens do not split into groups of {g}")
    ws = [p.w_in, p.w_out] + ([p.w_gate] if "w_gate" in p else [])
    if is_dtensor(x):
        return _moe_on_mesh(x, p.router, ws, g=g, top_k=top_k, act=act,
                            capacity_factor=capacity_factor)
    y, dens, pmean = _moe_local(x, p.router, *ws, g=g, top_k=top_k, act=act,
                                capacity_factor=capacity_factor, e0=0)
    return y.to(x.dtype), p.router.shape[1] * torch.sum(dens * pmean)


def _moe_local(x, router, w_in, w_out, w_gate=None, *, g: int, top_k: int, act: str,
               capacity_factor: float, e0: int):
    """The block on plain tensors: the routing of every token over all
    experts, the expert FFNs of the experts ``w_in`` holds (the first is
    expert ``e0``; all of d_ff or a slice of it). Returns (output [B,S,D]
    in f32, per-expert dispatch density [E], mean router probability [E])."""
    b, s, d = x.shape
    e = router.shape[1]
    t = b * s
    ng = t // g
    xt = x.reshape(ng, g, d)

    logits = xt.to(torch.float32) @ router                             # [G, g, E]
    probs = torch.softmax(logits, dim=-1)

    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)             # [G, g, k]
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    capacity = max(int(np.ceil(g * top_k / e * capacity_factor)), top_k)

    # position of each (token, choice) within its expert via per-group cumsum
    onehot = F.one_hot(gate_idx, e)                                    # [G, g, k, E]
    flatoh = onehot.reshape(ng, g * top_k, e)
    pos_in_expert = (torch.cumsum(flatoh, dim=1) - flatoh).reshape(ng, g, top_k, e)
    pos_in_expert = (pos_in_expert * onehot).sum(-1)                   # [G, g, k]
    keep = pos_in_expert < capacity
    # one_hot of a position past capacity is the zero row (jax.nn.one_hot)
    pos_oh = F.one_hot(torch.clamp(pos_in_expert, max=capacity), capacity + 1)[..., :capacity]

    mine = slice(e0, e0 + w_in.shape[0])
    eoh = onehot[..., mine].to(torch.float32)
    disp = (eoh.to(x.dtype)[..., None] * pos_oh.to(x.dtype)[..., None, :]
            * keep[..., None, None].to(x.dtype)).sum(2)                # [G, g, E, C]
    comb = (eoh[..., None] * pos_oh.to(torch.float32)[..., None, :]
            * (gate_vals * keep.to(torch.float32))[..., None, None]).sum(2)

    xe = torch.einsum("Ngd,Ngec->Necd", xt, disp)
    act_fn = activation(act)
    if w_gate is not None:
        h = act_fn(torch.einsum("Necd,edf->Necf", xe, w_gate)) * torch.einsum(
            "Necd,edf->Necf", xe, w_in)
    else:
        h = act_fn(torch.einsum("Necd,edf->Necf", xe, w_in))
    ye = torch.einsum("Necf,efd->Necd", h, w_out)                     # expert FFN
    yt = torch.einsum("Necd,Ngec->Ngd", ye.to(torch.float32), comb)

    # load-balancing aux loss (Switch): E * Σ_e f_e · P_e, from these means
    dens = onehot.sum(2).to(torch.float32).mean((0, 1))
    return yt.reshape(b, s, d), dens, probs.mean((0, 1))


def _moe_on_mesh(x, router, ws, *, g: int, top_k: int, **kw):
    """The block on each rank's shards. Tokens keep their batch shards when
    each shard holds whole routing groups, else every rank routes all of
    them (the groups and the capacity are the unsharded block's); the
    router is gathered; over "model" each rank holds E/model experts or
    d_ff/model of each expert, and the output's sum over "model" stays
    pending. Routing runs on plain tensors: DTensor flattens the sharded
    dispatch dims in its einsums, which some of its versions refuse."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    e = router.shape[1]
    local_t = x.shape[0] * x.shape[1] // int(np.prod([mesh.size(i) for i in mesh_dims(x, 0)]))
    batch = [i for i in mesh_dims(x, 0) if names[i] != "model"] if local_t % g == 0 else []
    model = [i for i, n in enumerate(names) if n == "model"]
    m = int(np.prod([mesh.size(i) for i in model]))
    ep = e % m == 0
    f = ws[0].shape[2]
    if not ep and f % m:
        model, m = [], 1        # neither splits: every "model" rank runs it all

    def pl(on_model):
        return [Shard(0) if i in batch else on_model if i in model else Replicate()
                for i in range(mesh.ndim)]

    rep = pl(Replicate())
    w_pl = [pl(Shard(0)) if ep else pl(Shard(2)),          # w_in [E, D, F]
            pl(Shard(0)) if ep else pl(Shard(1))]           # w_out [E, F, D]
    if len(ws) == 3:
        w_pl.append(w_pl[0])                                # w_gate as w_in
    w_pl = [[Replicate() if i in batch else p for i, p in enumerate(q)] for q in w_pl]
    router_pl = [Replicate()] * mesh.ndim
    e0 = shard_offset((e,), mesh, [Shard(0) if i in model and ep else Replicate()
                                   for i in range(mesh.ndim)])[1][0]
    # the routing statistics are the same on every "model" rank: each
    # holds 1/m of them, so their gradient, summed over "model" with the
    # experts' parts, counts them once
    stat_pl = pl(Partial("sum"))
    stat_pl = [Partial("avg") if i in batch else p for i, p in enumerate(stat_pl)]

    def local(xl, rl, *wl):
        yl, dl, pml = _moe_local(xl, rl, *wl, g=g, top_k=top_k, e0=e0 if ep else 0, **kw)
        return yl, dl / m, pml / m

    y, dens, pmean = local_region(local, (x, router, *ws), (rep, router_pl, *w_pl),
                                  (pl(Partial("sum")), stat_pl, stat_pl))
    # the experts' parts summed in f32 before the cast, as unsharded; the
    # unsharded block's means, then its aux
    y = y.redistribute(mesh, rep).to(x.dtype)
    dens, pmean = replicate(dens), replicate(pmean)
    return y, e * torch.sum(dens * pmean)
