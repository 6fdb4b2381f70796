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
    """Returns (output [B,S,D], aux_loss scalar)."""
    b, s, d = x.shape
    e = p.router.shape[1]
    t = b * s
    g = min(group_size, t)
    if t % g:
        raise ValueError(f"{t} tokens do not split into groups of {g}")
    ng = t // g
    xt = x.reshape(ng, g, d)

    logits = xt.to(torch.float32) @ p.router                           # [G, g, E]
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

    eoh = onehot.to(torch.float32)
    disp = (eoh.to(x.dtype)[..., None] * pos_oh.to(x.dtype)[..., None, :]
            * keep[..., None, None].to(x.dtype)).sum(2)                # [G, g, E, C]
    comb = (eoh[..., None] * pos_oh.to(torch.float32)[..., None, :]
            * (gate_vals * keep.to(torch.float32))[..., None, None]).sum(2)

    xe = torch.einsum("Ngd,Ngec->Necd", xt, disp)
    act_fn = activation(act)
    if "w_gate" in p:
        h = act_fn(torch.einsum("Necd,edf->Necf", xe, p.w_gate)) * torch.einsum(
            "Necd,edf->Necf", xe, p.w_in)
    else:
        h = act_fn(torch.einsum("Necd,edf->Necf", xe, p.w_in))
    ye = torch.einsum("Necf,efd->Necd", h, p.w_out)                   # expert FFN
    yt = torch.einsum("Necd,Ngec->Ngd", ye.to(torch.float32), comb)

    # load-balancing aux loss (Switch): E * Σ_e f_e · P_e
    dens = onehot.sum(2).to(torch.float32).mean((0, 1))
    aux = e * torch.sum(dens * probs.mean((0, 1)))
    return yt.reshape(b, s, d).to(x.dtype), aux
