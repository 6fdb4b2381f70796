"""AdamW + cosine schedule + global-norm clipping, written out on tensors
(port of ``repro.train.optimizer``; not ``torch.optim``, so the update
rule can be held term by term against the reference).

Parameters, gradients and moments are dicts of tensors with equal keys.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
           "clip_by_global_norm"]


class AdamWState(NamedTuple):
    step: torch.Tensor        # scalar int32
    m: dict
    v: dict


def adamw_init(params: dict) -> AdamWState:
    device = next(iter(params.values())).device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m={k: torch.zeros_like(p) for k, p in params.items()},
        v={k: torch.zeros_like(p) for k, p in params.items()},
    )


def clip_by_global_norm(grads: dict, max_norm: float) -> tuple[dict, torch.Tensor]:
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                           for g in grads.values()))
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    return {k: g * scale for k, g in grads.items()}, gnorm


@torch.no_grad()
def adamw_update(
    params: dict,
    grads: dict,
    state: AdamWState,
    *,
    lr: torch.Tensor | float,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    max_grad_norm: float | None = 1.0,
) -> tuple[dict, AdamWState, torch.Tensor]:
    """One AdamW step (decoupled decay). Returns (new_params, new_state,
    grad_norm); the inputs are left unchanged."""
    grads, gnorm = clip_by_global_norm(
        grads, math.inf if max_grad_norm is None else max_grad_norm)
    step = state.step + 1
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=stepf.device), stepf)

    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k].to(torch.float32)
        m2 = b1 * state.m[k] + (1 - b1) * g
        v2 = b2 * state.v[k] + (1 - b2) * g * g
        delta = (m2 / b1c) / (torch.sqrt(v2 / b2c) + eps) + weight_decay * p.to(torch.float32)
        new_p[k] = (p.to(torch.float32) - lr * delta).to(p.dtype)
        new_m[k], new_v[k] = m2, v2
    return new_p, AdamWState(step=step, m=new_m, v=new_v), gnorm


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1) -> Callable[[torch.Tensor], torch.Tensor]:
    def lr_at(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = base_lr * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                           0.0, 1.0)
        cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)

    return lr_at
