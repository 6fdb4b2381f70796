"""Backprop refinement of fuzzy-tree parameters (paper §4.4
"Backpropagation"); port of ``repro.core.finetune``.

The hard clustering tree is relaxed into sigmoid-temperature routing
(:func:`repro_torch.core.fuzzy_tree.soft_index_stacked`), so thresholds,
LUT and bias become differentiable. ``refine`` minimizes the distillation
MSE between the layer's soft output and the teacher's over calibration
data, annealing the temperature so the soft routing converges to the hard
one that is deployed. It runs offline, on the layer's device, never on the
serving path.
"""

from __future__ import annotations

import torch

from .amm import PegasusLinear, apply_gather, apply_soft
from .fuzzy_tree import FuzzyTree

__all__ = ["refine", "hard_mse"]


def _adam_update(g, m, v, step, lr, b1=0.9, b2=0.999, eps=1e-8):
    """One bias-corrected Adam step: ``(update, m, v)``."""
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * (g * g)
    mhat = m / (1 - b1**step)
    vhat = v / (1 - b2**step)
    return lr * mhat / (torch.sqrt(vhat) + eps), m, v


def _batch_indices(n: int, size: int, steps: int, seed: int,
                   device: torch.device) -> torch.Tensor:
    """Every step's minibatch, drawn with replacement: ``[steps, size]``
    row indices from a ``torch.Generator`` on ``device`` seeded by ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, n, (steps, size), generator=gen, device=device)


def refine(
    layer: PegasusLinear,
    x_calib,
    y_teacher,
    *,
    steps: int = 200,
    lr: float = 3e-3,
    temp_start: float = 0.5,
    temp_end: float = 0.05,
    batch_size: int = 512,
    seed: int = 0,
) -> PegasusLinear:
    """Fine-tune thresholds, LUT and bias against the teacher's output.

    Split features and centroids stay fixed. ``x_calib`` ``[S, D]`` and
    ``y_teacher`` ``[S, N]`` (tensors or numpy) move to the layer's
    device. Returns a new PegasusLinear whose hard forward better matches
    the teacher; its LUT keeps the input's dtype and is not snapped back
    to a fixed-point grid. A layer without a bias gets a refined one.
    """
    dev = layer.device
    x_calib = torch.as_tensor(x_calib, dtype=torch.float32, device=dev)
    y_teacher = torch.as_tensor(y_teacher, dtype=torch.float32, device=dev)
    params = {
        "thresholds": layer.trees.thresholds.detach().to(torch.float32).clone(),
        "lut": layer.lut.detach().to(torch.float32).clone(),
        "bias": (torch.zeros(layer.out_features, device=dev) if layer.bias is None
                 else layer.bias.detach().to(torch.float32).clone()),
    }
    feats, centroids = layer.trees.features, layer.trees.centroids
    gsize = layer.group_size

    def rebuild(p):
        return PegasusLinear(trees=FuzzyTree(feats, p["thresholds"], centroids),
                             lut=p["lut"], bias=p["bias"], group_size=gsize)

    n = x_calib.shape[0]
    batches = _batch_indices(n, min(batch_size, n), steps, seed, dev)
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v = {k: torch.zeros_like(v) for k, v in params.items()}
    for step in range(1, steps + 1):
        ix = batches[step - 1]
        temp = float(temp_start * (temp_end / temp_start) ** (step / steps))
        leaves = {k: p.requires_grad_(True) for k, p in params.items()}
        out = apply_soft(rebuild(leaves), x_calib[ix], temperature=temp)
        loss = torch.mean((out - y_teacher[ix]) ** 2)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            for (name, p), g in zip(leaves.items(), grads):
                upd, m[name], v[name] = _adam_update(g, m[name], v[name], step, lr)
                params[name] = p.detach() - upd

    return PegasusLinear(trees=FuzzyTree(feats, params["thresholds"], centroids),
                         lut=params["lut"].to(layer.lut.dtype), bias=params["bias"],
                         group_size=gsize)


def hard_mse(layer: PegasusLinear, x, y_teacher) -> float:
    """Deployment-form error: hard routing, as the kernels execute it."""
    dev = layer.device
    with torch.no_grad():
        y = apply_gather(layer, torch.as_tensor(x, dtype=torch.float32, device=dev))
        return float(torch.mean((y - torch.as_tensor(y_teacher, dtype=torch.float32,
                                                     device=dev)) ** 2))
