"""MLP-B (paper §6.3): BN→FC→ReLU ×3 + classifier head on the 16 stats
features, and its fully fused Pegasus form (port of ``repro.nets.mlp``).

Fusion layout (Basic Primitive Fusion, Fig. 5 ①): each deployed bank i is
indexed by layer i-1's PRE-activation and folds ``[ReLU →] BN-affine → FC``
into its LUT rows, so a bank is K lookups + a SumReduce and nothing else.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.amm import PegasusLinear, init_pegasus_linear
from repro_torch.core.finetune import refine
from repro_torch.device import resolve_device
from repro_torch.engine import plan_for

from .common import train_classifier

__all__ = ["MLPB", "init_mlp", "mlp_apply", "train_mlp", "pegasusify_mlp",
           "pegasus_mlp_apply"]

HIDDEN = 32


@dataclasses.dataclass
class MLPB:
    """Dense teacher + feature-normalization constants (tensors on one
    device)."""

    params: dict
    mu: torch.Tensor
    sigma: torch.Tensor
    num_classes: int


def init_mlp(in_dim: int, num_classes: int, hidden: int = HIDDEN, seed: int = 0,
             device: str | torch.device = "cuda") -> dict:
    """Random teacher weights from a CPU ``torch.Generator`` seeded by
    ``seed`` (the same values on every device)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    dims = [in_dim, hidden, hidden, hidden]
    params = {}
    for i in range(3):
        params[f"w{i}"] = torch.randn(dims[i], dims[i + 1], generator=gen) / np.sqrt(dims[i])
        params[f"b{i}"] = torch.zeros(dims[i + 1])
        params[f"gamma{i}"] = torch.ones(dims[i])
        params[f"beta{i}"] = torch.zeros(dims[i])
    params["w_out"] = torch.randn(hidden, num_classes, generator=gen) / np.sqrt(hidden)
    params["b_out"] = torch.zeros(num_classes)
    return {k: v.to(dev) for k, v in params.items()}


def _hidden(p: dict, x: torch.Tensor, mu, sigma) -> list[torch.Tensor]:
    """The three FC pre-activations."""
    h = (x.to(torch.float32) - mu) / sigma          # dataset-stat normalization
    pres = []
    for i in range(3):
        h = p[f"gamma{i}"] * h + p[f"beta{i}"]      # BN affine (folded)
        h = h @ p[f"w{i}"] + p[f"b{i}"]             # FC
        pres.append(h)
        h = torch.relu(h)
    return pres


def mlp_apply(bundle_or_params, x: torch.Tensor, mu=None, sigma=None) -> torch.Tensor:
    """Forward. Accepts (params, mu, sigma) or an MLPB bundle."""
    if isinstance(bundle_or_params, MLPB):
        p, mu, sigma = bundle_or_params.params, bundle_or_params.mu, bundle_or_params.sigma
    else:
        p = bundle_or_params
    return torch.relu(_hidden(p, x, mu, sigma)[-1]) @ p["w_out"] + p["b_out"]


def train_mlp(x: np.ndarray, y: np.ndarray, num_classes: int, *, steps: int = 800,
              seed: int = 0, device: str | torch.device = "cuda") -> MLPB:
    dev = resolve_device(device)
    mu = torch.as_tensor(x.astype(np.float32).mean(0), device=dev)
    sigma = torch.as_tensor(x.astype(np.float32).std(0) + 1e-3, device=dev)
    params = init_mlp(x.shape[1], num_classes, seed=seed, device=dev)
    params = train_classifier(
        params, lambda p, xb: mlp_apply(p, xb, mu, sigma), x, y,
        steps=steps, seed=seed)
    return MLPB(params=params, mu=mu, sigma=sigma, num_classes=num_classes)


# ---------------------------------------------------------------------------
# Pegasusification: dense teacher → fused LUT banks
# ---------------------------------------------------------------------------


def _activations(bundle: MLPB, x: np.ndarray) -> list[np.ndarray]:
    """Per-bank calibration inputs: raw x, then each FC's pre-activation."""
    with torch.no_grad():
        xt = torch.as_tensor(np.asarray(x, np.float32), device=bundle.mu.device)
        pres = _hidden(bundle.params, xt, bundle.mu, bundle.sigma)
    return [np.asarray(x, np.float32)] + [h.cpu().numpy() for h in pres]


def pegasusify_mlp(
    bundle: MLPB,
    x_calib: np.ndarray,
    *,
    group_size: int = 2,
    depth: int = 6,
    refine_steps: int = 100,
) -> list[PegasusLinear]:
    """Lower the trained MLP to 4 fused Pegasus banks on the teacher's
    device (Fig. 5 ① result).

    Bank 0: idx on raw 8-bit stats; LUT = (norm·BN0 affine)(c) @ W0 + b0.
    Bank i: idx on pre-act i;       LUT = (BNi affine ∘ ReLU)(c) @ Wi + bi.
    Bank 3: classifier;             LUT = ReLU(c) @ W_out + b_out.

    ``refine_steps > 0`` then refines each bank (``core.finetune.refine``)
    against the next bank's calibration input, the last one against the
    teacher's logits.
    """
    p, mu, sigma = bundle.params, bundle.mu, bundle.sigma
    dev = mu.device
    acts = _activations(bundle, x_calib)
    np_p = {k: v.detach().cpu().numpy() for k, v in p.items()}

    def affine_fold(i, include_norm: bool):
        g, b = p[f"gamma{i}"].detach(), p[f"beta{i}"].detach()
        if include_norm:
            scale, shift = g / sigma, b - g * mu / sigma
        else:
            scale, shift = g, b

        def fn(c):  # c: [K, C, v] stacked centroids; slice per group
            k, _, v = c.shape
            return scale.reshape(k, 1, v) * c + shift.reshape(k, 1, v)

        return fn

    def bank(w, b, calib, act_fn):
        return init_pegasus_linear(w, b, calib, group_size=group_size, depth=depth,
                                   lut_bits=None, act_fn=act_fn, device=dev)

    layers = [bank(np_p["w0"], np_p["b0"], acts[0], affine_fold(0, include_norm=True))]
    for i in (1, 2):
        aff = affine_fold(i, include_norm=False)
        layers.append(bank(np_p[f"w{i}"], np_p[f"b{i}"], acts[i],
                           lambda c, aff=aff: aff(torch.clamp(c, min=0.0))))
    layers.append(bank(np_p["w_out"], np_p["b_out"], acts[3],
                       lambda c: torch.clamp(c, min=0.0)))

    if refine_steps:
        with torch.no_grad():
            logits = mlp_apply(bundle, torch.as_tensor(acts[0], device=dev))
        targets = acts[1:] + [logits]
        layers = [refine(layer, acts[i], targets[i], steps=refine_steps)
                  for i, layer in enumerate(layers)]
    return layers


def pegasus_mlp_apply(layers: list[PegasusLinear], x, *, backend: str = "gather",
                      device: str | torch.device = "cuda") -> torch.Tensor:
    """Run the fused bank stack via the execution engine (hard routing,
    deployment semantics)."""
    return plan_for(layers, device=device)(x, backend=backend)
