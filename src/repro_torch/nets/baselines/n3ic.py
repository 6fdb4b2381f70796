"""N3IC baseline (paper §2): fully binarized MLP — XNOR + popcount MatMul
(port of ``repro.nets.baselines.n3ic``).

Weights and activations are ±1; a dot product of ±1 vectors of length n
equals ``2·popcount(XNOR(a, b)) − n``, the form N3IC executes on a switch.
Training goes through straight-through estimators and evaluation through
the exact binary forward, so the reported accuracy is the deployment's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device

from ..common import train_classifier

__all__ = ["N3IC", "binarize", "init_n3ic", "train_n3ic", "n3ic_apply", "n3ic_model_bits"]

HIDDEN = 64  # binary nets need width to compensate — paper's N3IC is 24.4Kb


@dataclasses.dataclass
class N3IC:
    """Trained parameters and the input-binarization thresholds (tensors on
    one device)."""

    params: dict
    num_classes: int
    mu: torch.Tensor
    sigma: torch.Tensor


class _Binarize(torch.autograd.Function):
    """``sign`` with 0 → +1; the gradient passes where ``|x| ≤ 1`` (clipped
    straight-through)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.sign(x) + (x == 0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (x.abs() <= 1.0).to(g.dtype)


def binarize(x: torch.Tensor) -> torch.Tensor:
    return _Binarize.apply(x)


def init_n3ic(in_dim: int, num_classes: int, seed: int = 0,
              device: str | torch.device = "cuda") -> dict:
    """Random weights from a CPU ``torch.Generator`` seeded by ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    params = {
        "w0": torch.randn(in_dim, HIDDEN, generator=gen) / np.sqrt(in_dim),
        "w1": torch.randn(HIDDEN, HIDDEN, generator=gen) / np.sqrt(HIDDEN),
        "w2": torch.randn(HIDDEN, num_classes, generator=gen) / np.sqrt(HIDDEN),
    }
    dev = resolve_device(device)
    return {k: v.to(dev) for k, v in params.items()}


def n3ic_apply(bundle_or_params, x: torch.Tensor, mu=None, sigma=None) -> torch.Tensor:
    """Binary forward: popcount-equivalent ±1 matmuls, binary activations.

    Each input feature is thresholded at its training mean (N3IC's input
    bit vector). No BN or activation layers: N3IC supports none.
    """
    if isinstance(bundle_or_params, N3IC):
        p, mu, sigma = bundle_or_params.params, bundle_or_params.mu, bundle_or_params.sigma
    else:
        p = bundle_or_params
    xb = binarize((torch.as_tensor(x, device=mu.device).to(torch.float32) - mu) / sigma)
    h = binarize(xb @ binarize(p["w0"]))
    h = binarize(h @ binarize(p["w1"]))
    return h @ binarize(p["w2"])  # integer popcount scores as logits


def train_n3ic(x: np.ndarray, y: np.ndarray, num_classes: int, *, steps: int = 900,
               seed: int = 0, device: str | torch.device = "cuda") -> N3IC:
    dev = resolve_device(device)
    mu = torch.as_tensor(x.astype(np.float32).mean(0), device=dev)
    sigma = torch.as_tensor(x.astype(np.float32).std(0) + 1e-3, device=dev)
    params = init_n3ic(x.shape[1], num_classes, seed, device=dev)
    params = train_classifier(params, lambda p, xb: n3ic_apply(p, xb, mu, sigma), x, y,
                              steps=steps, lr=5e-3, weight_decay=0.0, seed=seed)
    return N3IC(params=params, num_classes=num_classes, mu=mu, sigma=sigma)


def n3ic_model_bits(m: N3IC) -> int:
    """1 bit per weight (the binary model the switch stores)."""
    return sum(int(w.numel()) for w in m.params.values())
