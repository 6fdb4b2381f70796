"""Shared building blocks for the LM stack (port of ``repro.models.layers``):
norms, RoPE/M-RoPE, activations, init helpers, and :class:`Params`, the
module that holds one block's weights under the reference's key names.

Initialisation draws from a ``torch.Generator`` and puts every tensor on the
generator's device; bf16 weights / f32 accumulation by default, as the
reference.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

__all__ = ["Params", "rms_norm", "rope", "mrope_positions", "rope_mrope", "activation",
           "dense_init", "ones", "zeros"]


class Params(nn.Module):
    """The weights and sub-blocks of one block, read by attribute (``p.wq``)
    where the reference reads its parameter dict (``p["wq"]``).

    Tensors become parameters without gradients (the serving path needs
    none); modules and ``nn.ModuleList``s become sub-modules.
    """

    def __init__(self, **entries):
        super().__init__()
        for name, value in entries.items():
            if isinstance(value, nn.Module):
                self.add_module(name, value)
            else:
                self.register_parameter(name, nn.Parameter(value, requires_grad=False))

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.to(torch.float32)).to(dtype)


def _freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Split-halves rotation (not interleaved pairs), in f32."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4) -> torch.Tensor:
    """Rotary embedding. x: [B, S, H, hd]; positions: [B, S] or [S]."""
    ang = positions.to(torch.float32)[..., None] * _freqs(x.shape[-1], theta, x.device)
    # add the head axis once; leading axes broadcast ([S,1,hd/2] vs [B,S,H,hd/2])
    return _rotate(x, torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :])


def mrope_positions(positions: torch.Tensor) -> torch.Tensor:
    """Qwen2-VL M-RoPE stub: (t, h, w) position components, all three the
    text position stream (the modality frontend is a stub). Returns [3, ...]."""
    return torch.stack([positions, positions, positions], dim=0)


def rope_mrope(x: torch.Tensor, positions3: torch.Tensor, sections=(2, 1, 1),
               theta: float = 1e4) -> torch.Tensor:
    """Sectioned M-RoPE: head_dim/2 frequency slots split across (t,h,w)."""
    hd = x.shape[-1]
    half = hd // 2
    total = sum(sections)
    sizes = [half * s // total for s in sections]
    sizes[-1] = half - sum(sizes[:-1])
    # component index per frequency slot
    comp = torch.cat([torch.full((sz,), i, dtype=torch.long, device=x.device)
                      for i, sz in enumerate(sizes)])
    pos_per_slot = positions3.to(torch.float32)[comp].movedim(0, -1)   # [..., half]
    ang = pos_per_slot * _freqs(hd, theta, x.device)
    return _rotate(x, torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :])


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "sq_relu":  # Nemotron-4 squared ReLU
        return lambda x: torch.square(F.relu(x))
    if name == "relu":
        return F.relu
    raise ValueError(name)


def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.bfloat16) -> torch.Tensor:
    """Normal / sqrt(fan_in), drawn in f32 on ``gen``'s device."""
    fan_in = shape[in_axis]
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (w / np.sqrt(fan_in)).to(dtype)


def ones(gen: torch.Generator, *shape) -> torch.Tensor:
    return torch.ones(shape, dtype=torch.float32, device=gen.device)


def zeros(gen: torch.Generator, *shape, dtype=torch.float32) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=gen.device)
