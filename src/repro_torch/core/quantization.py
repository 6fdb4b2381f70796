"""Adaptive fixed-point quantization (paper §4.4).

Port of ``repro.core.quantization``: the dataplane has no floats, so every
value crossing a table boundary is a fixed-point integer with a per-edge
binary point chosen from calibration data. ``fake_quant`` carries a
clipped straight-through gradient so that backprop refinement can
differentiate through it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["FixedPointSpec", "choose_qspec", "quantize", "dequantize",
           "fake_quant", "fake_quant_spec"]


@dataclasses.dataclass(frozen=True)
class FixedPointSpec:
    """Signed two's-complement fixed point: ``bits`` wide, ``frac_bits``
    fractional bits."""

    bits: int
    frac_bits: int

    @property
    def scale(self) -> float:
        return float(2.0**self.frac_bits)

    @property
    def qmin(self) -> int:
        return -(2 ** (self.bits - 1))

    @property
    def qmax(self) -> int:
        return 2 ** (self.bits - 1) - 1


def choose_qspec(calibration, bits: int = 16) -> FixedPointSpec:
    """Pick the binary point so max|x| of the calibration data fits."""
    cal = torch.as_tensor(calibration)
    amax = float(cal.abs().max()) if cal.numel() else 1.0
    amax = max(amax, 1e-8)
    int_bits = int(np.ceil(np.log2(amax + 1e-12))) + 1  # +1 for sign
    frac = bits - 1 - max(int_bits - 1, 0)
    frac = int(np.clip(frac, 0, bits - 1))
    return FixedPointSpec(bits=bits, frac_bits=frac)


def quantize(x: torch.Tensor, spec: FixedPointSpec) -> torch.Tensor:
    """Float → int32 codes (round half to even, as ``jnp.round``)."""
    q = torch.round(x * spec.scale)
    return torch.clamp(q, spec.qmin, spec.qmax).to(torch.int32)


def dequantize(q: torch.Tensor, spec: FixedPointSpec) -> torch.Tensor:
    return q.to(torch.float32) / spec.scale


class _FakeQuant(torch.autograd.Function):
    """Quantize-dequantize; the gradient passes where ``x·scale`` lies in
    ``[qmin, qmax]`` and is zero outside (clipped straight-through)."""

    @staticmethod
    def forward(ctx, x, scale, qmin, qmax):
        ctx.save_for_backward(x)
        ctx.bounds = (scale, qmin, qmax)
        return torch.clamp(torch.round(x * scale), qmin, qmax) / scale

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        scale, qmin, qmax = ctx.bounds
        inside = (x * scale >= qmin) & (x * scale <= qmax)
        return torch.where(inside, g, torch.zeros_like(g)), None, None, None


def fake_quant(x: torch.Tensor, scale: float, qmin: float, qmax: float) -> torch.Tensor:
    """Quantize-dequantize with a straight-through gradient."""
    return _FakeQuant.apply(x, scale, qmin, qmax)


def fake_quant_spec(x: torch.Tensor, spec: FixedPointSpec) -> torch.Tensor:
    """Quantize-dequantize onto the fixed-point grid of ``spec``."""
    return fake_quant(x, spec.scale, float(spec.qmin), float(spec.qmax))
