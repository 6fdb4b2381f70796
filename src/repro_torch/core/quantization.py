"""Adaptive fixed-point quantization (paper §4.4), forward functions.

Port of ``repro.core.quantization``: the dataplane has no floats, so every
value crossing a table boundary is a fixed-point integer with a per-edge
binary point chosen from calibration data. The straight-through gradient
of the reference's ``fake_quant`` belongs to the refinement slice; here
``fake_quant_spec`` is the plain quantize-dequantize.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["FixedPointSpec", "choose_qspec", "quantize", "dequantize",
           "fake_quant_spec"]


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


def fake_quant_spec(x: torch.Tensor, spec: FixedPointSpec) -> torch.Tensor:
    """Quantize-dequantize onto the fixed-point grid of ``spec``."""
    return torch.clamp(torch.round(x * spec.scale), spec.qmin, spec.qmax) / spec.scale
