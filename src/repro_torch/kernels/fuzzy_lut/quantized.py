"""int8-LUT instances of the fuzzy-LUT kernels (port of
``repro.kernels.fuzzy_lut.quantized``).

LUT rows are stored int8 with one f32 scale per partition group:
``y = Σ_k s_k · LUT8[k, leaf_k]``. The kernels are the int8 template
instances of the same CUDA sources as the f32 ones; each term is
``float(q) * s_k`` rounded on its own, bit-equal to the plain version.
"""

from __future__ import annotations

import torch

from .kernel import (
    _bank_launch, _bank_plain, _check_bank, _check_stack, _stack_launch,
    _stack_plain,
)

__all__ = ["quantize_lut_int8", "fuzzy_lut_q8", "fuzzy_lut_q8_plain",
           "fuzzy_lut_stack_q8", "fuzzy_lut_stack_q8_plain"]


def quantize_lut_int8(lut: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-group symmetric int8 quantization. ``[K,C,N]`` → (int8 ``[K,C,N]``,
    f32 ``[K]``); rounds half to even, as the reference."""
    lut = lut.to(torch.float32)
    amax = lut.abs().amax(dim=(1, 2))
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(lut / scale[:, None, None]), -127, 127)
    return q.to(torch.int8), scale


def fuzzy_lut_q8_plain(x, features, thresholds, lut_q8, scales):
    """Plain version of the per-bank int8 kernel: ``(y [T,N], leaves [T,K])``."""
    return _bank_plain(x, features, thresholds, lut_q8, scales)


def fuzzy_lut_q8(x: torch.Tensor, features: torch.Tensor,
                 thresholds: torch.Tensor, lut_q8: torch.Tensor,
                 scales: torch.Tensor, *, return_leaves: bool = False):
    """``y = Σ_k s_k · lut_q8[k, leaf_k]`` (no bias): the contract of
    :func:`repro_torch.kernels.fuzzy_lut.kernel.fuzzy_lut` with an int8
    ``lut_q8 [K, C, N]`` and f32 ``scales [K]``."""
    depth = _check_bank("fuzzy_lut_q8", x, features, thresholds, lut_q8,
                        torch.int8, scales)
    if x.device.type == "cpu":
        y, leaves = fuzzy_lut_q8_plain(x, features, thresholds, lut_q8, scales)
        return (y, leaves.to(torch.int32)) if return_leaves else y
    return _bank_launch("fuzzy_lut_q8", x, features, thresholds, lut_q8,
                        scales, depth, return_leaves)


def fuzzy_lut_stack_q8_plain(x, features, thresholds, lut_q8, scales, bias,
                             ks, n_out):
    """Plain version of the stacked int8 kernel:
    ``(y [T, n_out], leaves [L, T, Kmax])``."""
    return _stack_plain(x, features, thresholds, lut_q8, bias, ks, n_out, scales)


def fuzzy_lut_stack_q8(x: torch.Tensor, features: torch.Tensor,
                       thresholds: torch.Tensor, lut_q8: torch.Tensor,
                       scales: torch.Tensor, bias: torch.Tensor, *,
                       ks: tuple[int, ...], n_out: int,
                       return_leaves: bool = False):
    """int8 stacked kernel: the contract of
    :func:`repro_torch.kernels.fuzzy_lut.kernel.fuzzy_lut_stack` with an int8
    ``lut_q8 [L, Kmax, C, Nmax]`` and f32 ``scales [L, Kmax]``."""
    ks = tuple(int(k) for k in ks)
    depth = _check_stack("fuzzy_lut_stack_q8", x, features, thresholds, lut_q8,
                         torch.int8, bias, ks, n_out, scales)
    if x.device.type == "cpu":
        y, leaves = fuzzy_lut_stack_q8_plain(x, features, thresholds, lut_q8,
                                             scales, bias, ks, n_out)
        return (y, leaves.to(torch.int32)) if return_leaves else y
    return _stack_launch("fuzzy_lut_stack_q8", x, features, thresholds, lut_q8,
                         bias, scales, ks, n_out, depth, return_leaves)
