"""PegasusLinear-level entry points for the fuzzy-LUT kernels (port of
``repro.kernels.fuzzy_lut.ops``).

The kernels mask ragged edges themselves, so the static layout of a bank
is only its operands in the kernel's types: int32 features, f32
thresholds, the f32 or int8 LUT (+ scales), contiguous on the bank's
device. It is built once per layer and memoized (weakref-evicted with the
layer); the call path reshapes the activations and nothing else. The name
``padded_layout`` is kept from the reference, whose TPU kernel needed the
operands padded to block multiples.
"""

from __future__ import annotations

import weakref

import torch

from .kernel import fuzzy_lut
from .quantized import fuzzy_lut_q8, quantize_lut_int8

__all__ = ["fuzzy_lut_matmul", "fuzzy_lut_matmul_q8", "padded_layout",
           "quantized_lut_cached", "check_features", "LAYOUT_STATS",
           "QUANT_STATS"]

QUANT_STATS = {"quantize_calls": 0, "cache_hits": 0}
_Q8_MEMO: dict[int, tuple] = {}

LAYOUT_STATS = {"layout_builds": 0, "cache_hits": 0}
_LAYOUT_MEMO: dict[tuple, tuple] = {}


def check_features(features: torch.Tensor, group_size: int) -> None:
    """Raise unless every split feature id lies in ``[0, group_size)``: the
    CUDA kernels index activations with them unchecked."""
    if features.numel() and (int(features.min()) < 0
                             or int(features.max()) >= group_size):
        raise ValueError(f"split feature ids must lie in [0, {group_size})")


def quantized_lut_cached(layer) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 LUT, per-group f32 scales) for a PegasusLinear, memoized."""
    key = id(layer)
    entry = _Q8_MEMO.get(key)
    if entry is not None and entry[0]() is layer:
        QUANT_STATS["cache_hits"] += 1
        return entry[1], entry[2]
    lut_q8, scales = quantize_lut_int8(layer.lut)
    QUANT_STATS["quantize_calls"] += 1
    ref = weakref.ref(layer, lambda _ref, key=key: _Q8_MEMO.pop(key, None))
    _Q8_MEMO[key] = (ref, lut_q8, scales)
    return lut_q8, scales


def padded_layout(layer, *, quant: bool):
    """Kernel operands ``(features, thresholds, lut, scales)`` for one
    PegasusLinear, memoized; ``scales`` is None unless ``quant``."""
    key = (id(layer), quant)
    entry = _LAYOUT_MEMO.get(key)
    if entry is not None and entry[0]() is layer:
        LAYOUT_STATS["cache_hits"] += 1
        return entry[1]
    check_features(layer.trees.features, layer.group_size)
    feats = layer.trees.features.to(torch.int32).contiguous()
    thr = layer.trees.thresholds.to(torch.float32).contiguous()
    if quant:
        lut, scales = quantized_lut_cached(layer)
    else:
        lut, scales = layer.lut.to(torch.float32), None
    layout = (feats, thr, lut.contiguous(), scales)
    LAYOUT_STATS["layout_builds"] += 1
    ref = weakref.ref(layer, lambda _ref, key=key: _LAYOUT_MEMO.pop(key, None))
    _LAYOUT_MEMO[key] = (ref, layout)
    return layout


def _apply(layer, x, quant):
    k, v, n = layer.num_groups, layer.group_size, layer.out_features
    lead = x.shape[:-1]
    xg = x.reshape(-1, k, v).to(torch.float32).contiguous()
    feats, thr, lut, scales = padded_layout(layer, quant=quant)
    y = (fuzzy_lut_q8(xg, feats, thr, lut, scales) if quant
         else fuzzy_lut(xg, feats, thr, lut))
    if layer.bias is not None:
        y = y + layer.bias
    return y.reshape(*lead, n)


def fuzzy_lut_matmul(layer, x: torch.Tensor) -> torch.Tensor:
    """Apply a PegasusLinear through the f32 kernel. ``x: [..., D] → [..., N]``."""
    return _apply(layer, x, quant=False)


def fuzzy_lut_matmul_q8(layer, x: torch.Tensor) -> torch.Tensor:
    """Apply a PegasusLinear through the int8 kernel over its memoized
    int8 LUT (quantized once per layer)."""
    return _apply(layer, x, quant=True)
