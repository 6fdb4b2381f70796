"""Carry weights and state into the port from numpy arrays.

The port never sees another framework's types: a caller turns its objects
into numpy (``np.asarray(layer.lut)`` and so on) and passes the arrays in.
The tests use this to run banks and teachers built by the JAX reference
through the port.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.amm import PegasusLinear
from repro_torch.core.fuzzy_tree import FuzzyTree
from repro_torch.device import resolve_device
from repro_torch.kernels.fuzzy_lut.ops import check_features
from repro_torch.nets.mlp import MLPB

__all__ = ["pegasus_linear_from_arrays", "banks_from_arrays", "mlp_from_arrays"]


def _t(a, dtype, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=dtype), device=dev)


def pegasus_linear_from_arrays(features, thresholds, centroids, lut, bias,
                               group_size: int,
                               device: str | torch.device = "cuda") -> PegasusLinear:
    """A PegasusLinear from its arrays: features ``[K, I]``, thresholds
    ``[K, I]``, centroids ``[K, C, v]``, lut ``[K, C, N]``, bias ``[N]`` or
    None."""
    dev = resolve_device(device)
    trees = FuzzyTree(features=_t(features, np.int32, dev),
                      thresholds=_t(thresholds, np.float32, dev),
                      centroids=_t(centroids, np.float32, dev))
    lut_t = _t(lut, np.float32, dev)
    k, c, _ = lut_t.shape
    if trees.features.shape != (k, c - 1) or trees.thresholds.shape != (k, c - 1):
        raise ValueError(f"trees {tuple(trees.features.shape)} do not fit a "
                         f"LUT of shape {tuple(lut_t.shape)}")
    check_features(trees.features, group_size)
    return PegasusLinear(trees=trees, lut=lut_t,
                         bias=None if bias is None else _t(bias, np.float32, dev),
                         group_size=int(group_size))


def banks_from_arrays(banks: list[dict],
                      device: str | torch.device = "cuda") -> list[PegasusLinear]:
    """A bank list from dicts holding the keyword arguments of
    :func:`pegasus_linear_from_arrays` (without ``device``)."""
    return [pegasus_linear_from_arrays(**b, device=device) for b in banks]


def mlp_from_arrays(params: dict, mu, sigma, num_classes: int,
                    device: str | torch.device = "cuda") -> MLPB:
    """An MLP-B teacher from its parameter arrays and normalization."""
    dev = resolve_device(device)
    return MLPB(params={k: _t(v, np.float32, dev) for k, v in params.items()},
                mu=_t(mu, np.float32, dev), sigma=_t(sigma, np.float32, dev),
                num_classes=int(num_classes))
