"""Pegasus-LM integration (port of ``repro.models.pegasus_layer``):
LUT-based approximate linear layers for serving.

Selected FFN matmuls of a trained model are replaced, at deployment, by
Partition → fuzzy-index → LUT-gather → SumReduce banks built from the
weights and a calibration pass. On the card the banks run through the
CUDA fuzzy-LUT kernels (``path="kernel"`` / ``"kernel_q8"``): matmul FLOPs
become comparisons and gathers, and the weight bytes become (C/v)·D·N LUT
bytes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.registry import ArchConfig
from repro_torch.core.amm import PegasusLinear, init_pegasus_linear, pegasus_linear_apply

from .layers import activation
from .transformer import FFN

__all__ = ["PegasusFFN", "pegasusify_ffn_layer", "pegasus_ffn_apply",
           "lut_bytes", "dense_ffn_bytes"]


@dataclasses.dataclass
class PegasusFFN:
    """LUT form of one (gated) FFN: in/gate/out banks."""

    w_in: PegasusLinear
    w_gate: PegasusLinear | None
    w_out: PegasusLinear
    act: str


def pegasusify_ffn_layer(
    cfg: ArchConfig,
    ffn_params: FFN,
    calib_x: np.ndarray,          # [S, d_model] representative activations
    *,
    group_size: int = 4,
    depth: int = 4,
    lut_dtype=torch.bfloat16,
) -> PegasusFFN:
    """Lower one layer's FFN weights to Pegasus banks on the FFN's device.
    The trees are fit in numpy on the host; the out bank is calibrated on
    the dense hidden activations."""
    dev = ffn_params.w_in.device
    act = activation(cfg.act)
    calib_x = np.asarray(calib_x, np.float32)
    w_in = ffn_params.w_in.detach().float()
    w_gate = ffn_params.w_gate.detach().float() if "w_gate" in ffn_params else None
    w_out = ffn_params.w_out.detach().float()

    def bank(w: torch.Tensor, calib: np.ndarray) -> PegasusLinear:
        return init_pegasus_linear(w.cpu().numpy(), None, calib, group_size=group_size,
                                   depth=depth, lut_bits=None, lut_dtype=lut_dtype,
                                   device=dev)

    in_bank = bank(w_in, calib_x)
    gate_bank = None if w_gate is None else bank(w_gate, calib_x)
    # calibrate the out bank on the hidden activations
    xc = torch.as_tensor(calib_x, device=dev)
    xin = xc @ w_in
    h = act(xc @ w_gate) * xin if w_gate is not None else act(xin)
    out_bank = bank(w_out, h.cpu().numpy())
    return PegasusFFN(w_in=in_bank, w_gate=gate_bank, w_out=out_bank, act=cfg.act)


def pegasus_ffn_apply(p: PegasusFFN, x: torch.Tensor, *, path: str = "onehot") -> torch.Tensor:
    """The FFN through its banks on ``path`` (any path of
    :func:`~repro_torch.core.amm.pegasus_linear_apply`). ``x: [..., D]``."""
    act = activation(p.act)
    xin = pegasus_linear_apply(p.w_in, x, path=path)
    if p.w_gate is not None:
        h = act(pegasus_linear_apply(p.w_gate, x, path=path)) * xin
    else:
        h = act(xin)
    return pegasus_linear_apply(p.w_out, h, path=path)


def lut_bytes(cfg: ArchConfig, *, group_size: int = 8, depth: int = 4,
              lut_dtype_bytes: int = 1) -> float:
    """Per-layer FFN LUT bytes: (D/v)·C·F·(…) per bank."""
    c = 2**depth
    n_banks = 3 if cfg.is_gated_ffn else 2
    per_in = cfg.d_model / group_size * c * cfg.d_ff * lut_dtype_bytes
    per_out = cfg.d_ff / group_size * c * cfg.d_model * lut_dtype_bytes
    return (n_banks - 1) * per_in + per_out


def dense_ffn_bytes(cfg: ArchConfig, dtype_bytes: int = 2) -> float:
    n_banks = 3 if cfg.is_gated_ffn else 2
    return n_banks * cfg.d_model * cfg.d_ff * dtype_bytes
