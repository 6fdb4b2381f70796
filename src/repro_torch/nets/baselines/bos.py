"""BoS baseline (paper §2): binary RNN via input→output bypass tables
(port of ``repro.nets.baselines.bos``).

BoS stores the whole map from (binary hidden state, binary step input) to
the next binary hidden state in dataplane tables: full precision inside
the recurrence, activations binarized at every table boundary, and only a
few input bits per step (the paper's 18-bit input scale; an n-bit key
needs 2^n entries). The binarized RNN trains with STE; its exact binary
forward is what the enumerated tables would produce.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device

from ..common import train_classifier
from .n3ic import binarize

__all__ = ["BoS", "init_bos", "train_bos", "bos_apply", "bos_table_entries"]

HIDDEN_BITS = 8        # binary hidden state width (paper's moderate config)
LEN_BITS = 2           # packet-length bucket bits per step
IPD_BITS = 1           # IPD bucket bits per step
WINDOW = 6             # 6 × 3 = 18-bit input scale, as in the paper


@dataclasses.dataclass
class BoS:
    params: dict
    num_classes: int


def _bucketize(x: torch.Tensor) -> torch.Tensor:
    """[B, W, 2] bytes → [B, WINDOW, LEN_BITS+IPD_BITS] ±1 bits."""
    xw = x[:, :WINDOW].to(torch.float32)
    len_q = torch.floor(xw[..., 0] / 64.0)                # 2 bits: 4 buckets
    ipd_q = torch.floor(xw[..., 1] / 128.0)               # 1 bit: 2 buckets
    bits = [torch.remainder(torch.floor(len_q / 2**b), 2) for b in range(LEN_BITS)]
    bits += [torch.remainder(torch.floor(ipd_q / 2**b), 2) for b in range(IPD_BITS)]
    return 2.0 * torch.stack(bits, dim=-1) - 1.0


def init_bos(num_classes: int, seed: int = 0, device: str | torch.device = "cuda") -> dict:
    """Random weights from a CPU ``torch.Generator`` seeded by ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    in_bits = LEN_BITS + IPD_BITS
    params = {
        "w_x": torch.randn(in_bits, HIDDEN_BITS, generator=gen) / np.sqrt(in_bits),
        "w_h": torch.randn(HIDDEN_BITS, HIDDEN_BITS, generator=gen) / np.sqrt(HIDDEN_BITS),
        "b": torch.zeros(HIDDEN_BITS),
        "w_o": torch.randn(HIDDEN_BITS, num_classes, generator=gen) / np.sqrt(HIDDEN_BITS),
    }
    dev = resolve_device(device)
    return {k: v.to(dev) for k, v in params.items()}


def bos_apply(p_or_bundle, x: torch.Tensor) -> torch.Tensor:
    """Binary-state recurrence: h is ±1 bits at every step (a table
    boundary), full precision inside a step."""
    p = p_or_bundle.params if isinstance(p_or_bundle, BoS) else p_or_bundle
    xb = _bucketize(torch.as_tensor(x, device=p["w_x"].device))   # [B, W, 3] ±1
    h = torch.ones((xb.shape[0], HIDDEN_BITS), device=xb.device)
    for t in range(WINDOW):
        h = binarize(xb[:, t] @ p["w_x"] + h @ p["w_h"] + p["b"])
    return h @ p["w_o"]


def train_bos(x: np.ndarray, y: np.ndarray, num_classes: int, *, steps: int = 900,
              seed: int = 0, device: str | torch.device = "cuda") -> BoS:
    params = init_bos(num_classes, seed, device=device)
    params = train_classifier(params, bos_apply, x, y, steps=steps, lr=5e-3,
                              weight_decay=0.0, seed=seed)
    return BoS(params=params, num_classes=num_classes)


def bos_table_entries() -> int:
    """Bypass-table enumeration: 2^(hidden+input) entries per step table."""
    return 2 ** (HIDDEN_BITS + LEN_BITS + IPD_BITS)
