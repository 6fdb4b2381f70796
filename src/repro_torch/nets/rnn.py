"""RNN-B (paper §6.3): windowed recurrent classifier over (len, IPD) steps
(port of ``repro.nets.rnn``).

Follows BoS's *windowed* design: the switch unrolls all W time steps in the
pipeline (no hidden-state write-back); Pegasus upgrades it from binary to
fixed-point with fuzzy-matched tables.

Dense teacher:  h_t = tanh(Emb(x_t) + h_{t-1} @ W_h + b),  logits = h_W @ W_o.
Pegasus form, per step: one table bank indexed on the RAW 2-byte step input
(exactly the Emb∘proj fusion — Embedding Lookup IS a Map) plus one bank
indexed on h_{t-1}; their SumReduce feeds tanh, which folds into the NEXT
step's tables (Basic Fusion). Final classifier bank folds tanh → W_o.
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

__all__ = ["RNNB", "PegasusRNN", "init_rnn", "train_rnn", "rnn_apply", "pegasusify_rnn",
           "pegasus_rnn_apply"]

HIDDEN = 24


@dataclasses.dataclass
class RNNB:
    params: dict
    num_classes: int
    window: int


def init_rnn(num_classes: int, hidden: int = HIDDEN, seed: int = 0,
             device: str | torch.device = "cuda") -> dict:
    """Random teacher weights from a CPU ``torch.Generator`` seeded by
    ``seed`` (the same values on every device)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params = {
        # Emb-as-projection of the 2 raw byte features (len, ipd)
        "w_x": torch.randn(2, hidden, generator=gen) / np.sqrt(2.0),
        "w_h": torch.randn(hidden, hidden, generator=gen) / np.sqrt(hidden),
        "b": torch.zeros(hidden),
        "w_o": torch.randn(hidden, num_classes, generator=gen) / np.sqrt(hidden),
        "b_o": torch.zeros(num_classes),
    }
    return {k: v.to(dev) for k, v in params.items()}


def _pres(p: dict, x: torch.Tensor) -> list[torch.Tensor]:
    """Each step's pre-activation ``x_t @ W_x + h_{t-1} @ W_h + b``."""
    xf = x.to(torch.float32) / 255.0
    h = torch.zeros((xf.shape[0], HIDDEN), device=xf.device)
    pres = []
    for t in range(xf.shape[1]):
        pre = xf[:, t] @ p["w_x"] + h @ p["w_h"] + p["b"]
        pres.append(pre)
        h = torch.tanh(pre)
    return pres


def rnn_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: [B, W, 2] uint8 → logits. Normalizes bytes to [0,1] internally."""
    return torch.tanh(_pres(p, x)[-1]) @ p["w_o"] + p["b_o"]


def train_rnn(x: np.ndarray, y: np.ndarray, num_classes: int, *, steps: int = 900,
              seed: int = 0, device: str | torch.device = "cuda") -> RNNB:
    params = init_rnn(num_classes, seed=seed, device=device)
    params = train_classifier(params, rnn_apply, x, y, steps=steps, lr=2e-3, seed=seed)
    return RNNB(params=params, num_classes=num_classes, window=x.shape[1])


# ---------------------------------------------------------------------------
# Pegasusification
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PegasusRNN:
    """Per-step table banks. Step t's recurrent bank folds tanh of h_pre."""

    x_banks: list[PegasusLinear]   # one per step, indexed on raw (len, ipd)
    h_banks: list[PegasusLinear]   # steps 1..W-1, indexed on h_pre_{t-1}
    out_bank: PegasusLinear        # classifier, indexed on h_pre_{W-1}
    window: int


def pegasusify_rnn(
    bundle: RNNB,
    x_calib: np.ndarray,
    *,
    depth: int = 8,
    h_group: int = 1,
    x_group: int = 1,
    refine_steps: int = 0,
) -> PegasusRNN:
    """Lower the trained RNN to per-step banks on the teacher's device.

    ``refine_steps > 0`` refines each h-bank against the teacher's next
    pre-activation less the step input's share, ``pre_t - x_t @ W_x/255``.
    """
    p = bundle.params
    dev = p["w_x"].device
    np_p = {k: v.detach().cpu().numpy() for k, v in p.items()}
    with torch.no_grad():
        pres = [h.cpu().numpy() for h in _pres(p, torch.as_tensor(x_calib, device=dev))]
    scale = 1.0 / 255.0

    def bank(w, b, calib, group, act_fn=None):
        return init_pegasus_linear(w, b, calib, group_size=group, depth=depth,
                                   lut_bits=None, act_fn=act_fn, device=dev)

    x_banks, h_banks = [], []
    for t in range(bundle.window):
        # the raw step input: Emb-style Map, the step's bias in bank 0 only
        x_banks.append(bank(np_p["w_x"] * scale, np_p["b"] if t == 0 else None,
                            x_calib[:, t].astype(np.float32), x_group))
        if t > 0:
            # recurrent bank: index on h_pre_{t-1}, fold tanh + bias
            h_banks.append(bank(np_p["w_h"], np_p["b"], pres[t - 1], h_group, torch.tanh))
    out_bank = bank(np_p["w_o"], np_p["b_o"], pres[-1], h_group, torch.tanh)

    if refine_steps:
        w_x = p["w_x"].detach() * scale
        for t in range(1, bundle.window):
            x_t = torch.as_tensor(x_calib[:, t], dtype=torch.float32, device=dev)
            with torch.no_grad():
                tgt = torch.as_tensor(pres[t], device=dev) - x_t @ w_x
            h_banks[t - 1] = refine(h_banks[t - 1], pres[t - 1], tgt, steps=refine_steps)
    return PegasusRNN(x_banks=x_banks, h_banks=h_banks, out_bank=out_bank,
                      window=bundle.window)


def pegasus_rnn_apply(peg: PegasusRNN, x, *, backend: str = "gather",
                      device: str | torch.device = "cuda") -> torch.Tensor:
    """Hard-routed deployment forward via the engine. x: [B, W, 2] uint8."""
    return plan_for(peg, device=device)(x, backend=backend)
