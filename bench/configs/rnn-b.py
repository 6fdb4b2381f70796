"""RNN-B (Pegasus, arXiv 2506.05779, section 6.3): the recurrent window over
the 8 packets of a flow, unrolled into 16 banks; its plain reference and
its work.

Step ``t`` of the window has an x-bank (2, 1, 256, 24) on the raw (length,
inter-packet delay) bytes of packet ``t``, and each step after the first an
h-bank (24, 1, 256, 24) on the previous step's pre-activation; an out-bank
(24, 1, 256, 3) on the last pre-activation gives the 3 class logits:

    h_0 = X_0(x_0),  h_t = X_t(x_t) + H_t(h_{t-1}) for t = 1..7,  logits = O(h_7).

The teacher computes ``h_t = tanh(W_x x_t / 255 + W_h tanh(h_{t-1}) + b)``;
in the Pegasus form the 1/255 scale lives in the x-tables and ``tanh`` of
the previous step is folded into the h- and out-tables (``pegasusify_rnn``
with ``act_fn=tanh``), so no ``tanh`` is computed here: the chain is the
bank sums alone. The biases sit where ``pegasusify_rnn`` puts them: on
x-bank 0, on every h-bank and on the out-bank. The program runs the window
as 16 dependent per-bank ``fuzzy_lut`` launches a batch, with the step
slices, the bias adds and the chain adds in torch, in the same graph.
"""

from __future__ import annotations

import numpy as np
import torch

from bench.banks import bank_forward, draw_bank, generator
from bench.ref.bounds import bank_bound
from bench.ref.synthetic_traffic import make_dataset


def flows(cfg: dict, seed: int) -> tuple[np.ndarray, ...]:
    """The seed's flows as the program's inputs: ``(seq [F, 8, 2] uint8,)``."""
    ds = make_dataset(cfg["dataset"], cfg["flows_per_class"], seed=seed)
    return (np.concatenate([ds.train["seq"], ds.val["seq"], ds.test["seq"]]),)


def draw(cfg: dict, calib: tuple[torch.Tensor, ...], seed: int) -> dict:
    """The 16 banks, drawn on ``calib``'s device from the seed, one generator
    stream a bank: x-bank ``t`` calibrated on packet ``t``'s raw bytes as
    float32 (0-255), h-bank ``t`` on the drawn chain's pre-activation of
    step ``t - 1``, the out-bank on that of step 7. ``leaves`` are the rows
    each bank's calibration reaches (for the bound)."""
    x = calib[0].to(torch.float32)
    dev = x.device
    (kx, vx, _, nx), (kh, vh, _, nh) = cfg["banks"]["x"], cfg["banks"]["h"]
    ko, vo, _, no = cfg["banks"]["out"]
    window, depth = cfg["window"], cfg["depth"]
    x_banks, h_banks, leaves = [], [], []
    h = None
    for t in range(window):
        xb, h_t, lv = draw_bank(x[:, t], kx, vx, depth, nx, generator(seed, t, dev))
        x_banks.append(xb)
        leaves.append(lv)
        if t:
            xb.bias = None                        # the step's bias sits in its h-bank
            hb, hh, lv = draw_bank(h, kh, vh, depth, nh, generator(seed, window + t - 1, dev))
            h_banks.append(hb)
            leaves.append(lv)
            h_t = bank_forward(xb, x[:, t]) + hh
        h = h_t
    out, _, lv = draw_bank(h, ko, vo, depth, no, generator(seed, 2 * window - 1, dev))
    leaves.append(lv)
    return {"x": x_banks, "h": h_banks, "out": out, "leaves": leaves}


def program_model(cfg: dict, drawn: dict):
    """The same arrays as the port's ``PegasusRNN``."""
    from repro_torch.core.amm import PegasusLinear
    from repro_torch.core.fuzzy_tree import FuzzyTree
    from repro_torch.nets.rnn import PegasusRNN

    def linear(b):
        return PegasusLinear(trees=FuzzyTree(b.features, b.thresholds, b.centroids),
                             lut=b.lut, bias=b.bias, group_size=b.v)

    return PegasusRNN(x_banks=[linear(b) for b in drawn["x"]],
                      h_banks=[linear(b) for b in drawn["h"]],
                      out_bank=linear(drawn["out"]), window=cfg["window"])


def reference(cfg: dict, drawn: dict, inputs: tuple[torch.Tensor, ...], *,
              dtype=torch.float32, int8: bool = False) -> torch.Tensor:
    """Logits ``[B, 3]`` (float32) of the flows ``inputs``, every step in
    ``dtype``, in the plan's order: each term a bank's sum, then the chain
    add."""
    x = inputs[0].to(dtype)
    h = bank_forward(drawn["x"][0], x[:, 0], dtype=dtype, int8=int8)
    for t in range(1, cfg["window"]):
        h = (bank_forward(drawn["x"][t], x[:, t], dtype=dtype, int8=int8)
             + bank_forward(drawn["h"][t - 1], h, dtype=dtype, int8=int8))
    return bank_forward(drawn["out"], h, dtype=dtype, int8=int8).to(torch.float32)


def work(cfg: dict, drawn: dict, flows: int, int8: bool = False) -> tuple[int, int]:
    """(bytes, operations) of the model on ``flows`` flows: the frozen bank
    count of each of the 16 banks at one row a flow, the tables read once
    and only the rows the pool's flows touch; plus the 7 chain adds of
    ``hidden`` values a flow."""
    meta = lambda *s: torch.empty(s, device="meta")
    geoms = ([cfg["banks"]["x"]] + [cfg["banks"]["h"]]) * (cfg["window"] - 1)
    geoms = [cfg["banks"]["x"], *geoms, cfg["banks"]["out"]]
    total_b = total_o = 0
    for (k, v, c, n), lv in zip(geoms, drawn["leaves"], strict=True):
        p = {"x": meta(flows, k, v), "features": meta(k, c - 1), "lut": meta(k, c, n)}
        nb, ops = bank_bound(p, lv.cpu(), q8=int8)
        total_b, total_o = total_b + nb, total_o + ops
    return total_b, total_o + flows * (cfg["window"] - 1) * cfg["hidden"]
