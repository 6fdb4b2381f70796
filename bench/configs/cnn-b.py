"""CNN-B (Pegasus, arXiv 2506.05779, section 6.3, Basic Fusion): a conv over
the 8 packets of a flow lowered to one window bank, an average pool and a
two-bank head; its plain reference and its work.

Window ``p`` (p = 0..5) of a flow is the raw (length, inter-packet delay)
bytes of packets ``p..p+2``, 6 values. The window bank (1, 6, 4096, 16)
maps each window to its 16 conv channels in one lookup (one group, depth 12;
the teacher's ``relu(c / 255 @ W + b)`` is folded into its rows, so no
ReLU is computed here and the bank has no bias); the 6 windows' rows are
averaged, and the head banks ``h`` (16, 1, 256, 24) and ``out`` (24, 1,
256, 3), each with a bias, give the 3 class logits:

    logits = out(h(mean over p of window(x_p))).

The program runs the window bank as one per-bank ``fuzzy_lut`` launch at 6
rows a flow (the windows cut by a gather on the device), the mean in torch,
and the head pair fused into one ``fuzzy_lut_stack`` launch, in one graph.
"""

from __future__ import annotations

import numpy as np
import torch

from bench.banks import Bank, bank_forward, draw_bank, draw_trees, generator
from bench.ref.bounds import bank_bound, stack_bound
from bench.ref.synthetic_traffic import make_dataset


def flows(cfg: dict, seed: int) -> tuple[np.ndarray, ...]:
    """The seed's flows as the program's inputs: ``(seq [F, 8, 2] uint8,)``."""
    ds = make_dataset(cfg["dataset"], cfg["flows_per_class"], seed=seed)
    return (np.concatenate([ds.train["seq"], ds.val["seq"], ds.test["seq"]]),)


def windows(seq: torch.Tensor, kernel: int, dtype=torch.float32) -> torch.Tensor:
    """``[B·P, kernel·2]``: window ``p`` of each flow holds the (length,
    delay) bytes of packets ``p..p + kernel - 1`` in packet order, the
    windows of a flow in ascending ``p``."""
    b, w, f = seq.shape
    x = seq.to(dtype)
    return torch.stack([x[:, p:p + kernel].reshape(b, kernel * f)
                        for p in range(w - kernel + 1)], dim=1).reshape(-1, kernel * f)


def _pool(cfg: dict, window: Bank, seq: torch.Tensor, dtype,
          int8: bool = False) -> torch.Tensor:
    """The mean of each flow's window-bank rows, ``[B, channels]``."""
    rows = bank_forward(window, windows(seq, cfg["conv_kernel"], dtype), dtype=dtype,
                        int8=int8)
    return rows.reshape(seq.shape[0], cfg["pool_windows"], -1).mean(dim=1)


def draw(cfg: dict, calib: tuple[torch.Tensor, ...], seed: int) -> dict:
    """The window bank and both head banks, drawn on ``calib``'s device
    from the seed, one generator stream a bank: the window bank over the
    calibration flows' windows (raw bytes as float32), ``h`` over their
    pooled window rows, ``out`` over ``h``'s output. ``leaves`` are the rows
    each bank's calibration reaches (for the bound)."""
    seq = calib[0]
    dev = seq.device
    (kw, vw, cw, nw), (kh, vh, ch, nh) = cfg["banks"]["window"], cfg["banks"]["h"]
    ko, vo, co, no = cfg["banks"]["out"]
    win = windows(seq, cfg["conv_kernel"])
    gen = generator(seed, 0, dev)
    features, thresholds, centroids, lv_w = draw_trees(
        win.reshape(-1, kw, vw), cw.bit_length() - 1, gen)
    lut = torch.randn((kw, cw, nw), generator=gen, device=dev).clamp(min=0.0)
    window = Bank(features, thresholds, centroids, lut, None)
    pooled = _pool(cfg, window, seq, torch.float32)
    h, hy, lv_h = draw_bank(pooled, kh, vh, ch.bit_length() - 1, nh, generator(seed, 1, dev))
    out, _, lv_o = draw_bank(hy, ko, vo, co.bit_length() - 1, no, generator(seed, 2, dev))
    return {"window": window, "h": h, "out": out, "leaves": [lv_w, lv_h, lv_o]}


def program_model(cfg: dict, drawn: dict):
    """The same arrays as the port's ``PegasusCNN`` (CNN-B: not NAM)."""
    from repro_torch.core.amm import PegasusLinear
    from repro_torch.core.fuzzy_tree import FuzzyTree
    from repro_torch.nets.cnn import PegasusCNN

    def linear(b: Bank):
        return PegasusLinear(trees=FuzzyTree(b.features, b.thresholds, b.centroids),
                             lut=b.lut, bias=b.bias, group_size=b.v)

    return PegasusCNN(window_bank=linear(drawn["window"]),
                      head_banks=[linear(drawn["h"]), linear(drawn["out"])],
                      out_bias=None, nam=False, pool_windows=cfg["pool_windows"])


def reference(cfg: dict, drawn: dict, inputs: tuple[torch.Tensor, ...], *,
              dtype=torch.float32, int8: bool = False) -> torch.Tensor:
    """Logits ``[B, 3]`` (float32) of the flows ``inputs``, every step in
    ``dtype``, in the plan's order: the window bank's rows, their mean over
    the 6 windows, then ``h`` and ``out``, each a sum in ascending k plus
    its bias."""
    pooled = _pool(cfg, drawn["window"], inputs[0], dtype, int8)
    h = bank_forward(drawn["h"], pooled, dtype=dtype, int8=int8)
    return bank_forward(drawn["out"], h, dtype=dtype, int8=int8).to(torch.float32)


def _meta(*shape) -> torch.Tensor:
    return torch.empty(shape, device="meta")


def _window_bound(cfg: dict, flows: int, leaves: torch.Tensor, int8: bool) -> tuple[int, int]:
    kw, vw, cw, nw = cfg["banks"]["window"]
    p = {"x": _meta(flows * cfg["pool_windows"], kw, vw), "features": _meta(kw, cw - 1),
         "lut": _meta(kw, cw, nw)}
    return bank_bound(p, leaves, q8=int8)


def window_bank_work(cfg: dict, flows: int) -> tuple[int, int]:
    """(bytes, operations) of the window bank alone on ``flows`` flows, at
    6 rows a flow, its trees and its whole table counted once (the
    ``window_bank_roofline`` reader's least time)."""
    c = cfg["banks"]["window"][2]
    return _window_bound(cfg, flows, torch.arange(c)[:, None], False)


def work(cfg: dict, drawn: dict, flows: int, int8: bool = False) -> tuple[int, int]:
    """(bytes, operations) of the model on ``flows`` flows: the frozen bank
    count of the window bank at 6 rows a flow and the frozen stack count of
    the head pair as the plan fuses it, the tables read once and only the
    rows the pool's flows touch; plus the pool's 6 × 16 adds a flow."""
    wb, wo = _window_bound(cfg, flows, drawn["leaves"][0].cpu(), int8)
    (kh, vh, c, nh), (ko, _, _, no) = cfg["banks"]["h"], cfg["banks"]["out"]
    ks, kmax, nmax = (kh, ko), max(kh, ko), max(nh, no)
    lv_h, lv_o = (lv.cpu() for lv in drawn["leaves"][1:])
    leaves = torch.zeros((2, lv_h.shape[0], kmax), dtype=torch.long)
    leaves[0, :, :kh], leaves[1, :, :ko] = lv_h, lv_o
    p = {"x": _meta(flows, kh, vh), "features": _meta(2, kmax, c - 1),
         "lut": _meta(2, kmax, c, nmax)}
    sb, so = stack_bound(p, leaves, ks, no, q8=int8)
    rows = flows * cfg["pool_windows"]
    return wb + sb, wo + so + rows * cfg["banks"]["window"][3]
