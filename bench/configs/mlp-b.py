"""MLP-B (Pegasus, arXiv 2506.05779, section 6.3): four fused banks over the
16 statistics of a flow window; its plain reference and its work.

Bank ``i`` (K, v, C, N) = (8, 2, 64, 32), (16, 2, 64, 32), (16, 2, 64, 32),
(16, 2, 64, 3) reads the previous bank's output (the first, the 16 stats as
float32) and the last gives the 3 class logits. The program serves the list
of banks as one fused stack (``fuse=True``): one ``fuzzy_lut_stack`` launch
per batch.
"""

from __future__ import annotations

import numpy as np
import torch

from bench.banks import bank_forward, draw_bank, generator
from bench.ref.bounds import stack_bound
from bench.ref.synthetic_traffic import make_dataset


def flows(cfg: dict, seed: int) -> tuple[np.ndarray, ...]:
    """The seed's flows as the program's inputs: ``(stats [F, 16] uint8,)``."""
    ds = make_dataset(cfg["dataset"], cfg["flows_per_class"], seed=seed)
    return (np.concatenate([ds.train["stats"], ds.val["stats"], ds.test["stats"]]),)


def draw(cfg: dict, calib: tuple[torch.Tensor, ...], seed: int) -> dict:
    """The banks, drawn on ``calib``'s device from the seed, each deeper bank
    calibrated on the previous one's outputs; ``leaves`` are the rows each
    bank's data reaches (for the bound)."""
    x = calib[0].to(torch.float32)
    banks, leaves = [], []
    for i, (k, v, c, n) in enumerate(cfg["banks"]):
        bank, x, lv = draw_bank(x, k, v, c.bit_length() - 1, n, generator(seed, i, x.device))
        banks.append(bank)
        leaves.append(lv)
    return {"banks": banks, "leaves": leaves}


def program_model(cfg: dict, drawn: dict):
    """The same arrays as the port's ``PegasusLinear`` list."""
    from repro_torch.core.amm import PegasusLinear
    from repro_torch.core.fuzzy_tree import FuzzyTree

    return [PegasusLinear(trees=FuzzyTree(b.features, b.thresholds, b.centroids),
                          lut=b.lut, bias=b.bias, group_size=b.v)
            for b in drawn["banks"]]


def reference(cfg: dict, drawn: dict, inputs: tuple[torch.Tensor, ...], *,
              dtype=torch.float32, int8: bool = False) -> torch.Tensor:
    """Logits ``[B, 3]`` (float32) of the flows ``inputs``, every bank in
    ``dtype``."""
    x = inputs[0]
    for bank in drawn["banks"]:
        x = bank_forward(bank, x, dtype=dtype, int8=int8)
    return x.to(torch.float32)


def work(cfg: dict, drawn: dict, flows: int, int8: bool = False) -> tuple[int, int]:
    """(bytes, operations) of the model on ``flows`` flows: the frozen stack
    count with the flows as one batch, the tables read once and only the
    rows the pool's flows touch."""
    ks = tuple(k for k, _, _, _ in cfg["banks"])
    v, c, n_out = cfg["group_size"], cfg["banks"][0][2], cfg["classes"]
    kmax, nmax = max(ks), max(n for _, _, _, n in cfg["banks"])
    meta = lambda *s: torch.empty(s, device="meta")
    p = {"x": meta(flows, ks[0], v), "features": meta(len(ks), kmax, c - 1),
         "lut": meta(len(ks), kmax, c, nmax)}
    r = drawn["leaves"][0].shape[0]
    leaves = torch.zeros((len(ks), r, kmax), dtype=torch.long)
    for l, lv in enumerate(drawn["leaves"]):
        leaves[l, :, : lv.shape[1]] = lv.cpu()
    return stack_bound(p, leaves, ks, n_out, q8=int8)
