"""CNN-L (Pegasus, arXiv 2506.05779, section 6.3): a two-level NAM over the 8
packets of a flow; its plain reference and its work.

Per packet, the 60 payload bytes then (length, inter-packet delay), 62 raw
byte values, go through ``bank1`` (62, 1, 256, 64) and ``bank2`` (64, 1, 256,
16); ``tanh`` of its output is indexed by one depth-8 tree over the 16-d
embedding (the per-packet fuzzy index the switch stores, section 7.3), and
the flow's logits are the sum over its 8 packets of ``logit_lut[index]``
([256, 3]) plus a bias. The program runs the two banks as per-bank
``fuzzy_lut`` launches at 8 rows per flow and the index and the sum in
torch.
"""

from __future__ import annotations

import numpy as np
import torch

from bench.banks import Bank, bank_forward, descend, draw_bank, draw_trees, generator
from bench.ref.bounds import bank_bound
from bench.ref.synthetic_traffic import make_dataset


def flows(cfg: dict, seed: int) -> tuple[np.ndarray, ...]:
    """The seed's flows as the program's inputs: ``(seq [F, 8, 2],
    payload [F, 8, 60])``, uint8."""
    ds = make_dataset(cfg["dataset"], cfg["flows_per_class"], seed=seed)
    return tuple(np.concatenate([ds.train[k], ds.val[k], ds.test[k]])
                 for k in ("seq", "bytes"))


def _packets(inputs, dtype) -> torch.Tensor:
    """``[B·8, 62]``: each packet's payload bytes, then its (length, delay)."""
    seq, payload = inputs
    width = seq.shape[-1] + payload.shape[-1]
    return torch.cat([payload, seq], dim=-1).reshape(-1, width).to(dtype)


def draw(cfg: dict, calib: tuple[torch.Tensor, ...], seed: int) -> dict:
    """Both encoder banks, the index tree and the logit table, drawn on
    ``calib``'s device from the seed; each level calibrated on the one
    before it, over every packet of the calibration flows."""
    x = _packets(calib, torch.float32)
    dev = x.device
    (k1, v1, c1, n1), (k2, v2, c2, n2) = cfg["banks"]
    bank1, h, lv1 = draw_bank(x, k1, v1, c1.bit_length() - 1, n1, generator(seed, 0, dev))
    bank2, e, lv2 = draw_bank(h, k2, v2, c2.bit_length() - 1, n2, generator(seed, 1, dev))
    emb = torch.tanh(e).reshape(-1, 1, cfg["emb_dim"])
    gen = generator(seed, 2, dev)
    features, thresholds, centroids, lv3 = draw_trees(emb, cfg["index_bits"], gen)
    logit_lut = torch.randn((2 ** cfg["index_bits"], cfg["classes"]), generator=gen, device=dev)
    bias = torch.randn((cfg["classes"],), generator=gen, device=dev) * 0.1
    tree = Bank(features, thresholds, centroids, logit_lut[None], None)
    return {"bank1": bank1, "bank2": bank2, "tree": tree, "logit_lut": logit_lut,
            "bias": bias, "leaves": [lv1, lv2, lv3]}


def program_model(cfg: dict, drawn: dict):
    """The same arrays as the port's ``PegasusCNNL``."""
    from repro_torch.core.amm import PegasusLinear
    from repro_torch.core.fuzzy_tree import FuzzyTree
    from repro_torch.nets.cnn import PegasusCNNL

    def linear(b: Bank):
        return PegasusLinear(trees=FuzzyTree(b.features, b.thresholds, b.centroids),
                             lut=b.lut, bias=b.bias, group_size=b.v)

    t = drawn["tree"]
    return PegasusCNNL(bank1=linear(drawn["bank1"]), bank2=linear(drawn["bank2"]),
                       emb_tree=FuzzyTree(t.features[0], t.thresholds[0], t.centroids[0]),
                       logit_lut=drawn["logit_lut"], bias=drawn["bias"],
                       index_bits=cfg["index_bits"])


def reference(cfg: dict, drawn: dict, inputs: tuple[torch.Tensor, ...], *,
              dtype=torch.float32, int8: bool = False) -> torch.Tensor:
    """Logits ``[B, 3]`` (float32) of the flows ``inputs``, every step in
    ``dtype``."""
    b, w = inputs[0].shape[:2]
    h = bank_forward(drawn["bank1"], _packets(inputs, dtype), dtype=dtype, int8=int8)
    e = torch.tanh(bank_forward(drawn["bank2"], h, dtype=dtype, int8=int8))
    t = drawn["tree"]
    idx = descend(e.reshape(-1, 1, cfg["emb_dim"]), t.features, t.thresholds.to(dtype))[:, 0]
    contrib = drawn["logit_lut"].to(dtype)[idx].reshape(b, w, -1)
    return (contrib.sum(dim=1) + drawn["bias"].to(dtype)).to(torch.float32)


def work(cfg: dict, drawn: dict, flows: int, int8: bool = False) -> tuple[int, int]:
    """(bytes, operations) of the model on ``flows`` flows: the frozen bank
    count of ``bank1`` and ``bank2`` and of the index tree with its logit
    table as a bank (K = 1, v = 16, depth 8, N = 3), at 8 rows a flow, the
    tables read once and only the rows the pool's packets touch; plus the
    sum of 8 packet rows and the bias per flow."""
    rows = flows * cfg["window"]
    meta = lambda *s: torch.empty(s, device="meta")
    index = [1, cfg["emb_dim"], 2 ** cfg["index_bits"], cfg["classes"]]
    total_b = total_o = 0
    for i, ((k, v, c, n), lv) in enumerate(zip([*cfg["banks"], index], drawn["leaves"])):
        p = {"x": meta(rows, k, v), "features": meta(k, c - 1), "lut": meta(k, c, n)}
        nb, ops = bank_bound(p, lv.cpu(), q8=int8 and i < 2)
        total_b, total_o = total_b + nb, total_o + ops
    return total_b, total_o + rows * cfg["classes"]
