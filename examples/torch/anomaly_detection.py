"""Unsupervised malicious-traffic detection on the dataplane (paper §7.4),
on the PyTorch/CUDA port.

Trains the AutoEncoder on benign traffic only, lowers it to Pegasus tables,
and detects injected malware/DoS flows by MAE reconstruction error — the
zero-day scenario the paper argues only DL (not trees) can handle in-network.

Run:  PYTHONPATH=src python examples/torch/anomaly_detection.py [--device cpu]

The stages take their sizes as keyword arguments with the reference
script's values (``examples/anomaly_detection.py``) as defaults; ``main``
returns the figures it prints.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.data.synthetic_traffic import anomaly_testset, make_dataset
from repro_torch.device import resolve_device
from repro_torch.nets.autoencoder import (
    auc_score, pegasus_ae_error, pegasusify_ae, train_autoencoder,
)


def benign_flows(*, flows_per_class: int = 500):
    """The dataset and its training flows, flattened (the benign set)."""
    ds = make_dataset("iscxvpn", flows_per_class=flows_per_class)
    return ds, ds.train["seq"].reshape(len(ds.train["label"]), -1)


def lower(ae, x_train: np.ndarray, *, depth: int = 8):
    """The AutoEncoder's four Pegasus banks on the teacher's device."""
    return pegasusify_ae(ae, x_train.astype(np.float32), depth=depth)


def detect(banks, ds, device) -> dict:
    """Per attack kind: the AUC of the banks' reconstruction error and the
    share of attack flows above the 95th percentile of the benign scores."""
    out = {}
    for kind in ("malware", "dos"):
        test = anomaly_testset(ds, kind=kind)
        x = torch.as_tensor(test["seq"].reshape(len(test["label"]), -1),
                            dtype=torch.float32, device=device)
        scores = pegasus_ae_error(banks, x, device=device).cpu().numpy()
        auc = auc_score(scores, test["label"])
        thr = np.quantile(scores[test["label"] == 0], 0.95)
        caught = float((scores[test["label"] == 1] > thr).mean())
        print(f"{kind:<8}: AUC={auc:.3f}; at 5% benign FPR the switch would "
              f"rate-limit {caught:.0%} of attack flows")
        out[kind] = dict(auc=auc, caught=caught)
    return out


def main(argv=None, *, flows_per_class: int = 500, steps: int = 600,
         depth: int = 8) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    ds, x_train = benign_flows(flows_per_class=flows_per_class)
    print(f"training AutoEncoder on {len(x_train)} benign flows...")
    ae = train_autoencoder(x_train, steps=steps, device=device)
    banks = lower(ae, x_train, depth=depth)
    return detect(banks, ds, device)


if __name__ == "__main__":
    main()
