"""Synthetic PeerRush / CICIOT / ISCXVPN flows (paper section 7.1).

Frozen copy of ``make_dataset`` from ``src/repro_torch/data/synthetic_traffic.py``
(itself a copy of the JAX package's generator), taken unchanged so that the
benchmark's traffic does not move when the program's copy does. Numpy only.

Feature views per flow window (W = 8 packets): ``stats`` 16 x 8-bit
statistics (MLP-B), ``seq`` W x 2 x 8-bit (length, inter-packet delay),
``bytes`` W x 60 x 8-bit payload.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TrafficDataset", "make_dataset", "DATASETS", "WINDOW", "N_BYTES"]

DATASETS = {"peerrush": 3, "ciciot": 3, "iscxvpn": 7}
WINDOW = 8
N_BYTES = 60


@dataclasses.dataclass
class TrafficDataset:
    name: str
    num_classes: int
    # train/val/test splits, each dict with "stats", "seq", "bytes", "label"
    train: dict
    val: dict
    test: dict


def _class_params(rng: np.random.Generator, c: int, n_classes: int, hardness: float):
    """Markov chain + IPD + byte-histogram parameters for one class."""
    n_states = 6
    base = rng.dirichlet(np.ones(n_states) * 2.0, size=n_states)
    ident = np.roll(np.eye(n_states), c % n_states, axis=1)
    trans = (1 - hardness) * ident + hardness * base
    trans /= trans.sum(1, keepdims=True)
    means = np.linspace(40, 250, n_states) + rng.normal(0, 10, n_states) + 6 * c
    stds = rng.uniform(5, 25, n_states)
    ipd_mu = rng.uniform(1.0, 3.5) + 0.25 * c
    ipd_sigma = rng.uniform(0.3, 0.9)
    byte_profile = rng.dirichlet(np.ones(256) * 0.08)
    return trans, means, stds, ipd_mu, ipd_sigma, byte_profile


def _gen_flows(rng, params, n_flows: int, cls: int):
    trans, means, stds, ipd_mu, ipd_sigma, byte_profile = params
    n_states = trans.shape[0]
    lens = np.zeros((n_flows, WINDOW), np.float32)
    ipds = np.zeros((n_flows, WINDOW), np.float32)
    payload = rng.choice(256, size=(n_flows, WINDOW, N_BYTES), p=byte_profile)
    state = rng.integers(0, n_states, n_flows)
    for t in range(WINDOW):
        lens[:, t] = np.clip(rng.normal(means[state], stds[state]), 0, 255)
        ipds[:, t] = np.clip(rng.lognormal(ipd_mu, ipd_sigma, n_flows), 0, 255)
        u = rng.random(n_flows)
        cdf = np.cumsum(trans[state], axis=1)
        state = (u[:, None] < cdf).argmax(axis=1)
    seq = np.stack([lens, ipds], axis=-1).astype(np.uint8)          # [F, W, 2]

    stats = np.stack(
        [
            lens.max(1), lens.min(1), lens.mean(1), lens.std(1),
            ipds.max(1), ipds.min(1), ipds.mean(1), ipds.std(1),
            np.abs(np.diff(lens, axis=1)).mean(1), np.abs(np.diff(ipds, axis=1)).mean(1),
            (lens > 128).sum(1) * 16.0, (ipds > 32).sum(1) * 16.0,
            lens[:, 0], lens[:, -1], ipds[:, 0], ipds[:, -1],
        ],
        axis=1,
    )
    stats = np.clip(stats, 0, 255).astype(np.uint8)                 # [F, 16]
    labels = np.full(n_flows, cls, np.int32)
    return stats, seq, payload.astype(np.uint8), labels


def make_dataset(
    name: str,
    flows_per_class: int = 1500,
    seed: int | None = None,
    hardness: float | None = None,
) -> TrafficDataset:
    """Build one synthetic dataset with the paper's 75/10/15 split."""
    n_classes = DATASETS[name]
    seed = {"peerrush": 101, "ciciot": 202, "iscxvpn": 303}[name] if seed is None else seed
    hardness = ({"peerrush": 0.45, "ciciot": 0.55, "iscxvpn": 0.62}[name]
                if hardness is None else hardness)
    rng = np.random.default_rng(seed)

    all_stats, all_seq, all_bytes, all_y = [], [], [], []
    for c in range(n_classes):
        params = _class_params(rng, c, n_classes, hardness)
        s, q, b, y = _gen_flows(rng, params, flows_per_class, c)
        all_stats.append(s)
        all_seq.append(q)
        all_bytes.append(b)
        all_y.append(y)

    stats = np.concatenate(all_stats)
    seq = np.concatenate(all_seq)
    payload = np.concatenate(all_bytes)
    y = np.concatenate(all_y)
    perm = rng.permutation(len(y))
    stats, seq, payload, y = stats[perm], seq[perm], payload[perm], y[perm]

    n = len(y)
    n_tr, n_va = int(0.75 * n), int(0.10 * n)

    def split(lo, hi):
        return dict(stats=stats[lo:hi], seq=seq[lo:hi], bytes=payload[lo:hi], label=y[lo:hi])

    return TrafficDataset(
        name=name,
        num_classes=n_classes,
        train=split(0, n_tr),
        val=split(n_tr, n_tr + n_va),
        test=split(n_tr + n_va, n),
    )
