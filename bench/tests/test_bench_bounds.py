"""The frozen bound functions give the bounds PERF.md's kernel table lists
at the MLP-B bucket-4096 shapes: per launch, 0.000266 ms (bytes) for the
per-bank kernel (the mean over the four MLP-B banks) and 0.000125 ms
(bytes) for the stack. The problems are ``chip_smoke.py``'s
``bank_problem``/``stack_problem`` arithmetic, drawn in ``check_kernels``'
order from ``numpy.random.default_rng(0)``, with the leaves from the
benchmark's own descent."""

from __future__ import annotations

import numpy as np
import torch

from bench.banks import descend
from bench.ref.bounds import bank_bound, bound_ms, stack_bound

MLPB_BANKS = [(8, 32), (16, 32), (16, 32), (16, 3)]


def _bank(rng, t, k, v, depth, n):
    i = 2**depth - 1
    thr = rng.normal(size=(k, i)).astype(np.float32)
    thr[rng.random(size=thr.shape) < 0.05] = np.inf
    p = dict(x=rng.normal(size=(t, k, v)).astype(np.float32),
             features=rng.integers(0, v, size=(k, i)).astype(np.int32),
             thresholds=thr, lut=rng.normal(size=(k, i + 1, n)).astype(np.float32))
    return {key: torch.as_tensor(a) for key, a in p.items()}


def _stack(rng, t, ks, v, depth, nmax, n_out):
    nl, kmax, c = len(ks), max(ks), 2**depth
    feats = np.zeros((nl, kmax, c - 1), np.int32)
    thr = np.full((nl, kmax, c - 1), np.inf, np.float32)
    lut = np.zeros((nl, kmax, c, nmax), np.float32)
    bias = np.zeros((nl, nmax), np.float32)
    for l, k in enumerate(ks):
        n = n_out if l == nl - 1 else ks[l + 1] * v
        feats[l, :k] = rng.integers(0, v, size=(k, c - 1))
        thr[l, :k] = rng.normal(size=(k, c - 1))
        lut[l, :k, :, :n] = rng.normal(size=(k, c, n)) * 0.3
        bias[l, :n] = rng.normal(size=n) * 0.1
    p = dict(x=rng.normal(size=(t, ks[0], v)).astype(np.float32), features=feats,
             thresholds=thr, lut=lut, bias=bias)
    return {key: torch.as_tensor(a) for key, a in p.items()}


def _stack_leaves(p, ks, v):
    t, kmax = p["x"].shape[0], p["lut"].shape[1]
    h = torch.nn.functional.pad(p["x"], (0, 0, 0, kmax - ks[0]))
    out = []
    for l in range(len(ks)):
        leaves = descend(h, p["features"][l], p["thresholds"][l])
        out.append(leaves)
        y = torch.zeros((t, p["lut"].shape[3]))
        for j in range(kmax):
            y = y + p["lut"][l, j, leaves[:, j]]
        y = y + p["bias"][l]
        if l + 1 < len(ks):
            h = torch.nn.functional.pad(y[:, : ks[l + 1] * v].reshape(t, ks[l + 1], v),
                                        (0, 0, 0, kmax - ks[l + 1]))
    return torch.stack(out)


def test_bounds_at_the_mlp_b_shapes():
    rng = np.random.default_rng(0)
    nbytes = ops = 0
    for k, n in MLPB_BANKS:
        p = _bank(rng, 4096, k, 2, 6, n)
        b, o = bank_bound(p, descend(p["x"], p["features"], p["thresholds"]), q8=False)
        nbytes, ops = nbytes + b, ops + o
    ms, by = bound_ms(nbytes, ops)
    assert (round(ms / 4, 6), by) == (0.000266, "bytes")
    # the draws check_kernels makes between the MLP-B banks and the stack
    for shape in (dict(t=1000, k=13, v=4, depth=5, n=70), dict(t=1, k=3, v=2, depth=1, n=1),
                  dict(t=300, k=16, v=2, depth=6, n=2048), dict(t=200, k=256, v=2, depth=6, n=40)):
        _bank(rng, **shape)
    ks = (8, 16, 16, 16)
    p = _stack(rng, 4096, ks, 2, 6, 32, 3)
    ms, by = bound_ms(*stack_bound(p, _stack_leaves(p, ks, 2), ks, 3, q8=False))
    assert (round(ms, 6), by) == (0.000125, "bytes")
