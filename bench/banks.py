"""Plain PyTorch fuzzy-LUT banks: the benchmark's reference arithmetic and
the drawing of trees and tables from a seed.

A bank is ``K`` complete binary trees of depth ``d`` in heap order over
``v``-wide groups of its input (internal node ``n`` sends a row right iff
``x[feature[n]] > threshold[n]``; a ``+inf`` threshold sends every row left)
and a table ``lut [K, 2^d, N]``: ``y = sum over k of lut[k, leaf_k] + bias``,
the sum taken one group at a time in ascending ``k`` (Pegasus, arXiv
2506.05779, section 5). Written from that description; it imports nothing
of the program.

Trees are drawn, not fitted: each node's feature is drawn from the seed
among those of its group that split the calibration rows reaching it, and
its threshold lies at the boundary between distinct values nearest to their
median, so each leaf is reached about as often as in a fitted tree. A node
whose rows cannot split gets ``+inf``, as a fitted tree's degenerate node.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["Bank", "descend", "bank_forward", "quantize_int8", "draw_trees", "draw_bank",
           "generator"]


@dataclasses.dataclass
class Bank:
    """One bank as plain tensors: ``features [K, 2^d - 1]`` int32,
    ``thresholds [K, 2^d - 1]`` f32, ``centroids [K, 2^d, v]`` f32 (the mean
    calibration row of each leaf), ``lut [K, 2^d, N]`` f32, ``bias [N]``."""

    features: torch.Tensor
    thresholds: torch.Tensor
    centroids: torch.Tensor
    lut: torch.Tensor
    bias: torch.Tensor | None

    @property
    def k(self) -> int:
        return self.lut.shape[0]

    @property
    def v(self) -> int:
        return self.centroids.shape[-1]


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` for one named stream of a seed."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + 7919 * int(stream)) % (2**63 - 1))


def descend(x: torch.Tensor, features: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """Leaf of each row under each tree: ``x [R, K, v]`` → ``[R, K]`` int64."""
    k, n_internal = features.shape
    depth = (n_internal + 1).bit_length() - 1
    feat = features.reshape(-1).long()
    thr = thresholds.reshape(-1)
    base = torch.arange(k, device=x.device) * n_internal
    node = torch.zeros(x.shape[:2], dtype=torch.long, device=x.device)
    for _ in range(depth):
        at = node + base
        val = torch.gather(x, 2, feat[at].unsqueeze(-1)).squeeze(-1)
        node = 2 * node + 1 + (val > thr[at]).long()
    return node - n_internal


def quantize_int8(lut: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 codes per group, rounding half to even:
    ``scale_k = max|lut_k| / 127``; returns (codes ``[K, C, N]`` int8, scales ``[K]``)."""
    amax = lut.abs().amax(dim=(1, 2))
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(lut / scale[:, None, None]), -127, 127)
    return q.to(torch.int8), scale


def bank_forward(bank: Bank, x: torch.Tensor, *, dtype=torch.float32,
                 int8: bool = False, leaves_out: list | None = None) -> torch.Tensor:
    """``y [R, N]`` of ``bank`` on ``x [R, K·v]``, every tensor and sum in
    ``dtype``; ``int8`` takes the table as int8 codes times per-group scales
    (each term ``float(q)·s_k``, summed in float32)."""
    r = x.shape[0]
    xg = x.to(dtype).reshape(r, bank.k, bank.v)
    leaves = descend(xg, bank.features, bank.thresholds.to(dtype))
    if leaves_out is not None:
        leaves_out.append(leaves)
    if int8:
        codes, scales = quantize_int8(bank.lut.to(torch.float32))
        acc = torch.zeros((r, bank.lut.shape[2]), dtype=torch.float32, device=x.device)
        for j in range(bank.k):
            acc = acc + codes[j, leaves[:, j]].to(torch.float32) * scales[j]
    else:
        lut = bank.lut.to(dtype)
        acc = torch.zeros((r, lut.shape[2]), dtype=dtype, device=x.device)
        for j in range(bank.k):
            acc = acc + lut[j, leaves[:, j]]
    if bank.bias is not None:
        acc = acc + bank.bias.to(acc.dtype)
    return acc


def _split_points(vals: torch.Tensor, seg: torch.Tensor, nseg: int) -> torch.Tensor:
    """Per segment, the threshold at the boundary between distinct values
    nearest to the segment's median (``+inf`` where all values are equal)."""
    total = vals.numel()
    by_val = torch.argsort(vals, stable=True)
    perm = by_val[torch.argsort(seg[by_val], stable=True)]
    sv, ss = vals[perm], seg[perm]
    counts = torch.bincount(seg, minlength=nseg)
    starts = torch.cumsum(counts, 0) - counts
    thr = torch.full((nseg,), float("inf"), dtype=vals.dtype, device=vals.device)
    if total < 2:
        return thr
    b = torch.arange(1, total, device=vals.device)
    edge = (ss[1:] == ss[:-1]) & (sv[1:] > sv[:-1])
    b, s = b[edge], ss[1:][edge]
    if not b.numel():
        return thr
    left = b - starts[s]                          # rows below the boundary
    dist = (2 * left - counts[s]).abs()
    key = dist * (total + 1) + b
    best = torch.full((nseg,), torch.iinfo(torch.long).max, dtype=torch.long,
                      device=vals.device)
    best.scatter_reduce_(0, s, key, reduce="amin")
    has = best < torch.iinfo(torch.long).max
    pos = best[has] % (total + 1)
    lo, hi = sv[pos - 1], sv[pos]
    mid = lo + (hi - lo) / 2
    thr[has] = torch.where(mid < hi, mid, lo)     # adjacent floats: split at lo
    return thr


def draw_trees(x: torch.Tensor, depth: int, gen: torch.Generator):
    """K trees of ``depth`` over calibration rows ``x [R, K, v]``; returns
    ``(features, thresholds, centroids, leaves [R, K])``."""
    r, k, v = x.shape
    dev = x.device
    n_internal = 2**depth - 1
    features = torch.zeros((k, n_internal), dtype=torch.int32, device=dev)
    thresholds = torch.full((k, n_internal), float("inf"), dtype=torch.float32, device=dev)
    pos = torch.zeros((r, k), dtype=torch.long, device=dev)
    krow = torch.arange(k, device=dev)
    for level in range(depth):
        n = 2**level
        seg = (pos + krow * n).reshape(-1)
        prio = torch.rand((k * n, v), generator=gen, device=dev)
        thr_f = torch.stack([_split_points(x[:, :, f].reshape(-1), seg, k * n)
                             for f in range(v)], dim=1)                # [K·n, v]
        prio = prio + torch.isinf(thr_f).to(prio.dtype) * 2.0
        feat = prio.argmin(dim=1)                                      # [K·n]
        thr = thr_f.gather(1, feat[:, None]).squeeze(1)
        base = n - 1
        features[:, base:base + n] = feat.reshape(k, n).to(torch.int32)
        thresholds[:, base:base + n] = thr.reshape(k, n)
        val = torch.gather(x, 2, feat[seg].reshape(r, k, 1)).squeeze(-1)
        pos = 2 * pos + (val > thr[seg].reshape(r, k)).long()
    c = 2**depth
    flat = (pos + krow * c).reshape(-1)
    sums = torch.zeros((k * c, v), dtype=torch.float32, device=dev).index_add_(
        0, flat, x.reshape(-1, v).to(torch.float32))
    counts = torch.bincount(flat, minlength=k * c).clamp(min=1).to(torch.float32)
    centroids = (sums / counts[:, None]).reshape(k, c, v)
    return features, thresholds, centroids, pos


def draw_bank(x: torch.Tensor, k: int, v: int, depth: int, n: int,
              gen: torch.Generator, *, bias_scale: float = 0.1):
    """A bank of ``k`` trees over calibration rows ``x [R, K·v]``, its table
    drawn as N(0, 1/K) so that the output spreads about 1, its bias as
    N(0, bias_scale²). Returns ``(bank, y, leaves)``: its output on ``x``
    and the leaves ``[R, K]`` that ``x`` reaches."""
    xg = x.to(torch.float32).reshape(x.shape[0], k, v)
    features, thresholds, centroids, leaves = draw_trees(xg, depth, gen)
    lut = torch.randn((k, 2**depth, n), generator=gen, device=x.device) / k**0.5
    bias = torch.randn((n,), generator=gen, device=x.device) * bias_scale
    bank = Bank(features, thresholds, centroids, lut, bias)
    return bank, bank_forward(bank, x), leaves
