"""Trees drawn from calibration rows."""

from __future__ import annotations

import pytest
import torch

from bench.banks import descend, draw_trees, generator


def _reachable(thresholds: torch.Tensor, depth: int) -> torch.Tensor:
    """``[K, 2^d]``: leaves with no +inf node on the right turn of their path."""
    k = thresholds.shape[0]
    ok = torch.ones((k, 1), dtype=torch.bool)
    for level in range(depth):
        base, n = 2**level - 1, 2**level
        thr = thresholds[:, base:base + n]
        ok = torch.stack([ok, ok & torch.isfinite(thr)], dim=-1).reshape(k, 2 * n)
    return ok


@pytest.mark.parametrize("shape", [(3000, 8, 2, 6), (3000, 16, 2, 6), (4000, 4, 1, 8),
                                   (2500, 1, 16, 8)])
def test_every_leaf_reachable_is_reached(shape):
    """Every leaf that no degenerate (+inf) node cuts off is reached by the
    calibration rows, and the descent of the drawn trees gives the drawing's
    own leaves."""
    r, k, v, depth = shape
    g = torch.Generator().manual_seed(5)
    x = torch.randn((r, k, v), generator=g) * 3
    x[:, :, 0] = torch.round(x[:, :, 0] * 4)          # ties, as in byte features
    f, t, c, leaves = draw_trees(x, depth, generator(11, 0, "cpu"))
    assert torch.equal(descend(x, f, t), leaves)
    hit = torch.zeros((k, 2**depth), dtype=torch.bool)
    hit[torch.arange(k).expand(r, k), leaves] = True
    assert torch.equal(hit, _reachable(t, depth))


def test_median_split_balances_leaves():
    """On continuous rows each leaf of a depth-6 tree gets 1/64 of them."""
    x = torch.randn((6400, 2, 2), generator=torch.Generator().manual_seed(3))
    _, _, _, leaves = draw_trees(x, 6, generator(1, 0, "cpu"))
    counts = torch.bincount(leaves[:, 0], minlength=64)
    assert int(counts.min()) >= 90 and int(counts.max()) <= 110


def test_draws_repeat_per_seed_and_change_across_seeds():
    x = torch.randn((2000, 8, 2), generator=torch.Generator().manual_seed(3))
    a = draw_trees(x, 6, generator(7, 0, "cpu"))
    b = draw_trees(x, 6, generator(7, 0, "cpu"))
    c = draw_trees(x, 6, generator(8, 0, "cpu"))
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert not torch.equal(a[0], c[0])
