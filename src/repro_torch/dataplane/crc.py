"""Consecutive Range Coding (paper §6.1, after NetBeacon [58]); a copy of
the JAX package's ``dataplane/crc.py`` kept inside the port.

PISA switches have no multi-level comparator; the fuzzy-tree descent is
realized by *range matching*: each leaf of the clustering tree owns an
axis-aligned box of the input space, and each box is encoded as TCAM
ternary rules (value/mask pairs) per dimension.

`range_to_ternary` implements the classic prefix-expansion of an integer
interval [lo, hi] into minimal ternary (prefix) rules; a leaf's TCAM cost is
the product over dimensions of its per-dimension rule counts (rules are
crossed-producted into a single wide key, which is how a single-lookup MAT
stage matches a multi-dimensional box).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TernaryRule", "range_to_ternary", "tree_leaf_boxes", "leaf_tcam_rules"]


@dataclasses.dataclass(frozen=True)
class TernaryRule:
    """value/mask pair over ``bits`` bits: matches x iff x & mask == value."""

    value: int
    mask: int
    bits: int

    def matches(self, x: int) -> bool:
        return (x & self.mask) == self.value

    def __repr__(self) -> str:  # e.g. 0b10** for bits=4
        s = []
        for b in reversed(range(self.bits)):
            if (self.mask >> b) & 1:
                s.append(str((self.value >> b) & 1))
            else:
                s.append("*")
        return "0b" + "".join(s)


def range_to_ternary(lo: int, hi: int, bits: int) -> list[TernaryRule]:
    """Minimal prefix expansion of the inclusive integer range [lo, hi]."""
    assert 0 <= lo <= hi < 2**bits, (lo, hi, bits)
    rules: list[TernaryRule] = []

    def emit(prefix_val: int, prefix_len: int):
        mask = ((1 << prefix_len) - 1) << (bits - prefix_len) if prefix_len else 0
        rules.append(TernaryRule(value=prefix_val << (bits - prefix_len), mask=mask, bits=bits))

    def recurse(lo: int, hi: int, prefix_val: int, prefix_len: int):
        if lo > hi:
            return
        span_lo = prefix_val << (bits - prefix_len)
        span_hi = span_lo + (1 << (bits - prefix_len)) - 1
        if lo <= span_lo and span_hi <= hi:
            emit(prefix_val, prefix_len)
            return
        if prefix_len == bits:
            return
        mid = span_lo + (1 << (bits - prefix_len - 1))
        recurse(lo, min(hi, mid - 1), prefix_val << 1, prefix_len + 1)
        recurse(max(lo, mid), hi, (prefix_val << 1) | 1, prefix_len + 1)

    recurse(lo, hi, 0, 0)
    return rules


def tree_leaf_boxes(features: np.ndarray, thresholds: np.ndarray, depth: int,
                    group_dim: int, bits: int = 8) -> list[list[tuple[int, int]]]:
    """Per-leaf axis-aligned integer boxes implied by the clustering tree.

    Values are assumed pre-quantized to unsigned ``bits``-bit fixed point (the
    dataplane representation). Returns, for each leaf, a list of (lo, hi)
    inclusive ranges — one per input dimension.
    """
    vmax = 2**bits - 1
    boxes = []

    def walk(node: int, box: list[tuple[int, int]], level: int):
        if level == depth:
            boxes.append([tuple(r) for r in box])
            return
        f, t = int(features[node]), float(thresholds[node])
        t_int = int(np.floor(t)) if np.isfinite(t) else vmax
        t_int = int(np.clip(t_int, -1, vmax))
        lo, hi = box[f]
        # left: x[f] <= t
        left_box = [list(r) for r in box]
        left_box[f] = [lo, min(hi, t_int)]
        # right: x[f] > t
        right_box = [list(r) for r in box]
        right_box[f] = [max(lo, t_int + 1), hi]
        walk(2 * node + 1, left_box, level + 1)
        walk(2 * node + 2, right_box, level + 1)

    walk(0, [[0, vmax] for _ in range(group_dim)], 0)
    return boxes


def leaf_tcam_rules(box: list[tuple[int, int]], bits: int = 8) -> int:
    """TCAM rules to match one leaf box = Π_dims |prefix-expansion(range)|.

    Empty ranges (unreachable leaves) cost 0 rules.
    """
    total = 1
    for lo, hi in box:
        if lo > hi:
            return 0
        total *= len(range_to_ternary(lo, hi, bits))
    return total
