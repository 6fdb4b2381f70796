"""Leo baseline (paper §2): decision tree classifier at line rate (the
port's own copy of ``repro.nets.baselines.leo``).

A plain CART (gini) tree on statistical features — numpy implementation,
depth/leaf-count capped to the paper's "1024 nodes" resource-evaluation
configuration. Trees ARE MAT-friendly (that's Leo's whole design), so no
deployment gap: evaluated accuracy == dataplane accuracy.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["LeoTree", "train_leo", "leo_predict"]


@dataclasses.dataclass
class _Node:
    feature: int = -1
    threshold: float = 0.0
    left: int = -1
    right: int = -1
    label: int = -1


@dataclasses.dataclass
class LeoTree:
    nodes: list[_Node]
    num_classes: int

    @property
    def node_count(self) -> int:
        return len(self.nodes)


def _gini(counts: np.ndarray) -> float:
    n = counts.sum()
    if n == 0:
        return 0.0
    p = counts / n
    return float(1.0 - (p * p).sum())


def _best_split(x: np.ndarray, y: np.ndarray, n_classes: int, max_thresholds=32):
    n, d = x.shape
    best = None
    parent = _gini(np.bincount(y, minlength=n_classes))
    for j in range(d):
        order = np.argsort(x[:, j], kind="stable")
        xs, ys = x[order, j], y[order]
        distinct = np.nonzero(xs[1:] > xs[:-1])[0]
        if distinct.size == 0:
            continue
        if distinct.size > max_thresholds:
            sel = np.linspace(0, distinct.size - 1, max_thresholds).astype(int)
            distinct = distinct[sel]
        onehot = np.zeros((n, n_classes))
        onehot[np.arange(n), ys] = 1.0
        cum = np.cumsum(onehot, axis=0)
        total = cum[-1]
        for i in distinct:
            nl = i + 1
            cl = cum[i]
            cr = total - cl
            g = (nl * _gini(cl) + (n - nl) * _gini(cr)) / n
            if best is None or g < best[2]:
                best = (j, 0.5 * (xs[i] + xs[i + 1]), g)
    if best is None or best[2] >= parent - 1e-9:
        return None
    return best


def train_leo(
    x: np.ndarray, y: np.ndarray, num_classes: int,
    *, max_nodes: int = 1024, min_samples: int = 8,
) -> LeoTree:
    x = x.astype(np.float32)
    y = y.astype(np.int64)
    nodes: list[_Node] = [_Node()]
    queue = [(0, np.arange(len(y)))]
    while queue and len(nodes) < max_nodes:
        nid, idx = queue.pop(0)
        counts = np.bincount(y[idx], minlength=num_classes)
        nodes[nid].label = int(counts.argmax())
        if len(idx) < min_samples or counts.max() == counts.sum():
            continue
        split = _best_split(x[idx], y[idx], num_classes)
        if split is None:
            continue
        j, thr, _ = split
        mask = x[idx, j] <= thr
        li, ri = len(nodes), len(nodes) + 1
        nodes[nid].feature, nodes[nid].threshold = j, float(thr)
        nodes[nid].left, nodes[nid].right = li, ri
        nodes.append(_Node())
        nodes.append(_Node())
        queue.append((li, idx[mask]))
        queue.append((ri, idx[~mask]))
    return LeoTree(nodes=nodes, num_classes=num_classes)


def leo_predict(tree: LeoTree, x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float32)
    out = np.zeros(len(x), np.int64)
    for i, row in enumerate(x):
        n = 0
        while tree.nodes[n].left != -1:
            nd = tree.nodes[n]
            n = nd.left if row[nd.feature] <= nd.threshold else nd.right
        out[i] = tree.nodes[n].label
    return out
