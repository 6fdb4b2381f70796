"""Fuzzy matching (Pegasus §4.2): greedy SSE axis-aligned clustering trees.

Port of ``repro.core.fuzzy_tree``. A complete binary tree of depth ``d`` is
stored in heap order: internal node ``n < 2**d - 1`` holds ``(feature[n],
threshold[n])`` and the descent goes right iff ``x[feature] > threshold``
(a ``+inf`` threshold always sends it left). Leaf ``i`` is heap node
``(2**d - 1) + i`` and stores a centroid.

``fit_tree`` and its helpers stay numpy, copied from the reference, so the
port fits bit-identical trees from the same calibration data. The descent
returns leaf indices as int64, torch's index type. ``soft_index`` relaxes
each split to a sigmoid so that backprop refinement (``core.finetune``)
can move the thresholds (paper §4.4 "Backpropagation").
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.fuzzy_lut.ref import tree_descent_ref

__all__ = ["FuzzyTree", "fit_tree", "stack_trees", "hard_index",
           "hard_index_stacked", "soft_index", "soft_index_stacked", "leaf_one_hot"]


@dataclasses.dataclass
class FuzzyTree:
    """Array-form complete clustering tree (or K stacked trees).

    Attributes:
      features:   int32 ``[.., 2**depth - 1]`` — split dimension per node.
      thresholds: float32 ``[.., 2**depth - 1]`` — split threshold per node.
      centroids:  float32 ``[.., 2**depth, v]`` — leaf centroids.
    """

    features: torch.Tensor
    thresholds: torch.Tensor
    centroids: torch.Tensor

    @property
    def depth(self) -> int:
        return int(np.log2(self.centroids.shape[-2]) + 0.5)

    @property
    def num_leaves(self) -> int:
        return self.centroids.shape[-2]

    @property
    def group_dim(self) -> int:
        return self.centroids.shape[-1]

    def to(self, device) -> "FuzzyTree":
        return FuzzyTree(self.features.to(device), self.thresholds.to(device),
                         self.centroids.to(device))


# ---------------------------------------------------------------------------
# Offline fitting (numpy — runs once, before deployment)
# ---------------------------------------------------------------------------


def _cluster_sse(x: np.ndarray) -> float:
    """Total SSE of a cluster: sum over dims of squared deviation from mean."""
    if x.shape[0] == 0:
        return 0.0
    return float(((x - x.mean(axis=0, keepdims=True)) ** 2).sum())


def _best_split(x: np.ndarray, max_thresholds: int = 64):
    """Best (feature, threshold) minimizing child-SSE sum for one cluster,
    or None if the cluster cannot split. Candidate thresholds are midpoints
    between distinct sorted values, subsampled to ``max_thresholds``."""
    n, v = x.shape
    if n < 2:
        return None
    best = None
    for j in range(v):
        order = np.argsort(x[:, j], kind="stable")
        xs = x[order]
        col = xs[:, j]
        distinct = np.nonzero(col[1:] > col[:-1])[0]  # split after index i
        if distinct.size == 0:
            continue
        if distinct.size > max_thresholds:
            sel = np.linspace(0, distinct.size - 1, max_thresholds).astype(int)
            distinct = distinct[sel]
        csum = np.cumsum(xs, axis=0)
        csq = np.cumsum(xs * xs, axis=0)
        tot_sum, tot_sq = csum[-1], csq[-1]
        for i in distinct:
            nl = i + 1
            nr = n - nl
            sl, ql = csum[i], csq[i]
            sr, qr = tot_sum - sl, tot_sq - ql
            sse = float((ql - sl * sl / nl).sum() + (qr - sr * sr / nr).sum())
            if best is None or sse < best[2]:
                thr = 0.5 * (col[i] + col[i + 1])
                best = (j, float(thr), sse)
    return best


def fit_tree(data: np.ndarray, depth: int, max_thresholds: int = 64) -> FuzzyTree:
    """Greedy top-down complete-tree clustering (paper §4.2).

    Degenerate nodes (too few points / constant data) get ``threshold=+inf``
    so all traffic flows left. Returns CPU tensors.
    """
    data = np.asarray(data, dtype=np.float32)
    if data.ndim != 2:
        raise ValueError(f"fit_tree expects [N, v], got shape {data.shape}")
    n_internal = 2**depth - 1
    features = np.zeros(n_internal, dtype=np.int32)
    thresholds = np.full(n_internal, np.inf, dtype=np.float32)
    centroids = np.zeros((2**depth, data.shape[1]), dtype=np.float32)

    members: dict[int, np.ndarray] = {0: data}
    for node in range(n_internal):
        x = members.pop(node, None)
        left, right = 2 * node + 1, 2 * node + 2
        if x is None or x.shape[0] == 0:
            members[left] = np.zeros((0, data.shape[1]), np.float32)
            members[right] = np.zeros((0, data.shape[1]), np.float32)
            continue
        split = _best_split(x, max_thresholds=max_thresholds)
        if split is None:
            features[node] = 0
            thresholds[node] = np.inf
            members[left], members[right] = x, x[:0]
            continue
        j, thr, _ = split
        features[node] = j
        thresholds[node] = thr
        mask = x[:, j] <= thr
        members[left], members[right] = x[mask], x[~mask]

    global_mean = data.mean(axis=0) if data.shape[0] else np.zeros(data.shape[1])
    for leaf in range(2**depth):
        x = members.get((2**depth - 1) + leaf)
        if x is None or x.shape[0] == 0:
            centroids[leaf] = global_mean
        else:
            centroids[leaf] = x.mean(axis=0)

    return FuzzyTree(
        features=torch.from_numpy(features),
        thresholds=torch.from_numpy(thresholds),
        centroids=torch.from_numpy(centroids),
    )


def stack_trees(trees: list[FuzzyTree]) -> FuzzyTree:
    """Stack K single-group trees into arrays with a leading K axis."""
    return FuzzyTree(
        features=torch.stack([t.features for t in trees]),
        thresholds=torch.stack([t.thresholds for t in trees]),
        centroids=torch.stack([t.centroids for t in trees]),
    )


# ---------------------------------------------------------------------------
# Inference-time descent
# ---------------------------------------------------------------------------


def hard_index(tree: FuzzyTree, x: torch.Tensor) -> torch.Tensor:
    """Map sub-vectors ``x[..., v]`` to leaf indices ``[...]`` (int64)."""
    depth = tree.depth
    feats = tree.features.long()
    node = torch.zeros(x.shape[:-1], dtype=torch.long, device=x.device)
    for _ in range(depth):
        val = torch.gather(x, -1, feats[node].unsqueeze(-1)).squeeze(-1)
        node = 2 * node + 1 + (val > tree.thresholds[node]).long()
    return node - (2**depth - 1)


def hard_index_stacked(stacked: FuzzyTree, x: torch.Tensor) -> torch.Tensor:
    """Index with K stacked trees. ``x: [..., K, v]`` → ``[..., K]`` int64."""
    return tree_descent_ref(x, stacked.features, stacked.thresholds)


def leaf_one_hot(tree: FuzzyTree, x: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Hard one-hot leaf encoding ``[..., 2**depth]``."""
    return torch.nn.functional.one_hot(hard_index(tree, x), tree.num_leaves).to(dtype)


# ---------------------------------------------------------------------------
# Differentiable descent (backprop refinement)
# ---------------------------------------------------------------------------


def soft_index_stacked(stacked: FuzzyTree, x: torch.Tensor,
                       temperature: float = 1.0) -> torch.Tensor:
    """Soft leaf distributions of K stacked trees: ``x [..., K, v]`` →
    ``[..., K, 2**depth]``.

    Each split relaxes to ``p_right = sigmoid((x[f] - t) / temperature)``
    and a leaf's probability is the product along its path; as the
    temperature goes to 0 this tends to the hard one-hot. Level by level,
    one gather reads the level's split values for all K trees. A node with
    a non-finite threshold (a degenerate ``+inf`` split) always goes left,
    and its threshold gets a zero gradient.
    """
    k, n_internal = stacked.features.shape
    feats = stacked.features.long()
    lead = x.shape[:-2]
    level_probs = torch.ones(*lead, k, 1, dtype=x.dtype, device=x.device)
    base, n_nodes = 0, 1
    while base < n_internal:
        feat = feats[:, base : base + n_nodes]                  # [K, n]
        thr = stacked.thresholds[:, base : base + n_nodes]      # [K, n]
        vals = torch.gather(x, -1, feat.expand(*lead, k, n_nodes))
        p_right = torch.sigmoid((vals - thr) / temperature)
        p_right = torch.where(torch.isfinite(thr), p_right, torch.zeros_like(p_right))
        # children in heap order: [L0, R0, L1, R1, ...]
        level_probs = torch.stack([level_probs * (1.0 - p_right), level_probs * p_right],
                                  dim=-1).reshape(*lead, k, 2 * n_nodes)
        base, n_nodes = base + n_nodes, 2 * n_nodes
    return level_probs


def soft_index(tree: FuzzyTree, x: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """Differentiable leaf distribution of one tree: ``x [..., v]`` →
    ``[..., 2**depth]`` (see :func:`soft_index_stacked`)."""
    one = FuzzyTree(tree.features[None], tree.thresholds[None], tree.centroids[None])
    return soft_index_stacked(one, x.unsqueeze(-2), temperature).squeeze(-2)
