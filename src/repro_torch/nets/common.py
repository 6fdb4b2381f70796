"""Shared training/eval utilities (port of ``repro.nets.common``)."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.train.optimizer import adamw_init, adamw_update, cosine_schedule

__all__ = ["train_classifier", "macro_f1", "precision_recall", "xent", "evaluate"]


def xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, 1, labels.long()[:, None]).mean()


def macro_f1(pred: np.ndarray, true: np.ndarray, n_classes: int) -> float:
    """Paper's metric: average F1 across classes (macro-accuracy)."""
    f1s = []
    for c in range(n_classes):
        tp = float(((pred == c) & (true == c)).sum())
        fp = float(((pred == c) & (true != c)).sum())
        fn = float(((pred != c) & (true == c)).sum())
        pr = tp / (tp + fp) if tp + fp else 0.0
        rc = tp / (tp + fn) if tp + fn else 0.0
        f1s.append(2 * pr * rc / (pr + rc) if pr + rc else 0.0)
    return float(np.mean(f1s))


def precision_recall(pred: np.ndarray, true: np.ndarray, n_classes: int) -> tuple[float, float]:
    prs, rcs = [], []
    for c in range(n_classes):
        tp = float(((pred == c) & (true == c)).sum())
        fp = float(((pred == c) & (true != c)).sum())
        fn = float(((pred != c) & (true == c)).sum())
        prs.append(tp / (tp + fp) if tp + fp else 0.0)
        rcs.append(tp / (tp + fn) if tp + fn else 0.0)
    return float(np.mean(prs)), float(np.mean(rcs))


def train_classifier(
    params: dict,
    apply_fn: Callable[[dict, torch.Tensor], torch.Tensor],
    x_train: np.ndarray,
    y_train: np.ndarray,
    *,
    steps: int = 600,
    batch_size: int = 256,
    lr: float = 3e-3,
    weight_decay: float = 1e-4,
    seed: int = 0,
) -> dict:
    """Minimal AdamW training loop on the parameters' device. Minibatch
    indices come from a ``torch.Generator`` seeded by ``seed``."""
    device = next(iter(params.values())).device
    x_train = torch.as_tensor(np.asarray(x_train), device=device)
    y_train = torch.as_tensor(np.asarray(y_train), device=device)
    n = x_train.shape[0]
    sched = cosine_schedule(lr, warmup_steps=max(steps // 20, 1), total_steps=steps)
    state = adamw_init(params)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = {k: p.detach() for k, p in params.items()}
    for _ in range(steps):
        ix = torch.randint(0, n, (min(batch_size, n),), generator=gen, device=device)
        leaves = {k: p.requires_grad_(True) for k, p in params.items()}
        loss = xent(apply_fn(leaves, x_train[ix]), y_train[ix])
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        params, state, _ = adamw_update(
            {k: p.detach() for k, p in leaves.items()}, grads, state,
            lr=sched(state.step), weight_decay=weight_decay)
    return params


def evaluate(apply_fn, params, x, y, n_classes: int) -> dict:
    device = next(iter(params.values())).device
    with torch.no_grad():
        logits = apply_fn(params, torch.as_tensor(np.asarray(x), device=device))
    pred = logits.argmax(-1).cpu().numpy()
    pr, rc = precision_recall(pred, np.asarray(y), n_classes)
    return dict(f1=macro_f1(pred, np.asarray(y), n_classes), pr=pr, rc=rc)
