"""AutoEncoder (paper §6.3, §7.4): unsupervised anomaly detection on the
dataplane via reconstruction error over (len, IPD) sequence features (port
of ``repro.nets.autoencoder``).

Dense teacher: engineered window features → standardize on benign traffic →
FC encoder → FC decoder, trained on BENIGN flows only. Deployment form:
every FC becomes a Pegasus bank, the four fuse into one stacked launch; the
feature stats, the MAE and the threshold compare are dataplane ALU ops, and
the benign standardization is folded into the first bank's weights so the
switch sees raw 8-bit features.

:func:`anomaly_features` appends per-signal temporal stats (mean, std,
lag-1 and lag-2 deltas — the periodicity fingerprint) to the raw window,
and the score is measured in benign z-space, where out-of-manifold inputs
cannot be reconstructed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.amm import init_pegasus_linear
from repro_torch.device import resolve_device
from repro_torch.engine import plan_for
from repro_torch.train.optimizer import adamw_init, adamw_update, cosine_schedule

__all__ = ["AutoEncoder", "AEBanks", "anomaly_features", "init_ae", "train_autoencoder",
           "ae_apply", "reconstruction_error", "pegasusify_ae", "pegasus_ae_error",
           "auc_score"]

LATENT = 3
HIDDEN = 12
Z_CLIP = 6.0       # input saturation in benign σ units; mimics the deployed
# banks, whose trees clamp to the benign calibration range


@dataclasses.dataclass
class AutoEncoder:
    params: dict
    in_dim: int                 # anomaly_features output dim
    feat_mu: np.ndarray         # benign feature mean, [0, 1] units
    feat_sigma: np.ndarray      # benign feature std (floored), [0, 1] units


class AEBanks(list):
    """Pegasus deployment form: a plain bank list (the engine compiles it
    like any MLP stack — ``build_plan``/``plan_for`` accept it unchanged)
    carrying the benign standardization the anomaly score needs."""

    def __init__(self, banks, feat_mu: np.ndarray, feat_sigma: np.ndarray):
        super().__init__(banks)
        self.feat_mu = np.asarray(feat_mu, np.float32)
        self.feat_sigma = np.asarray(feat_sigma, np.float32)


def anomaly_features(x) -> torch.Tensor:
    """Flattened (len, IPD) window → window + temporal-stat features.

    ``x``: ``[..., W*2]`` interleaved ``(len_t, ipd_t)`` 8-bit values (a
    tensor stays on its device; numpy goes to the CPU). Appends, per signal:
    mean, 2·std, mean |lag-1 Δ|, mean |lag-2 Δ|, all clipped to the same
    0..255 range. Lag-1 vs lag-2 separates periodic beaconing (large Δ1,
    tiny Δ2) from bursty-but-aperiodic benign traffic.
    """
    x = torch.as_tensor(x).to(torch.float32)
    lens, ipds = x[..., 0::2], x[..., 1::2]
    feats = [x]
    for s in (lens, ipds):
        feats += [
            s.mean(-1, keepdim=True),
            s.std(-1, correction=0, keepdim=True) * 2.0,
            torch.diff(s, dim=-1).abs().mean(-1, keepdim=True),
            (s[..., 2:] - s[..., :-2]).abs().mean(-1, keepdim=True),
        ]
    return torch.clamp(torch.cat(feats, dim=-1), 0.0, 255.0)


def init_ae(in_dim: int, seed: int = 0, device: str | torch.device = "cuda") -> dict:
    """Random weights from a CPU ``torch.Generator`` seeded by ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    shapes = {"e1": (in_dim, HIDDEN), "e2": (HIDDEN, LATENT), "d1": (LATENT, HIDDEN),
              "d2": (HIDDEN, in_dim)}
    params = {}
    for name, (d, n) in shapes.items():
        params[f"w_{name}"] = torch.randn(d, n, generator=gen) / np.sqrt(d)
        params[f"b_{name}"] = torch.zeros(n)
    return {k: v.to(dev) for k, v in params.items()}


def _z_apply(p: dict, z: torch.Tensor) -> torch.Tensor:
    """Encoder/decoder over standardized features; reconstruction in z units.
    Inputs saturate at ±Z_CLIP but the score compares against the UNCLIPPED
    z, so far-out-of-manifold inputs are unreconstructable by construction."""
    zc = torch.clamp(z, -Z_CLIP, Z_CLIP)
    h = torch.relu(zc @ p["w_e1"] + p["b_e1"])
    lat = torch.relu(h @ p["w_e2"] + p["b_e2"])
    h = torch.relu(lat @ p["w_d1"] + p["b_d1"])
    return h @ p["w_d2"] + p["b_d2"]


def _standardize_feats(ae_or_banks, feats: torch.Tensor) -> torch.Tensor:
    mu = torch.as_tensor(ae_or_banks.feat_mu, device=feats.device)
    sigma = torch.as_tensor(ae_or_banks.feat_sigma, device=feats.device)
    return (feats / 255.0 - mu) / sigma


def _standardize(ae_or_banks, x, device) -> torch.Tensor:
    return _standardize_feats(ae_or_banks, anomaly_features(torch.as_tensor(x, device=device)))


def ae_apply(ae: AutoEncoder, x) -> torch.Tensor:
    """Raw window → z-space reconstruction (dense teacher)."""
    dev = ae.params["w_e1"].device
    return _z_apply(ae.params, _standardize(ae, x, dev))


def reconstruction_error(ae: AutoEncoder, x) -> torch.Tensor:
    """MAE per flow in benign z-space (the anomaly score)."""
    z = _standardize(ae, x, ae.params["w_e1"].device)
    return (_z_apply(ae.params, z) - z).abs().mean(dim=-1)


def train_autoencoder(x_benign: np.ndarray, *, steps: int = 400, seed: int = 0,
                      device: str | torch.device = "cuda") -> AutoEncoder:
    """AdamW on the MAE of benign flows, minibatches of 256 drawn by a
    ``torch.Generator`` seeded by ``seed`` on ``device``."""
    dev = resolve_device(device)
    feats = anomaly_features(np.asarray(x_benign)).numpy()
    feat_mu = feats.mean(0) / 255.0
    feat_sigma = np.maximum(feats.std(0) / 255.0, 1e-3)
    in_dim = feats.shape[1]
    params = init_ae(in_dim, seed, device=dev)
    z = torch.as_tensor((feats / 255.0 - feat_mu) / feat_sigma, device=dev)
    sched = cosine_schedule(3e-3, warmup_steps=30, total_steps=steps)
    state = adamw_init(params)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for _ in range(steps):
        zb = z[torch.randint(0, z.shape[0], (256,), generator=gen, device=dev)]
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        loss = (_z_apply(leaves, zb) - zb).abs().mean()
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        params, state, _ = adamw_update({k: p.detach() for k, p in leaves.items()}, grads,
                                        state, lr=sched(state.step), weight_decay=1e-4)
    return AutoEncoder(params=params, in_dim=in_dim, feat_mu=feat_mu, feat_sigma=feat_sigma)


# ---------------------------------------------------------------------------
# Pegasus deployment form
# ---------------------------------------------------------------------------


def pegasusify_ae(ae: AutoEncoder, x_calib: np.ndarray, *, depth: int = 8) -> AEBanks:
    """Four banks (1-D groups: per-unit 2^depth-entry tables, ReLU folded)
    on the teacher's device. The first bank consumes RAW 0..255 features —
    the /255, mean-shift and 1/σ of the benign standardization are folded
    into its weights — so the switch pipeline never materializes floats."""
    p = {k: v.detach() for k, v in ae.params.items()}
    dev = p["w_e1"].device
    mu, sigma = ae.feat_mu, ae.feat_sigma
    feats = anomaly_features(np.asarray(x_calib, np.float32)).numpy()
    # pre-activations along the z path, for per-bank calibration
    acts = [feats]
    with torch.no_grad():
        h = torch.as_tensor((feats / 255.0 - mu) / sigma, device=dev)
        for w, b in [("w_e1", "b_e1"), ("w_e2", "b_e2"), ("w_d1", "b_d1")]:
            h = h @ p[w] + p[b]
            acts.append(h.cpu().numpy())
            h = torch.relu(h)
    np_p = {k: v.cpu().numpy() for k, v in p.items()}
    w1 = np_p["w_e1"] / (255.0 * sigma[:, None])
    b1 = np_p["b_e1"] - (mu / sigma) @ np_p["w_e1"]
    banks = [init_pegasus_linear(w1, b1, acts[0], group_size=1, depth=depth,
                                 lut_bits=None, device=dev)]
    for i, (w, b) in enumerate([("w_e2", "b_e2"), ("w_d1", "b_d1"), ("w_d2", "b_d2")]):
        banks.append(init_pegasus_linear(
            np_p[w], np_p[b], acts[i + 1], group_size=1, depth=depth, lut_bits=None,
            act_fn=lambda c: torch.clamp(c, min=0.0), device=dev))
    return AEBanks(banks, mu, sigma)


def pegasus_ae_error(banks: AEBanks, x, *, backend: str = "gather",
                     device: str | torch.device = "cuda") -> torch.Tensor:
    """Reconstruction MAE through the engine's bank-stack plan, in benign
    z-space, on ``device``."""
    plan = plan_for(banks, device=device)
    feats = anomaly_features(torch.as_tensor(x, device=plan.device))
    zhat = plan(feats, backend=backend)
    z = _standardize_feats(banks, feats)
    return (zhat - z).abs().mean(dim=-1)


def auc_score(scores: np.ndarray, labels: np.ndarray) -> float:
    """AUROC via the rank statistic (no sklearn)."""
    order = np.argsort(scores)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    pos = labels == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))
