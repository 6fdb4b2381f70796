"""CNN-B / CNN-M / CNN-L (paper §6.3): 1-D textcnn-style classifiers (port
of ``repro.nets.cnn``).

  * CNN-B: Basic Fusion only — conv windows over the (len, IPD) sequence,
    each window position a fused table bank, ReLU folded forward, avg-pool +
    FC head.
  * CNN-M: same input, Advanced Primitive Fusion (NAM): ALL intermediate
    SumReduces removed — each window's whole sub-network folds into ONE
    lookup; a single final SumReduce mixes window contributions.
  * CNN-L: NAM over PACKETS with raw 60-byte payloads (+len,ipd): a
    per-packet encoder produces a compact embedding that is fuzzy-indexed to
    a few bits (the paper's per-flow "fuzzy index per packet" storage trick,
    §7.3, Fig. 7), and a second level maps (packet-slot, index) → class-logit
    contributions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.amm import PegasusLinear, init_pegasus_bank, init_pegasus_linear
from repro_torch.core.finetune import refine
from repro_torch.core.fuzzy_tree import FuzzyTree, fit_tree
from repro_torch.device import resolve_device
from repro_torch.engine import plan_for

from .common import train_classifier

__all__ = [
    "CNNModel", "PegasusCNN", "init_cnn", "train_cnn", "cnn_apply",
    "pegasusify_cnn", "pegasus_cnn_apply", "nam_window_targets",
    "CNNL", "PegasusCNNL", "init_cnn_l", "train_cnn_l", "cnn_l_apply",
    "pegasusify_cnn_l", "pegasus_cnn_l_apply",
]


# ---------------------------------------------------------------------------
# CNN-B / CNN-M: conv over the 8×2 sequence
# ---------------------------------------------------------------------------

KERNEL = 3  # conv window length (time steps)


@dataclasses.dataclass
class CNNModel:
    params: dict
    num_classes: int
    channels: int
    hidden: int
    size: str  # "B" | "M"


def _randn_params(shapes: dict, seed: int, device) -> dict:
    """Teacher weights: ``(rows, cols)`` entries are N(0, 1)/sqrt(rows)
    from a CPU ``torch.Generator`` seeded by ``seed``; ``(n,)`` entries are
    zeros."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params = {}
    for name, shape in shapes.items():
        params[name] = (torch.randn(*shape, generator=gen) / np.sqrt(float(shape[0]))
                        if len(shape) == 2 else torch.zeros(shape))
    return {k: v.to(dev) for k, v in params.items()}


def init_cnn(num_classes: int, channels: int, hidden: int, seed: int = 0,
             device: str | torch.device = "cuda") -> dict:
    in_w = KERNEL * 2  # window of 3 steps × (len, ipd)
    return _randn_params({
        "w_conv": (in_w, channels), "b_conv": (channels,),
        "w_h": (channels, hidden), "b_h": (hidden,),
        "w_o": (hidden, num_classes), "b_o": (num_classes,)}, seed, device)


def _windows(x: torch.Tensor) -> torch.Tensor:
    """[B, W, f] → [B, P, KERNEL*f] sliding windows (stride 1)."""
    b, w, f = x.shape
    p = w - KERNEL + 1
    idx = (torch.arange(p, device=x.device)[:, None]
           + torch.arange(KERNEL, device=x.device)[None, :])
    return x[:, idx].reshape(b, p, KERNEL * f)


def cnn_apply(m_or_p, x: torch.Tensor) -> torch.Tensor:
    p = m_or_p.params if isinstance(m_or_p, CNNModel) else m_or_p
    xf = x.to(torch.float32) / 255.0
    win = _windows(xf)                                    # [B, P, 6]
    h = torch.relu(win @ p["w_conv"] + p["b_conv"])       # conv as per-window FC
    h = h.mean(dim=1)                                     # avg pool over time
    h = torch.relu(h @ p["w_h"] + p["b_h"])
    return h @ p["w_o"] + p["b_o"]


def train_cnn(x: np.ndarray, y: np.ndarray, num_classes: int, *, size: str = "B",
              steps: int = 900, seed: int = 0,
              device: str | torch.device = "cuda") -> CNNModel:
    channels, hidden = (16, 24) if size == "B" else (48, 64)
    params = init_cnn(num_classes, channels, hidden, seed=seed, device=device)
    params = train_classifier(params, cnn_apply, x, y, steps=steps, lr=2e-3, seed=seed)
    return CNNModel(params=params, num_classes=num_classes, channels=channels,
                    hidden=hidden, size=size)


@dataclasses.dataclass
class PegasusCNN:
    """CNN-B: fused banks. CNN-M (NAM): window_bank covers the whole
    per-window sub-model in ONE lookup per window."""

    window_bank: PegasusLinear       # [B,P,6] windows → per-window contribution
    head_banks: list[PegasusLinear]  # empty for NAM (M); B keeps FC head banks
    out_bias: torch.Tensor | None
    nam: bool
    pool_windows: int


def _nam_submodel(p: dict, n_pool: int):
    """CNN-M's per-window sub-model — conv, ReLU, FC, ReLU, its share of the
    average pool, FC head — on windows ``[..., 6]`` (centroids included)."""
    def submodel(c):
        h = torch.relu(c / 255.0 @ p["w_conv"] + p["b_conv"])
        return torch.relu(h @ p["w_h"] + p["b_h"]) / n_pool @ p["w_o"]

    return submodel


def nam_window_targets(m: CNNModel, x_calib: np.ndarray) -> tuple[np.ndarray, torch.Tensor]:
    """CNN-M's window-bank calibration: the windows ``[B·P, 6]`` (numpy) and
    the teacher's per-window output ``[B·P, classes]`` on its device, the
    target ``refine`` holds the window bank to."""
    p = {k: v.detach() for k, v in m.params.items()}
    win = _windows(torch.as_tensor(x_calib.astype(np.float32)))
    flat = win.reshape(-1, KERNEL * 2).numpy()
    with torch.no_grad():
        target = _nam_submodel(p, win.shape[1])(torch.as_tensor(flat, device=p["w_o"].device))
    return flat, target


def pegasusify_cnn(m: CNNModel, x_calib: np.ndarray, *, depth: int = 12,
                   refine_steps: int = 0) -> PegasusCNN:
    """Lower CNN-B (window bank + two head banks) or CNN-M (one NAM window
    bank) on the teacher's device. ``refine_steps > 0`` refines CNN-M's
    window bank against the per-window NAM sub-model; CNN-B has no
    refinement hook (as in the reference)."""
    p = {k: v.detach() for k, v in m.params.items()}
    dev = p["w_conv"].device
    win = _windows(torch.as_tensor(x_calib.astype(np.float32)))
    flat = win.reshape(-1, KERNEL * 2).numpy()                # [B·P, 6]
    n_pool = win.shape[1]

    def conv(c):                                              # relu(c/255 @ W + b)
        return torch.relu(c / 255.0 @ p["w_conv"] + p["b_conv"])

    if m.size == "M":
        # NAM (Advanced Fusion ③): the per-window sub-model folds into ONE
        # lookup; only the final SumReduce over windows survives.
        submodel = _nam_submodel(p, n_pool)
        bank = init_pegasus_bank(submodel, flat, group_size=KERNEL * 2, depth=depth,
                                 device=dev)
        if refine_steps:
            bank = refine(bank, *nam_window_targets(m, x_calib), steps=refine_steps)
        return PegasusCNN(window_bank=bank, head_banks=[], out_bias=p["b_o"],
                          nam=True, pool_windows=n_pool)

    # CNN-B (Basic Fusion): the conv window is ONE group (K=1), so the ReLU
    # folds directly into the rows: rows = relu(c@W + b).
    conv_bank = init_pegasus_bank(conv, flat, group_size=KERNEL * 2, depth=depth,
                                  device=dev)
    with torch.no_grad():
        pooled = conv(torch.as_tensor(flat, device=dev)).reshape(
            win.shape[0], n_pool, -1).mean(1)                 # post-relu avg pool
        h_pre = pooled @ p["w_h"] + p["b_h"]
    np_p = {k: v.cpu().numpy() for k, v in p.items()}
    h_bank = init_pegasus_linear(np_p["w_h"], np_p["b_h"], pooled.cpu().numpy(),
                                 group_size=1, depth=8, lut_bits=None, device=dev)
    # head banks: 1-D groups — exact for the linear part (a table per
    # scalar unit, 2^8 entries: the paper's fixed-point activation story)
    o_bank = init_pegasus_linear(np_p["w_o"], np_p["b_o"], h_pre.cpu().numpy(),
                                 group_size=1, depth=8, lut_bits=None,
                                 act_fn=lambda c: torch.clamp(c, min=0.0), device=dev)
    return PegasusCNN(window_bank=conv_bank, head_banks=[h_bank, o_bank], out_bias=None,
                      nam=False, pool_windows=n_pool)


def pegasus_cnn_apply(peg: PegasusCNN, x, *, backend: str = "gather",
                      device: str | torch.device = "cuda") -> torch.Tensor:
    """Windowed deployment forward via the engine (B and M/NAM variants)."""
    return plan_for(peg, device=device)(x, backend=backend)


# ---------------------------------------------------------------------------
# CNN-L: NAM over packets with raw payload bytes
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CNNL:
    params: dict
    num_classes: int
    emb_dim: int


def init_cnn_l(num_classes: int, emb_dim: int = 16, seed: int = 0,
               device: str | torch.device = "cuda") -> dict:
    in_dim = 62  # 60 payload bytes + len + ipd
    return _randn_params({
        "w_e1": (in_dim, 64), "b_e1": (64,),
        "w_e2": (64, emb_dim), "b_e2": (emb_dim,),
        "w_o": (emb_dim, num_classes), "b_o": (num_classes,)}, seed, device)


def _packet_feats(seq: torch.Tensor, payload: torch.Tensor) -> torch.Tensor:
    """[B,W,2]+[B,W,60] → [B, W, 62] float in [0,1]."""
    return torch.cat([payload.to(torch.float32), seq.to(torch.float32)], dim=-1) / 255.0


def _encode(p: dict, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Layer-1 pre-activation and the tanh embedding of packet features."""
    h_pre = x @ p["w_e1"] + p["b_e1"]
    return h_pre, torch.tanh(torch.relu(h_pre) @ p["w_e2"] + p["b_e2"])


def cnn_l_apply(m_or_p, seq: torch.Tensor, payload: torch.Tensor) -> torch.Tensor:
    p = m_or_p.params if isinstance(m_or_p, CNNL) else m_or_p
    _, e = _encode(p, _packet_feats(seq, payload))        # per-packet embedding
    return (e @ p["w_o"]).sum(dim=1) + p["b_o"]           # NAM contributions


def train_cnn_l(seq: np.ndarray, payload: np.ndarray, y: np.ndarray, num_classes: int,
                *, steps: int = 1000, seed: int = 0,
                device: str | torch.device = "cuda") -> CNNL:
    params = init_cnn_l(num_classes, seed=seed, device=device)
    x_pack = np.concatenate([seq.reshape(len(y), -1), payload.reshape(len(y), -1)], axis=1)
    w = seq.shape[1]

    def apply_packed(p, xb):
        return cnn_l_apply(p, xb[:, : w * 2].reshape(-1, w, 2),
                           xb[:, w * 2 :].reshape(-1, w, 60))

    params = train_classifier(params, apply_packed, x_pack, y, steps=steps, lr=2e-3,
                              seed=seed)
    return CNNL(params=params, num_classes=num_classes, emb_dim=16)


@dataclasses.dataclass
class PegasusCNNL:
    """Two-level NAM: per-packet encoder banks → fuzzy index (stored per
    flow, 4–8 bits, the §7.3 flow-storage trick) → logit LUT, final SumReduce."""

    bank1: PegasusLinear           # raw 62 bytes → encoder layer-1 pre-act
    bank2: PegasusLinear           # layer-1 pre-act → embedding pre-act (ReLU folded)
    emb_tree: FuzzyTree            # fuzzy index over tanh(embedding)
    logit_lut: torch.Tensor        # [2^index_bits, num_classes]
    bias: torch.Tensor
    index_bits: int


def pegasusify_cnn_l(m: CNNL, seq: np.ndarray, payload: np.ndarray, *,
                     enc_group: int = 1, enc_depth: int = 8,
                     index_bits: int = 4) -> PegasusCNNL:
    p = {k: v.detach() for k, v in m.params.items()}
    dev = p["w_e1"].device
    x = _packet_feats(torch.as_tensor(seq), torch.as_tensor(payload))     # [B,W,62]
    flat = x.reshape(-1, 62).numpy() * 255.0       # raw byte domain for the tables
    np_p = {k: v.cpu().numpy() for k, v in p.items()}

    # level-1 bank: raw packet bytes → layer-1 pre-act
    bank1 = init_pegasus_linear(np_p["w_e1"] / 255.0, np_p["b_e1"], flat,
                                group_size=enc_group, depth=enc_depth, lut_bits=None,
                                device=dev)
    with torch.no_grad():
        h_pre, emb = _encode(p, torch.as_tensor(flat, device=dev) / 255.0)
    # level-1b bank: pre-act → embedding pre-act, ReLU folded into LUT rows
    bank2 = init_pegasus_linear(np_p["w_e2"], np_p["b_e2"], h_pre.cpu().numpy(),
                                group_size=enc_group, depth=enc_depth, lut_bits=None,
                                act_fn=lambda c: torch.clamp(c, min=0.0), device=dev)
    # level-2: fuzzy-index tanh(embedding) to ``index_bits`` bits per packet;
    # the per-flow register stores ONLY this index (Fig. 7 storage model).
    emb_tree = fit_tree(emb.cpu().numpy(), depth=index_bits).to(dev)
    logit_lut = emb_tree.centroids @ p["w_o"]
    return PegasusCNNL(bank1=bank1, bank2=bank2, emb_tree=emb_tree, logit_lut=logit_lut,
                       bias=p["b_o"], index_bits=index_bits)


def pegasus_cnn_l_apply(peg: PegasusCNNL, seq, payload, *, backend: str = "gather",
                        device: str | torch.device = "cuda") -> torch.Tensor:
    """Deployment forward via the engine: all-table encoding → fuzzy index →
    LUT sum (the two-level NAM)."""
    return plan_for(peg, device=device)(seq, payload, backend=backend)
