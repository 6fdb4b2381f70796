"""Carry weights and state into the port from numpy arrays.

The port never sees another framework's types: a caller turns its objects
into numpy (``np.asarray(layer.lut)`` and so on) and passes the arrays in.
The tests use this to run banks and teachers built by the JAX reference
through the port.
"""

from __future__ import annotations

import numpy as np
import torch

from torch import nn

from repro_torch.configs.registry import ArchConfig
from repro_torch.core.amm import PegasusLinear
from repro_torch.core.fuzzy_tree import FuzzyTree
from repro_torch.device import resolve_device
from repro_torch.kernels.fuzzy_lut.ops import check_features
from repro_torch.models.layers import Params
from repro_torch.models.pegasus_layer import PegasusFFN
from repro_torch.models.transformer import FFN
from repro_torch.nets.autoencoder import AEBanks, AutoEncoder
from repro_torch.nets.baselines.bos import BoS
from repro_torch.nets.baselines.leo import LeoTree, _Node
from repro_torch.nets.baselines.n3ic import N3IC
from repro_torch.nets.cnn import CNNL, CNNModel, PegasusCNN, PegasusCNNL
from repro_torch.nets.mlp import MLPB
from repro_torch.nets.rnn import RNNB, PegasusRNN
from repro_torch.train.checkpoint import stack_named

__all__ = ["pegasus_linear_from_arrays", "banks_from_arrays", "mlp_from_arrays",
           "rnn_from_arrays", "cnn_from_arrays", "cnn_l_from_arrays",
           "ae_banks_from_arrays", "rnn_teacher_from_arrays", "cnn_teacher_from_arrays",
           "cnn_l_teacher_from_arrays", "ae_from_arrays", "n3ic_from_arrays",
           "bos_from_arrays", "leo_from_arrays", "lm_params_from_arrays",
           "lm_arrays_from_params", "pegasus_ffn_from_arrays"]


def _t(a, dtype, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=dtype), device=dev)


def _t_as_is(a, dev) -> torch.Tensor:
    """A tensor of the array's own float type: f32, or bf16 for an array
    whose dtype is named ``bfloat16`` (exact through f32)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return _t(a, np.float32, dev).to(torch.bfloat16)
    return torch.tensor(a, device=dev)


def pegasus_linear_from_arrays(features, thresholds, centroids, lut, bias,
                               group_size: int,
                               device: str | torch.device = "cuda") -> PegasusLinear:
    """A PegasusLinear from its arrays: features ``[K, I]``, thresholds
    ``[K, I]``, centroids ``[K, C, v]``, lut ``[K, C, N]``, bias ``[N]`` or
    None."""
    dev = resolve_device(device)
    trees = FuzzyTree(features=_t(features, np.int32, dev),
                      thresholds=_t(thresholds, np.float32, dev),
                      centroids=_t(centroids, np.float32, dev))
    lut_t = _t(lut, np.float32, dev)
    k, c, _ = lut_t.shape
    if trees.features.shape != (k, c - 1) or trees.thresholds.shape != (k, c - 1):
        raise ValueError(f"trees {tuple(trees.features.shape)} do not fit a "
                         f"LUT of shape {tuple(lut_t.shape)}")
    check_features(trees.features, group_size)
    return PegasusLinear(trees=trees, lut=lut_t,
                         bias=None if bias is None else _t(bias, np.float32, dev),
                         group_size=int(group_size))


def banks_from_arrays(banks: list[dict],
                      device: str | torch.device = "cuda") -> list[PegasusLinear]:
    """A bank list from dicts holding the keyword arguments of
    :func:`pegasus_linear_from_arrays` (without ``device``)."""
    return [pegasus_linear_from_arrays(**b, device=device) for b in banks]


def _params(params: dict, dev) -> dict:
    return {k: _t(v, np.float32, dev) for k, v in params.items()}


def mlp_from_arrays(params: dict, mu, sigma, num_classes: int,
                    device: str | torch.device = "cuda") -> MLPB:
    """An MLP-B teacher from its parameter arrays and normalization."""
    dev = resolve_device(device)
    return MLPB(params=_params(params, dev), mu=_t(mu, np.float32, dev),
                sigma=_t(sigma, np.float32, dev), num_classes=int(num_classes))


# ---------------------------------------------------------------------------
# The other families: bank containers (each bank a dict as for
# pegasus_linear_from_arrays) and teachers (parameter dicts)
# ---------------------------------------------------------------------------


def rnn_from_arrays(x_banks: list[dict], h_banks: list[dict], out_bank: dict,
                    window: int, device: str | torch.device = "cuda") -> PegasusRNN:
    """A pegasusified RNN-B: one x-bank per step, one h-bank per step after
    the first, the classifier bank."""
    return PegasusRNN(x_banks=banks_from_arrays(x_banks, device),
                      h_banks=banks_from_arrays(h_banks, device),
                      out_bank=pegasus_linear_from_arrays(**out_bank, device=device),
                      window=int(window))


def cnn_from_arrays(window_bank: dict, head_banks: list[dict], out_bias, nam: bool,
                    pool_windows: int, device: str | torch.device = "cuda") -> PegasusCNN:
    """A pegasusified CNN-B (head banks, no ``out_bias``) or CNN-M (NAM: no
    head banks, an ``out_bias``)."""
    dev = resolve_device(device)
    return PegasusCNN(window_bank=pegasus_linear_from_arrays(**window_bank, device=dev),
                      head_banks=banks_from_arrays(head_banks, dev),
                      out_bias=None if out_bias is None else _t(out_bias, np.float32, dev),
                      nam=bool(nam), pool_windows=int(pool_windows))


def cnn_l_from_arrays(bank1: dict, bank2: dict, emb_tree: dict, logit_lut, bias,
                      index_bits: int, device: str | torch.device = "cuda") -> PegasusCNNL:
    """A pegasusified CNN-L; ``emb_tree`` holds the ``features``,
    ``thresholds`` and ``centroids`` of the embedding's fuzzy tree."""
    dev = resolve_device(device)
    tree = FuzzyTree(features=_t(emb_tree["features"], np.int32, dev),
                     thresholds=_t(emb_tree["thresholds"], np.float32, dev),
                     centroids=_t(emb_tree["centroids"], np.float32, dev))
    check_features(tree.features, tree.group_dim)
    return PegasusCNNL(bank1=pegasus_linear_from_arrays(**bank1, device=dev),
                       bank2=pegasus_linear_from_arrays(**bank2, device=dev),
                       emb_tree=tree, logit_lut=_t(logit_lut, np.float32, dev),
                       bias=_t(bias, np.float32, dev), index_bits=int(index_bits))


def ae_banks_from_arrays(banks: list[dict], feat_mu, feat_sigma,
                         device: str | torch.device = "cuda") -> AEBanks:
    """The AutoEncoder's bank list with its benign standardization."""
    return AEBanks(banks_from_arrays(banks, device), feat_mu, feat_sigma)


def rnn_teacher_from_arrays(params: dict, num_classes: int, window: int,
                            device: str | torch.device = "cuda") -> RNNB:
    return RNNB(params=_params(params, resolve_device(device)),
                num_classes=int(num_classes), window=int(window))


def cnn_teacher_from_arrays(params: dict, num_classes: int, size: str,
                            device: str | torch.device = "cuda") -> CNNModel:
    """A CNN-B or CNN-M teacher; its widths come from the parameter shapes."""
    p = _params(params, resolve_device(device))
    return CNNModel(params=p, num_classes=int(num_classes), channels=p["w_conv"].shape[1],
                    hidden=p["w_h"].shape[1], size=size)


def cnn_l_teacher_from_arrays(params: dict, num_classes: int,
                              device: str | torch.device = "cuda") -> CNNL:
    p = _params(params, resolve_device(device))
    return CNNL(params=p, num_classes=int(num_classes), emb_dim=p["w_e2"].shape[1])


def ae_from_arrays(params: dict, feat_mu, feat_sigma,
                   device: str | torch.device = "cuda") -> AutoEncoder:
    """An AutoEncoder teacher with its benign feature mean and std."""
    p = _params(params, resolve_device(device))
    return AutoEncoder(params=p, in_dim=p["w_e1"].shape[0],
                       feat_mu=np.asarray(feat_mu, np.float32),
                       feat_sigma=np.asarray(feat_sigma, np.float32))


# ---------------------------------------------------------------------------
# The baselines
# ---------------------------------------------------------------------------


def n3ic_from_arrays(params: dict, mu, sigma, num_classes: int,
                     device: str | torch.device = "cuda") -> N3IC:
    """A trained N3IC: weights ``w0``-``w2`` and the input thresholds."""
    dev = resolve_device(device)
    return N3IC(params=_params(params, dev), num_classes=int(num_classes),
                mu=_t(mu, np.float32, dev), sigma=_t(sigma, np.float32, dev))


def bos_from_arrays(params: dict, num_classes: int,
                    device: str | torch.device = "cuda") -> BoS:
    """A trained BoS: ``w_x``, ``w_h``, ``b`` and ``w_o``."""
    return BoS(params=_params(params, resolve_device(device)), num_classes=int(num_classes))


def leo_from_arrays(feature, threshold, left, right, label, num_classes: int) -> LeoTree:
    """A Leo tree from per-node arrays (``left == -1`` marks a leaf)."""
    nodes = [_Node(feature=int(f), threshold=float(t), left=int(lo), right=int(r),
                   label=int(lab))
             for f, t, lo, r, lab in zip(feature, threshold, left, right, label)]
    return LeoTree(nodes=nodes, num_classes=int(num_classes))


# ---------------------------------------------------------------------------
# The LM stack
# ---------------------------------------------------------------------------


def lm_params_from_arrays(cfg: ArchConfig, params: dict,
                          device: str | torch.device = "cuda") -> Params:
    """An LM (:mod:`repro_torch.models.transformer`) from the reference's
    parameter tree as numpy arrays: nested dicts under the same keys, each
    per-layer array stacked over a leading ``[L, ...]`` axis (``layers``,
    ``enc_layers``). Every array keeps its float type (f32 or bf16)."""
    dev = resolve_device(device)

    def block(tree: dict, l: int | None, name: str = "") -> Params:
        entries = {}
        for key, value in tree.items():
            if isinstance(value, dict):
                entries[key] = block(value, l, key)
            else:
                entries[key] = _t_as_is(value if l is None else np.asarray(value)[l], dev)
        return FFN(cfg.act, **entries) if name == "ffn" else Params(**entries)

    depth = {"layers": cfg.num_layers, "enc_layers": cfg.encoder_layers}
    top = {}
    for key, value in params.items():
        if key in depth:
            top[key] = nn.ModuleList(block(value, l) for l in range(depth[key]))
        else:
            top[key] = _t_as_is(value, dev)
    return Params(**top)


def lm_arrays_from_params(cfg: ArchConfig, params: Params | dict) -> dict:
    """The inverse of :func:`lm_params_from_arrays`: the model's weights as
    nested numpy dicts under the reference's keys, per-layer arrays stacked
    ``[L, ...]``. ``params`` is the model or a flat dict under its parameter
    names (gradients, Adam moments). bf16 comes back as f32 (exact)."""
    named = dict(params.named_parameters()) if isinstance(params, nn.Module) else params
    tree = stack_named(named)
    depth = {"layers": cfg.num_layers, "enc_layers": cfg.encoder_layers}

    def arrays(node: dict, l: int | None) -> dict:
        out = {}
        for key, value in node.items():
            if isinstance(value, dict):
                out[key] = arrays(value, depth.get(key) if l is None else l)
                continue
            if l is not None and value.shape[0] != l:
                raise ValueError(f"{key}: {value.shape[0]} layers, the config has {l}")
            out[key] = (value.float() if value.dtype == torch.bfloat16 else value).numpy()
        return out

    return arrays(tree, None)


def pegasus_ffn_from_arrays(w_in: dict, w_gate: dict | None, w_out: dict, act: str,
                            device: str | torch.device = "cuda") -> PegasusFFN:
    """A PegasusFFN from its banks, each a dict as for
    :func:`pegasus_linear_from_arrays`; each LUT keeps its float type (the
    reference's LM banks hold bf16 LUTs)."""
    def bank(arrays: dict) -> PegasusLinear:
        b = pegasus_linear_from_arrays(**arrays, device=device)
        b.lut = _t_as_is(arrays["lut"], b.lut.device)
        return b

    return PegasusFFN(w_in=bank(w_in), w_gate=None if w_gate is None else bank(w_gate),
                      w_out=bank(w_out), act=act)
