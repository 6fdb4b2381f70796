"""PegasusLinear — the paper's MatMul-as-primitives (port of
``repro.core.amm``).

Weighted Aggregation (paper §5) decomposes ``y = x @ W + b`` as Partition
(groups of ``v`` features) → Map (``LUT_k[fuzzy_index(x_k)]``) → SumReduce
(``Σ_k``, ``+ b``). The multiplications happen offline when the LUT is
built; inference is comparisons, lookups and adds.

Three plain apply paths live here; the hand-written CUDA kernels are in
:mod:`repro_torch.kernels.fuzzy_lut` (``pegasus_linear_apply`` reaches them
as paths ``kernel`` and ``kernel_q8``):
  * ``apply_gather`` — descent + row gather + ascending-k sum (the oracle
    order, see :mod:`repro_torch.kernels.fuzzy_lut.ref`),
  * ``apply_onehot`` — one-hot × LUT as one fp32 matmul (TF32 is switched
    off where the engine builds its plans),
  * ``apply_soft`` — the differentiable path of backprop refinement.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.fuzzy_lut import ops
from repro_torch.kernels.fuzzy_lut.ref import lut_gather_sum

from .fuzzy_tree import FuzzyTree, fit_tree, hard_index_stacked, soft_index_stacked, stack_trees
from .lut import build_matmul_lut
from .quantization import choose_qspec, fake_quant_spec

__all__ = ["PegasusLinear", "init_pegasus_linear", "init_pegasus_bank", "fit_group_trees",
           "apply_gather",
           "apply_onehot", "apply_soft", "pegasus_linear_apply", "dense_reference"]


@dataclasses.dataclass
class PegasusLinear:
    """Parameters of one Pegasus-approximated linear layer.

    Attributes:
      trees: stacked fuzzy trees — features ``[K, 2^d - 1]`` int32,
        thresholds ``[K, 2^d - 1]`` f32, centroids ``[K, C, v]`` f32.
      lut: ``[K, C, N]`` precomputed partial products.
      bias: ``[N]`` or None.
      group_size: the Partition width ``v``.
    """

    trees: FuzzyTree
    lut: torch.Tensor
    bias: torch.Tensor | None
    group_size: int = 0

    @property
    def num_groups(self) -> int:
        return self.lut.shape[0]

    @property
    def num_centroids(self) -> int:
        return self.lut.shape[1]

    @property
    def out_features(self) -> int:
        return self.lut.shape[2]

    @property
    def in_features(self) -> int:
        return self.num_groups * self.group_size

    @property
    def device(self) -> torch.device:
        return self.lut.device

    def to(self, device) -> "PegasusLinear":
        return PegasusLinear(
            trees=self.trees.to(device), lut=self.lut.to(device),
            bias=None if self.bias is None else self.bias.to(device),
            group_size=self.group_size)

    def compile(self, *, backend: str = "onehot", **kw):
        """This layer as a single-bank ExecutionPlan (``repro_torch.engine``)
        on its own device unless ``device=`` says otherwise: kernel layouts
        and the int8 LUT built once, the backend bound."""
        from repro_torch.engine import build_plan

        return build_plan(self, backend=backend, **{"device": self.device, **kw})


# A bank of at least this many groups fits its trees in worker processes (LM
# FFN banks: hundreds to thousands of trees, minutes on one core); smaller
# banks fit in this process, where starting workers would cost more. At most
# _POOL_MAX_WORKERS workers start, each importing torch.
_POOL_MIN_GROUPS = 256
_POOL_MAX_WORKERS = 16


def _fit_arrays(data: np.ndarray, depth: int) -> tuple[np.ndarray, ...]:
    tree = fit_tree(data, depth)
    return tree.features.numpy(), tree.thresholds.numpy(), tree.centroids.numpy()


def fit_group_trees(calibration: np.ndarray, group_size: int, depth: int) -> FuzzyTree:
    """One tree per group of ``group_size`` columns of ``calibration``
    ``[S, D]``, stacked (CPU tensors). From :data:`_POOL_MIN_GROUPS` groups
    on, the groups are fit in spawned processes, one per CPU;
    ``fit_tree`` is deterministic numpy, so the trees are the serial
    fit's, bit for bit."""
    d = calibration.shape[1]
    if d % group_size:
        raise ValueError(f"D={d} not divisible by group v={group_size}")
    groups = [calibration[:, g * group_size : (g + 1) * group_size]
              for g in range(d // group_size)]
    workers = min(os.cpu_count() or 1, _POOL_MAX_WORKERS)
    if len(groups) < _POOL_MIN_GROUPS or workers < 2:
        return stack_trees([fit_tree(x, depth) for x in groups])
    with ProcessPoolExecutor(max_workers=workers,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        fitted = list(pool.map(_fit_arrays, groups, [depth] * len(groups),
                               chunksize=-(-len(groups) // (4 * workers))))
    return FuzzyTree(*(torch.from_numpy(np.stack(parts)) for parts in zip(*fitted)))


def init_pegasus_linear(
    weight: np.ndarray,
    bias: np.ndarray | None,
    calibration: np.ndarray,
    *,
    group_size: int = 4,
    depth: int = 4,
    lut_bits: int | None = 16,
    lut_dtype: torch.dtype = torch.float32,
    act_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
    device: str | torch.device = "cuda",
) -> PegasusLinear:
    """Build a PegasusLinear from a trained dense layer + calibration acts.

    ``weight`` ``[D, N]``, ``bias`` ``[N]`` or None, ``calibration``
    ``[S, D]`` (numpy; the trees are fit in numpy, bit-identical to the
    reference's). ``act_fn`` maps the stacked centroids ``[K, C, v]``
    before the matmul (Basic Primitive Fusion: ``LUT = act(c) @ W``);
    ``lut_bits`` stores the LUT on that fixed-point grid (None keeps f32).
    """
    dev = resolve_device(device)
    weight = np.asarray(weight, np.float32)
    calibration = np.asarray(calibration, np.float32)
    if weight.shape[0] != calibration.shape[1]:
        raise ValueError(f"weight {weight.shape} does not take calibration rows "
                         f"of width {calibration.shape[1]}")
    stacked = fit_group_trees(calibration, group_size, depth).to(dev)
    cents = stacked.centroids
    if act_fn is not None:
        cents = act_fn(cents)
    lut = build_matmul_lut(cents, torch.as_tensor(weight, device=dev), group_size)
    if lut_bits is not None:
        lut = fake_quant_spec(lut, choose_qspec(lut, bits=lut_bits))
    return PegasusLinear(
        trees=stacked,
        lut=lut.to(lut_dtype),
        bias=None if bias is None else torch.as_tensor(
            np.asarray(bias, np.float32), device=dev),
        group_size=group_size,
    )


def init_pegasus_bank(
    fn: Callable[[torch.Tensor], torch.Tensor],
    calibration: np.ndarray,
    *,
    group_size: int,
    depth: int,
    bias: np.ndarray | None = None,
    device: str | torch.device = "cuda",
) -> PegasusLinear:
    """Generic table bank: LUT rows are ``fn`` of the stacked centroids.

    ``fn: [K, C, v] → [K, C, N]`` may be any offline computation on
    ``device`` — a whole per-window sub-network for Advanced-Fusion/NAM
    banks (paper Fig. 5 ③), or a post-matmul nonlinearity fold for a
    single-group bank (``K == 1``: the SumReduce is trivial, so
    ``relu(c@W+b)`` may live in the rows directly).
    """
    dev = resolve_device(device)
    stacked = fit_group_trees(np.asarray(calibration, np.float32), group_size, depth).to(dev)
    k = stacked.features.shape[0]
    lut = fn(stacked.centroids).to(torch.float32)
    if lut.dim() != 3 or tuple(lut.shape[:2]) != (k, 2**depth):
        raise ValueError(f"fn returned rows of shape {tuple(lut.shape)}; "
                         f"expected [{k}, {2**depth}, N]")
    return PegasusLinear(
        trees=stacked, lut=lut.contiguous(),
        bias=None if bias is None else torch.as_tensor(
            np.asarray(bias, np.float32), device=dev),
        group_size=group_size)


def _group(x: torch.Tensor, k: int, v: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], k, v)


def apply_gather(p: PegasusLinear, x: torch.Tensor) -> torch.Tensor:
    """Reference path: hard index + row gather + ascending-k sum."""
    xg = _group(x.to(torch.float32), p.num_groups, p.group_size)
    idx = hard_index_stacked(p.trees, xg).reshape(-1, p.num_groups)
    y = lut_gather_sum(p.lut, idx).reshape(*x.shape[:-1], p.out_features)
    # the reference sums a bf16 LUT's rows to a bf16 result, then upcasts
    y = y.to(p.lut.dtype).to(torch.float32)
    if p.bias is not None:
        y = y + p.bias
    return y


def apply_onehot(p: PegasusLinear, x: torch.Tensor) -> torch.Tensor:
    """SumReduce(Map(...)) as ONE matmul: ``onehot(idx) [.., K·C]`` times
    ``LUT [K·C, N]``."""
    xg = _group(x.to(torch.float32), p.num_groups, p.group_size)
    idx = hard_index_stacked(p.trees, xg)                       # [..., K]
    oh = torch.nn.functional.one_hot(idx, p.num_centroids).to(p.lut.dtype)
    oh = oh.reshape(*x.shape[:-1], p.num_groups * p.num_centroids)
    y = (oh @ p.lut.reshape(-1, p.out_features)).to(torch.float32)
    if p.bias is not None:
        y = y + p.bias
    return y


def apply_soft(p: PegasusLinear, x: torch.Tensor, temperature: float = 0.1) -> torch.Tensor:
    """Differentiable path for backprop refinement (paper §4.4): the soft
    leaf distributions ``[..., K, C]`` contracted with the LUT in fp32."""
    xg = _group(x.to(torch.float32), p.num_groups, p.group_size)
    probs = soft_index_stacked(p.trees, xg, temperature)
    y = torch.einsum("...kc,kcn->...n", probs, p.lut.to(torch.float32))
    if p.bias is not None:
        y = y + p.bias
    return y


def pegasus_linear_apply(p: PegasusLinear, x: torch.Tensor, *,
                         path: str = "onehot") -> torch.Tensor:
    """Apply one layer on ``path``: ``gather``, ``onehot``, ``soft``, or the
    CUDA kernels ``kernel`` (f32 LUT) and ``kernel_q8`` (int8 LUT), which
    run their plain versions on CPU tensors."""
    if path == "gather":
        return apply_gather(p, x)
    if path == "onehot":
        return apply_onehot(p, x)
    if path == "soft":
        return apply_soft(p, x)
    if path == "kernel":
        return ops.fuzzy_lut_matmul(p, x)
    if path == "kernel_q8":
        return ops.fuzzy_lut_matmul_q8(p, x)
    raise ValueError(f"unknown path {path}")


def dense_reference(weight: torch.Tensor, bias: torch.Tensor | None,
                    x: torch.Tensor) -> torch.Tensor:
    """The dense layer ``x @ W (+ b)`` a PegasusLinear approximates."""
    y = x @ weight
    return y if bias is None else y + bias
