"""Fuzzy-LUT kernels for Hopper: per-bank and stacked, f32 LUT.

Port of ``repro.kernels.fuzzy_lut.kernel`` (the int8 instances are in
``quantized.py``). Each wrapper launches the hand-written CUDA kernel of
``csrc/fuzzy_lut_f32.cuh`` (the bank is its one-layer case) on a CUDA
tensor and runs its plain PyTorch version, defined beside it, on a CPU
tensor. There is no other route: on a CUDA tensor the wrapper launches the
kernel or raises. What the kernel keeps where (the row in registers or in
shared memory, the trees node-major in shared memory or read through L1)
is decided here from the shapes by :func:`plan_f32`.

The kernels take the split features as int32 node ids ``[K, I]`` (not the
TPU's ``[K, I, v]`` one-hot, which existed to feed its matrix unit), mask
ragged T/N edges themselves, and sum the K terms in ascending k — the order
of the plain versions, so both give the same bits on one device.

``I = C - 1 = 2^d - 1`` internal nodes per tree, ``C`` leaves.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from . import _lib
from .ref import lut_gather_sum, tree_descent_ref

__all__ = ["F32Plan", "SMEM_PER_BLOCK", "STACK_ROW_BYTES", "f32_geom", "f32_launch_shape",
           "fuzzy_lut", "fuzzy_lut_plain", "fuzzy_lut_stack",
           "fuzzy_lut_stack_plain", "plan_f32", "stack_fits"]

# The fusion cap: one row's activations and leaves of a stack, in bytes.
# It decides which runs of banks fuse (engine/plan.py: fuse_banks), so it
# stays where the first stacked kernel put it.
STACK_ROW_BYTES = 48 * 1024
# Shared memory one block may opt into on Hopper (227 KB), for both kernel
# designs. For the f32 one: the rows (warps) of a block, the tree row
# pitch's multiple, and the LUT loads issued before the first add
# (csrc/fuzzy_lut_f32.cuh: F32_CHUNK).
SMEM_PER_BLOCK = 232448
F32_MAX_ROWS = 32
TREE_PITCH = 16
F32_CHUNK = 16


def _depth(c: int) -> int:
    depth = int(np.log2(c) + 0.5)
    if c < 2 or 2**depth != c:
        raise ValueError(f"centroid count C={c} is not a power of two >= 2")
    return depth


def _pad(n: int, to: int = 16) -> int:
    return -(-n // to) * to


@dataclass(frozen=True)
class F32Plan:
    """Where an f32 launch keeps what (``struct F32Geom``).

    ``regs``: every layer's input row (``K*v``) fits a warp, one value per
    lane, so the activations stay in registers; else each warp keeps a
    ``width``-float row in shared memory (0 for a lone layer, which reads
    its input row from global memory). Each warp keeps the LUT row indices
    of its groups in a ``kstride``-int row (the largest group count rounded
    up to ``F32_CHUNK``). ``kpad`` > 0: every layer's trees are copied into
    shared memory and transposed there to node-major words with that row
    pitch (``tree_bytes`` for both); 0: the descent reads them through L1.
    ``max_rows``: warps (rows) per block.
    """

    regs: bool
    width: int
    kstride: int
    kpad: int
    tree_bytes: int
    max_rows: int

    @property
    def row_bytes(self) -> int:
        return 4 * (self.width + self.kstride)

    def smem_bytes(self, rows: int) -> int:
        return self.tree_bytes + rows * self.row_bytes


@functools.lru_cache(maxsize=256)
def plan_f32(ks: tuple[int, ...], v: int, depth: int, kmax: int) -> F32Plan:
    """Plan an f32 launch over layers of ``ks`` groups (a bank is
    ``ks=(K,)``) whose operand stacks hold ``kmax`` groups. Raises
    ``ValueError`` when one row does not fit a block's shared memory."""
    i, kbig = 2**depth - 1, max(ks)
    regs = all(k * v <= 32 for k in ks)
    width = 0 if regs or len(ks) == 1 else _pad(max(k * v for k in ks), 4)
    kstride = _pad(kbig, F32_CHUNK)
    row_bytes = 4 * (width + kstride)
    max_rows = min(F32_MAX_ROWS, SMEM_PER_BLOCK // row_bytes)
    if max_rows < 1:
        raise ValueError(f"f32 fuzzy-LUT kernel: one row needs {row_bytes} B of "
                         f"shared memory, more than {SMEM_PER_BLOCK}")
    kpad = _pad(kbig, TREE_PITCH)
    tree_bytes = 16 * i * kpad * len(ks)
    if tree_bytes + max_rows * row_bytes > SMEM_PER_BLOCK:
        kpad, tree_bytes = 0, 0                   # trees through L1
    return F32Plan(regs, width, kstride, kpad, tree_bytes, max_rows)


_N_SM: dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _N_SM:
        _N_SM[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _N_SM[idx]


def f32_launch_shape(plan: F32Plan, t: int, n_sm: int) -> tuple[int, int, int, int]:
    """(rows per block, grid, threads, shared bytes) of a launch over ``t``
    rows: one warp per row, about one block per SM (MLP-B's bucket of 4096
    rows is 128 blocks of 32 on 132 SMs: one wave)."""
    rows = max(1, min(plan.max_rows, -(-t // n_sm)))
    return rows, -(-t // rows), 32 * rows, plan.smem_bytes(rows)


def f32_geom(plan: F32Plan, ks, k0, kmax, nmax, n_out, v, depth) -> _lib.F32Geom:
    """The kernel's by-value geometry of a launch planned by ``plan``."""
    geom = _lib.F32Geom(L=len(ks), k0=k0, kmax=kmax, nmax=nmax, n_out=n_out, v=v,
                        depth=depth, kpad=plan.kpad, regs=int(plan.regs),
                        width=plan.width, kstride=plan.kstride)
    geom.ks[:len(ks)] = list(ks)
    return geom


# the launch counter of each f32 C entry
_COUNTER = {"fuzzy_lut_f32": "fuzzy_lut", "fuzzy_lut_stack_f32": "fuzzy_lut_stack"}


def _launch_f32(fn_name, x, features, thresholds, lut, bias, ks, n_out, depth, leaves):
    """Plan and launch ``fn_name`` (one bank, or a stack when ``bias`` is
    given); returns ``y [T, n_out]``. ``leaves`` is None or an int32
    ``[L, T, Kmax]`` (a bank's ``[T, K]``) output."""
    t, k0, v = x.shape
    kmax, nmax = lut.shape[-3], lut.shape[-1]
    y = torch.empty((t, n_out), dtype=torch.float32, device=x.device)
    if not t:
        return y
    plan = plan_f32(tuple(ks), v, depth, kmax)
    _, grid, threads, smem = f32_launch_shape(plan, t, _sm_count(x.device))
    geom = f32_geom(plan, ks, k0, kmax, nmax, n_out, v, depth)
    args = [x, features, thresholds, lut] + ([bias] if bias is not None else [])
    _cuda_call(fn_name, x.device, *(p.data_ptr() for p in args), y.data_ptr(),
               None if leaves is None else leaves.data_ptr(), t, geom, grid,
               threads, smem)
    _lib.count_launch(_COUNTER[fn_name])
    return y


def _expect(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_tensors(where: str, device: torch.device, **tensors) -> None:
    for name, (t, dtype) in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{where}: {name} must be a torch.Tensor")
        _expect(t.dtype == dtype, f"{where}: {name} must be {dtype}, got {t.dtype}")
        _expect(t.device == device,
                f"{where}: {name} lies on {t.device}, x on {device}")
        _expect(t.is_contiguous(), f"{where}: {name} must be contiguous")


def _cuda_call(fn_name: str, device: torch.device, *args) -> None:
    """Launch ``fn_name`` on the current stream of ``device``; raise on a
    CUDA error."""
    _expect(device.type == "cuda",
            f"{fn_name}: tensors on {device}; the kernel runs on CUDA, its "
            "plain version on the CPU")
    fn = _lib.library(fn_name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _lib.check_status(fn(*args, stream), fn_name)


# ---------------------------------------------------------------------------
# Per-bank kernel (replaces fuzzy_lut_pallas; the int8 instance is in
# quantized.py)
# ---------------------------------------------------------------------------


def _check_bank(where, x, features, thresholds, lut, lut_dtype, scales=None):
    _check_tensors(where, x.device, x=(x, torch.float32),
                   features=(features, torch.int32),
                   thresholds=(thresholds, torch.float32), lut=(lut, lut_dtype))
    _expect(x.dim() == 3 and lut.dim() == 3 and features.dim() == 2,
            f"{where}: expected x [T,K,v], features [K,I], lut [K,C,N]")
    k, c = lut.shape[0], lut.shape[1]
    _expect(x.shape[1] == k and features.shape == (k, c - 1)
            and thresholds.shape == features.shape,
            f"{where}: shapes x {tuple(x.shape)}, features "
            f"{tuple(features.shape)}, thresholds {tuple(thresholds.shape)}, "
            f"lut {tuple(lut.shape)} disagree")
    if scales is not None:
        _check_tensors(where, x.device, scales=(scales, torch.float32))
        _expect(scales.shape == (k,), f"{where}: scales must be [K]")
    return _depth(c)


def _bank_plain(x, features, thresholds, lut, scales):
    leaves = tree_descent_ref(x, features, thresholds)
    return lut_gather_sum(lut, leaves, scales), leaves


def fuzzy_lut_plain(x, features, thresholds, lut):
    """Plain version of the per-bank f32 kernel: ``(y [T,N], leaves [T,K])``."""
    return _bank_plain(x, features, thresholds, lut, None)


def fuzzy_lut(x: torch.Tensor, features: torch.Tensor,
              thresholds: torch.Tensor, lut: torch.Tensor, *,
              return_leaves: bool = False):
    """``y[t, n] = Σ_k lut[k, leaf_k(x[t, k]), n]`` (no bias), f32 LUT.

    ``x`` f32 ``[T, K, v]``, ``features`` int32 ``[K, I]`` with ids in
    ``[0, v)`` (checked once where layouts are built, not per call),
    ``thresholds`` f32 ``[K, I]``, ``lut`` f32 ``[K, C, N]``. With
    ``return_leaves`` also the int32 leaves ``[T, K]``.
    """
    depth = _check_bank("fuzzy_lut", x, features, thresholds, lut, torch.float32)
    if x.device.type == "cpu":
        y, leaves = fuzzy_lut_plain(x, features, thresholds, lut)
        return (y, leaves.to(torch.int32)) if return_leaves else y
    t, k, _ = x.shape
    leaves = (torch.empty((t, k), dtype=torch.int32, device=x.device)
              if return_leaves else None)
    y = _launch_f32("fuzzy_lut_f32", x, features, thresholds, lut, None, (k,),
                    lut.shape[2], depth, leaves)
    return (y, leaves) if return_leaves else y


# ---------------------------------------------------------------------------
# Stacked kernel (replaces fuzzy_lut_stack_pallas; the int8 instance is in
# quantized.py)
# ---------------------------------------------------------------------------


def stack_fits(k0: int, v: int, kmax: int, nmax: int, layers: int) -> bool:
    """Can the stacked kernel take this geometry (layer count and shared
    memory for one row)?"""
    width = max(k0 * v, nmax)
    return layers <= _lib.MAX_L and 4 * (width + kmax) <= STACK_ROW_BYTES


def _check_stack(where, x, features, thresholds, lut, lut_dtype, bias, ks,
                 n_out, scales=None):
    _check_tensors(where, x.device, x=(x, torch.float32),
                   features=(features, torch.int32),
                   thresholds=(thresholds, torch.float32), lut=(lut, lut_dtype),
                   bias=(bias, torch.float32))
    _expect(x.dim() == 3 and lut.dim() == 4,
            f"{where}: expected x [T,K0,v] and lut [L,Kmax,C,Nmax]")
    nl, kmax, c, nmax = lut.shape
    _, k0, v = x.shape
    _expect(features.shape == (nl, kmax, c - 1)
            and thresholds.shape == features.shape and bias.shape == (nl, nmax),
            f"{where}: operand stack shapes disagree with lut {tuple(lut.shape)}")
    _expect(len(ks) == nl, f"{where}: ks has {len(ks)} entries for {nl} layers")
    _expect(ks[0] == k0, f"{where}: x carries K={k0} groups; ks[0]={ks[0]}")
    _expect(all(1 <= k <= kmax for k in ks), f"{where}: ks {ks} exceed Kmax={kmax}")
    _expect(all(k * v <= nmax for k in ks[1:]) and 1 <= n_out <= nmax,
            f"{where}: layer widths exceed Nmax={nmax}")
    _expect(stack_fits(k0, v, kmax, nmax, nl),
            f"{where}: {nl} layers (max {_lib.MAX_L}) or row width "
            f"{max(k0 * v, nmax)}+{kmax} too large for the stacked kernel")
    if scales is not None:
        _check_tensors(where, x.device, scales=(scales, torch.float32))
        _expect(scales.shape == (nl, kmax), f"{where}: scales must be [L, Kmax]")
    return _depth(c)


def _stack_plain(x, features, thresholds, lut, bias, ks, n_out, scales):
    t, _, v = x.shape
    kmax = lut.shape[1]
    h = torch.nn.functional.pad(x, (0, 0, 0, kmax - x.shape[1]))
    all_leaves = []
    for l in range(len(ks)):
        leaves = tree_descent_ref(h, features[l], thresholds[l])
        all_leaves.append(leaves)
        y = lut_gather_sum(lut[l], leaves,
                           None if scales is None else scales[l]) + bias[l]
        if l + 1 < len(ks):
            nk = ks[l + 1]
            h = torch.nn.functional.pad(y[:, : nk * v].reshape(t, nk, v),
                                        (0, 0, 0, kmax - nk))
    return y[:, :n_out], torch.stack(all_leaves)


def fuzzy_lut_stack_plain(x, features, thresholds, lut, bias, ks, n_out):
    """Plain version of the stacked f32 kernel:
    ``(y [T, n_out], leaves [L, T, Kmax])``."""
    return _stack_plain(x, features, thresholds, lut, bias, ks, n_out, None)


def fuzzy_lut_stack(x: torch.Tensor, features: torch.Tensor,
                    thresholds: torch.Tensor, lut: torch.Tensor,
                    bias: torch.Tensor, *, ks: tuple[int, ...], n_out: int,
                    return_leaves: bool = False):
    """Cross-bank Primitive Fusion: L banks in ONE launch, bias applied.

    ``x`` f32 ``[T, K0, v]``; stacks ``features`` int32 ``[L, Kmax, I]``,
    ``thresholds`` f32 ``[L, Kmax, I]``, ``lut`` f32 ``[L, Kmax, C, Nmax]``,
    ``bias`` f32 ``[L, Nmax]``, padded groups with +inf thresholds and zero
    rows; ``ks`` the true group count per layer, ``n_out`` the last layer's
    true width. Layer l's output feeds layer l+1 as ``[T, ks[l+1], v]``.
    Returns ``[T, n_out]`` (and int32 leaves ``[L, T, Kmax]``).
    """
    ks = tuple(int(k) for k in ks)
    depth = _check_stack("fuzzy_lut_stack", x, features, thresholds, lut,
                         torch.float32, bias, ks, n_out)
    if x.device.type == "cpu":
        y, leaves = fuzzy_lut_stack_plain(x, features, thresholds, lut, bias,
                                          ks, n_out)
        return (y, leaves.to(torch.int32)) if return_leaves else y
    nl, kmax = lut.shape[:2]
    # padded groups are never walked; they would land on leaf 0
    leaves = (torch.zeros((nl, x.shape[0], kmax), dtype=torch.int32,
                          device=x.device) if return_leaves else None)
    y = _launch_f32("fuzzy_lut_stack_f32", x, features, thresholds, lut, bias, ks,
                    n_out, depth, leaves)
    return (y, leaves) if return_leaves else y
