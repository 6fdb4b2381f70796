"""Fuzzy-LUT kernels for Hopper: per-bank and stacked, f32 LUT.

Port of ``repro.kernels.fuzzy_lut.kernel`` (the int8 instances are in
``quantized.py``). Each wrapper launches a
hand-written CUDA kernel (``csrc/fuzzy_lut_bank.cu``,
``csrc/fuzzy_lut_stack.cu``) on a CUDA tensor and runs its plain PyTorch
version, defined beside it, on a CPU tensor. There is no other route: on a
CUDA tensor the wrapper launches the kernel or raises.

The kernels take the split features as int32 node ids ``[K, I]`` (not the
TPU's ``[K, I, v]`` one-hot, which existed to feed its matrix unit), mask
ragged T/N edges themselves, and sum the K terms in ascending k — the order
of the plain versions, so both give the same bits on one device.

``I = C - 1 = 2^d - 1`` internal nodes per tree, ``C`` leaves.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _lib
from .ref import lut_gather_sum, tree_descent_ref

__all__ = ["ROWS_PER_BLOCK", "SMEM_BYTES", "fuzzy_lut", "fuzzy_lut_plain",
           "fuzzy_lut_stack", "fuzzy_lut_stack_plain", "stack_fits"]

# Batch rows one block takes, and the shared memory it may use without an
# opt-in attribute. Rows shrink for wide geometries to stay under it.
ROWS_PER_BLOCK = 16
SMEM_BYTES = 48 * 1024


def _depth(c: int) -> int:
    depth = int(np.log2(c) + 0.5)
    if c < 2 or 2**depth != c:
        raise ValueError(f"centroid count C={c} is not a power of two >= 2")
    return depth


def _rows(bytes_per_row: int, what: str) -> int:
    rows = min(ROWS_PER_BLOCK, SMEM_BYTES // bytes_per_row)
    if rows < 1:
        raise ValueError(f"{what}: one row needs {bytes_per_row} B of shared "
                         f"memory, more than {SMEM_BYTES}")
    return rows


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


def _bank_launch(x, features, thresholds, lut, depth, return_leaves):
    t, k, v = x.shape
    n = lut.shape[2]
    y = torch.empty((t, n), dtype=torch.float32, device=x.device)
    leaves = (torch.empty((t, k), dtype=torch.int32, device=x.device)
              if return_leaves else None)
    if t:
        ptrs = [x, features, thresholds, lut]
        _cuda_call("fuzzy_lut_f32", x.device, *(p.data_ptr() for p in ptrs),
                   y.data_ptr(), None if leaves is None else leaves.data_ptr(),
                   t, k, v, depth, n, _rows(4 * k, "fuzzy_lut_f32"))
        _lib.LAUNCHES["fuzzy_lut"] += 1
    return (y, leaves) if return_leaves else y


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
    return _bank_launch(x, features, thresholds, lut, depth, return_leaves)


# ---------------------------------------------------------------------------
# Stacked kernel (replaces fuzzy_lut_stack_pallas; the int8 instance is in
# quantized.py)
# ---------------------------------------------------------------------------


def stack_fits(k0: int, v: int, kmax: int, nmax: int, layers: int) -> bool:
    """Can the stacked kernel take this geometry (layer count and shared
    memory for one row)?"""
    width = max(k0 * v, nmax)
    return layers <= _lib.MAX_L and 4 * (width + kmax) <= SMEM_BYTES


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


def _stack_launch(x, features, thresholds, lut, bias, ks, n_out, depth,
                  return_leaves):
    t, k0, v = x.shape
    nl, kmax, _, nmax = lut.shape
    y = torch.empty((t, n_out), dtype=torch.float32, device=x.device)
    # padded groups are never walked; they would land on leaf 0
    leaves = (torch.zeros((nl, t, kmax), dtype=torch.int32, device=x.device)
              if return_leaves else None)
    if t:
        width = max(k0 * v, nmax)
        geom = _lib.StackGeom(L=nl, k0=k0, kmax=kmax, nmax=nmax, n_out=n_out,
                              v=v, depth=depth, width=width)
        geom.ks[:nl] = list(ks)
        ptrs = [x, features, thresholds, lut, bias]
        _cuda_call("fuzzy_lut_stack_f32", x.device, *(p.data_ptr() for p in ptrs),
                   y.data_ptr(), None if leaves is None else leaves.data_ptr(),
                   t, geom, _rows(4 * (width + kmax), "fuzzy_lut_stack_f32"))
        _lib.LAUNCHES["fuzzy_lut_stack"] += 1
    return (y, leaves) if return_leaves else y


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
    return _stack_launch(x, features, thresholds, lut, bias, ks, n_out, depth,
                         return_leaves)
