"""int8-LUT instances of the fuzzy-LUT kernels (port of
``repro.kernels.fuzzy_lut.quantized``).

LUT rows are stored int8 with one f32 scale per partition group:
``y = Σ_k s_k · LUT8[k, leaf_k]``. Each term is ``float(q) * s_k``
rounded on its own, summed in ascending k: bit-equal to the plain version.

On a CUDA tensor both wrappers launch ``csrc/fuzzy_lut_q8.cuh`` (the bank
is its one-layer case): operands staged into a two-slot shared-memory
ring by bulk async copies, persistent blocks, one warp per row. What the
kernel stages, and how, is decided here from the shapes by
:func:`plan_q8`, once per geometry; on a CPU tensor the wrappers run the
plain versions.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import torch

from . import _lib
from .kernel import (
    SMEM_PER_BLOCK, _bank_plain, _check_bank, _check_stack, _cuda_call, _depth, _pad,
    _sm_count, _stack_plain,
)

__all__ = ["Q8Plan", "Q8Stage", "Q8_SMEM_BYTES", "launch_plan", "launch_shape",
           "quantize_lut_int8",
           "fuzzy_lut_q8", "fuzzy_lut_q8_plain", "fuzzy_lut_stack_q8",
           "fuzzy_lut_stack_q8_plain", "launch_q8", "plan_q8", "stage_q8"]

# Shared memory one block may opt into on Hopper (227 KB), and the part of
# it the mbarriers take (csrc/fuzzy_lut_q8.cuh: Q8_BAR_BYTES).
Q8_SMEM_BYTES = SMEM_PER_BLOCK
Q8_BAR_BYTES = 128
# At most this much holds the rows' activations and leaves (at least one
# row); the rest is the two ring slots.
Q8_RESIDENT_BYTES = 32 * 1024
Q8_MAX_WARPS = 32
Q8_DESC = 14            # ints per stage descriptor (csrc/fuzzy_lut_q8.cuh)
BULK_ALIGN = 16

# Stage flags and bulk-copy bits; csrc/fuzzy_lut_q8.cuh defines the same.
DESCENT, TREES, GATHER, LUT, FULLROW = 1, 2, 4, 8, 16
B_FEAT, B_THR, B_SCALE, B_BIAS, B_LUT = 1, 2, 4, 8, 16


@dataclass(frozen=True)
class Q8Stage:
    """One fill of a ring slot, and the work done on it.

    ``flags``: DESCENT walks the layer's ``groups`` trees (from the slot if
    TREES, else from global memory) and keeps each leaf as its LUT row
    offset ``(k*C + leaf) * lpitch`` (the leaf itself when ``lpitch`` is 0:
    the LUT is read from global memory); GATHER computes columns
    ``[n0, n0 + nt)`` from the LUT in the slot if LUT (``pitch`` bytes per
    ``(k, leaf)`` row; whole ``Nmax``-wide rows if FULLROW), else from
    global memory. ``off_*`` are byte offsets in the slot, ``bulk`` the
    parts copied by bulk async copies (the others are copied
    cooperatively), ``tx`` the bytes those copies bring.
    """

    layer: int
    flags: int
    groups: int
    n0: int = 0
    nt: int = 0
    pitch: int = 0
    lpitch: int = 0
    off_feat: int = 0
    off_thr: int = 0
    off_scale: int = 0
    off_bias: int = 0
    off_lut: int = 0
    bulk: int = 0
    tx: int = 0
    nbytes: int = 0

    def row(self) -> list[int]:
        """The kernel's descriptor (``Q8_DESC`` ints)."""
        return [self.layer, self.flags, self.n0, self.nt, self.pitch,
                self.off_feat, self.off_thr, self.off_scale, self.off_bias,
                self.off_lut, self.bulk, self.tx, self.groups, self.lpitch]


@dataclass(frozen=True)
class Q8Plan:
    stages: tuple[Q8Stage, ...]
    fills: tuple[tuple[int, int], ...]  # ring fills: (first stage, count)
    slot_bytes: int     # the largest fill
    width: int          # activation row width (floats, a multiple of 4)
    kstride: int        # leaf row width (ints, Kmax rounded up to 4)
    max_rows: int       # rows the resident share holds

    @property
    def table_bytes(self) -> int:
        """Shared bytes of the stage table (``q8_table_bytes``)."""
        return _pad(4 * (Q8_DESC * len(self.stages) + 2 * len(self.fills)))

    @property
    def row_bytes(self) -> int:
        return 4 * (self.width + self.kstride)

    def rows_for(self, t: int, n_sm: int) -> int:
        """Rows per chunk for a batch of ``t``: about one chunk per SM."""
        return max(1, min(self.max_rows, -(-t // n_sm)))

    def smem_bytes(self, rows: int) -> int:
        return (Q8_BAR_BYTES + self.table_bytes + 2 * self.slot_bytes
                + rows * self.row_bytes)


def _pack(parts):
    """Lay ``(bit, nbytes, src_byte_address_mod_16[, slot bytes])`` parts
    out at 16-byte offsets. Returns (offsets, total bytes, bulk mask, bulk
    bytes): a part goes by bulk copy when its source address and size are
    multiples of 16 (its slot offset always is)."""
    offs, total, bulk, tx = [], 0, 0, 0
    for bit, nbytes, src_mod, *room in parts:
        offs.append(total)
        total += _pad(max([nbytes, *room]))
        if nbytes and nbytes % BULK_ALIGN == 0 and src_mod % BULK_ALIGN == 0:
            bulk |= bit
            tx += nbytes
    return offs, total, bulk, tx


@functools.lru_cache(maxsize=256)
def plan_q8(ks: tuple[int, ...], v: int, depth: int, kmax: int, nmax: int,
            n_out: int, *, has_bias: bool,
            align: tuple[int, ...] = (0, 0, 0, 0, 0)) -> Q8Plan:
    """Cut an int8 stack (a bank is ``ks=(K,)``, ``nmax=n_out=N``, no bias)
    into ring stages.

    ``align`` gives the byte addresses mod 16 of the features, thresholds,
    scales, bias and LUT tensors. Per layer, the trees come in a stage of
    their own, so the descent overlaps the LUT's copy (where they do not
    fit a slot, the descent reads them from global memory), then the LUT
    with the scales and bias: whole ``Nmax``-wide rows where they fit a
    slot and go by one bulk copy, else column tiles of a multiple of 16
    columns where every row segment goes by bulk copy (the width, ``Nmax``
    and the LUT's address multiples of 16 bytes), else one stage of scales
    and bias whose columns read the LUT through L1: no LUT is copied into a
    slot cooperatively. Raises ``ValueError`` when one row's activations
    and leaves do not fit. The ring's slots share the block's shared memory
    with the rows and the stage table.
    """
    nl = len(ks)
    width = _pad(max([ks[0] * v] + [ks[l + 1] * v for l in range(nl - 1)]), 4)
    kstride = _pad(kmax, 4)
    row_bytes = 4 * (width + kstride)
    max_rows = max(1, Q8_RESIDENT_BYTES // row_bytes)
    table = 0                    # shared bytes kept for the stage table
    while True:
        cap = (Q8_SMEM_BYTES - Q8_BAR_BYTES - table - max_rows * row_bytes) // 2
        cap -= cap % BULK_ALIGN
        if cap < 2 * BULK_ALIGN + 4 * (kmax + nmax):
            raise ValueError(f"int8 fuzzy-LUT kernel: one row needs {row_bytes} B "
                             f"of shared memory; too wide (K={kmax}, width={width})")
        stages, fills, slot = _group_fills(
            _layer_stages(ks, v, depth, kmax, nmax, n_out, has_bias, align, cap), cap)
        plan = Q8Plan(stages, fills, slot, width, kstride, max_rows)
        if plan.table_bytes <= table:
            return plan
        table = plan.table_bytes


def _layer_stages(ks, v, depth, kmax, nmax, n_out, has_bias, align, cap):
    """Each layer's stages, with slot offsets from 0, none over ``cap``."""
    c = 2**depth
    i = c - 1
    nl = len(ks)
    a_feat, a_thr, a_sc, a_bias, a_lut = align
    stages = []
    for l, k in enumerate(ks):
        n_eff = n_out if l == nl - 1 else ks[l + 1] * v
        lk = l * kmax
        lut_src = a_lut + lk * c * nmax

        def stage(flags, parts, n0=0, nt=0, pitch=0, lpitch=0):
            offs, total, bulk, tx = _pack(parts)
            assert total <= cap
            named = {}
            if flags & TREES:
                named.update(off_feat=offs[0], off_thr=offs[1])
                offs = offs[2:]
            if flags & GATHER:
                named.update(off_scale=offs[0], off_bias=offs[1], off_lut=offs[2])
            return Q8Stage(l, flags, k, n0, nt, pitch, lpitch, bulk=bulk, tx=tx,
                           nbytes=total, **named)

        def gather_parts(n0, nt, lut_bytes, lut_mod, lut_room=0):
            return [(B_SCALE, 4 * k, a_sc + 4 * lk),
                    (B_BIAS, 4 * nt if has_bias else 0, a_bias + 4 * (l * nmax + n0)),
                    (B_LUT, lut_bytes, lut_mod, lut_room)]

        # the LUT: whole rows, or column tiles of nt columns, where every
        # part of it goes by bulk copy; else through L1 (copied by one warp,
        # each block would bring the whole table for the few rows it reads)
        whole = gather_parts(0, n_eff, k * c * nmax, lut_src)
        _, whole_bytes, whole_bulk, _ = _pack(whole)
        nt_max = (cap - _pad(4 * k) - BULK_ALIGN) // (k * c + 4)
        nt_max -= nt_max % BULK_ALIGN
        if whole_bytes <= cap and whole_bulk & B_LUT:
            lut_stages = [(GATHER | LUT | FULLROW, whole, 0, n_eff, nmax)]
            lpitch = nmax
        elif nt_max and all(n % BULK_ALIGN == 0 for n in (n_eff, nmax, lut_src)):
            nt = min(n_eff, nt_max)
            lut_stages = []
            for n0 in range(0, n_eff, nt):
                w = min(nt, n_eff - n0)
                # k*c row segments of w bytes land nt bytes apart
                parts = gather_parts(n0, w, k * c * w, 0, k * c * nt)
                lut_stages.append((GATHER | LUT, parts, n0, w, nt))
            lpitch = nt
        else:
            lut_stages = [(GATHER, gather_parts(0, n_eff, 0, 0), 0, n_eff, 0)]
            lpitch = 0
        tree_parts = [(B_FEAT, 4 * k * i, a_feat + 4 * lk * i),
                      (B_THR, 4 * k * i, a_thr + 4 * lk * i)]
        if _pack(tree_parts)[1] <= cap:
            stages.append(stage(DESCENT | TREES, tree_parts, lpitch=lpitch))
        else:                                    # trees through L1
            flags, parts, n0, nt, pitch = lut_stages[0]
            lut_stages[0] = (flags | DESCENT, parts, n0, nt, pitch)
        stages += [stage(f, parts, n0, nt, pitch, lpitch)
                   for f, parts, n0, nt, pitch in lut_stages]
    return stages


_OFFSETS = ("off_feat", "off_thr", "off_scale", "off_bias", "off_lut")


def _group_fills(stages, cap):
    """Runs of consecutive stages that share one ring fill, up to ``cap``
    bytes: each fill waits on its own barrier round trip, and on the card
    fewer, larger fills measured faster (PERF.md §6). The first stage
    fills alone, so the first descent starts early. Shifts each stage's
    slot offsets to its place in the fill. Returns (stages, fills, slot
    bytes)."""
    placed, fills, base = [], [], 0
    for idx, st in enumerate(stages):
        if idx == 1 or (fills and base + st.nbytes > cap):
            base = 0
        if base == 0:
            fills.append([idx, 0])
        placed.append(dataclasses.replace(
            st, **{o: getattr(st, o) + base for o in _OFFSETS}))
        fills[-1][1] += 1
        base += st.nbytes
    slot = max(sum(placed[i].nbytes for i in range(a, a + n)) for a, n in fills)
    return tuple(placed), tuple(map(tuple, fills)), slot


_STAGE_TABLES: dict[tuple, torch.Tensor] = {}


def _stage_table(plan: Q8Plan, device: torch.device) -> torch.Tensor:
    """The plan's descriptors, then its fills, as one int32 tensor on
    ``device``, built once. Building it copies from the host, which a CUDA
    graph capture forbids: a plan's operands are built with their tables
    (:func:`stage_q8`), and a launch captured into a graph must find its
    table built — else those operands moved, and this raises."""
    key = (plan, str(device))
    table = _STAGE_TABLES.get(key)
    if table is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "int8 fuzzy-LUT launch with no stage table inside a CUDA graph "
                "capture: its operands are not the ones stage_q8 planned")
        rows = [v for s in plan.stages for v in s.row()]
        rows += [v for fill in plan.fills for v in fill]
        table = torch.tensor(rows, dtype=torch.int32, device=device)
        _STAGE_TABLES[key] = table
    return table


def launch_plan(v: int, features, thresholds, lut_q8, scales, bias, ks,
                 n_out) -> Q8Plan:
    """The :func:`plan_q8` of a launch over these operands; it keys on
    their alignment, so operands a compiled plan owns keep one plan."""
    kmax, c, nmax = lut_q8.shape[-3:]
    ptrs = [features, thresholds, scales, bias, lut_q8]
    align = tuple(0 if p is None else p.data_ptr() % BULK_ALIGN for p in ptrs)
    return plan_q8(tuple(ks), v, _depth(c), kmax, nmax, n_out,
                   has_bias=bias is not None, align=align)


def stage_q8(v: int, features, thresholds, lut_q8, scales, bias=None, *,
             ks: tuple[int, ...], n_out: int) -> None:
    """Build the stage table of an int8 launch over these CUDA operands
    ahead of the first launch (a bank: ``ks=(K,)``, ``n_out=N``, no bias;
    a stack: its ``ks``, ``n_out`` and bias), so that a CUDA graph can
    capture the launch."""
    plan = launch_plan(v, features, thresholds, lut_q8, scales, bias, ks, n_out)
    _stage_table(plan, features.device)


def launch_shape(plan: Q8Plan, t: int, n_sm: int):
    """(rows per chunk, chunks, grid, threads, shared bytes) of a launch
    over ``t`` rows on ``n_sm`` SMs: about one chunk per SM, one warp per
    row."""
    rows = plan.rows_for(t, n_sm)
    nchunks = -(-t // rows)
    return (rows, nchunks, min(nchunks, n_sm), 32 * min(Q8_MAX_WARPS, rows),
            plan.smem_bytes(rows))


def launch_q8(fn_name: str, x, features, thresholds, lut_q8, scales, bias,
              ks, n_out, depth, leaves):
    """Plan and launch the int8 kernel ``fn_name`` (one bank, or a stack
    when ``bias`` is given); returns ``y [T, n_out]``. ``leaves`` is None or
    an int32 ``[L, T, Kmax]`` (a bank's ``[T, K]``) output."""
    t, k0, v = x.shape
    kmax, nmax = lut_q8.shape[-3], lut_q8.shape[-1]
    y = torch.empty((t, n_out), dtype=torch.float32, device=x.device)
    if not t:
        return y
    plan = launch_plan(v, features, thresholds, lut_q8, scales, bias, ks, n_out)
    rows, nchunks, grid, threads, smem = launch_shape(plan, t, _sm_count(x.device))
    geom = _lib.Q8Geom(L=len(ks), k0=k0, kmax=kmax, nmax=nmax, n_out=n_out, v=v,
                       depth=depth, width=plan.width, kstride=plan.kstride,
                       rows=rows, nchunks=nchunks,
                       nstages=len(plan.stages), nfills=len(plan.fills),
                       slot_bytes=plan.slot_bytes)
    table = _stage_table(plan, x.device)
    args = [x, features, thresholds, lut_q8, scales] + ([bias] if bias is not None else [])
    _cuda_call(fn_name, x.device, *(p.data_ptr() for p in args), y.data_ptr(),
               None if leaves is None else leaves.data_ptr(), table.data_ptr(),
               t, geom, grid, threads, smem)
    _lib.count_launch(fn_name)
    return y


def quantize_lut_int8(lut: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-group symmetric int8 quantization. ``[K,C,N]`` → (int8 ``[K,C,N]``,
    f32 ``[K]``); rounds half to even, as the reference."""
    lut = lut.to(torch.float32)
    amax = lut.abs().amax(dim=(1, 2))
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(lut / scale[:, None, None]), -127, 127)
    return q.to(torch.int8), scale


def fuzzy_lut_q8_plain(x, features, thresholds, lut_q8, scales):
    """Plain version of the per-bank int8 kernel: ``(y [T,N], leaves [T,K])``."""
    return _bank_plain(x, features, thresholds, lut_q8, scales)


def fuzzy_lut_q8(x: torch.Tensor, features: torch.Tensor,
                 thresholds: torch.Tensor, lut_q8: torch.Tensor,
                 scales: torch.Tensor, *, return_leaves: bool = False):
    """``y = Σ_k s_k · lut_q8[k, leaf_k]`` (no bias): the contract of
    :func:`repro_torch.kernels.fuzzy_lut.kernel.fuzzy_lut` with an int8
    ``lut_q8 [K, C, N]`` and f32 ``scales [K]``."""
    depth = _check_bank("fuzzy_lut_q8", x, features, thresholds, lut_q8,
                        torch.int8, scales)
    if x.device.type == "cpu":
        y, leaves = fuzzy_lut_q8_plain(x, features, thresholds, lut_q8, scales)
        return (y, leaves.to(torch.int32)) if return_leaves else y
    t, k, _ = x.shape
    n = lut_q8.shape[2]
    leaves = (torch.empty((t, k), dtype=torch.int32, device=x.device)
              if return_leaves else None)
    y = launch_q8("fuzzy_lut_q8", x, features, thresholds, lut_q8, scales, None,
                  (k,), n, depth, leaves)
    return (y, leaves) if return_leaves else y


def fuzzy_lut_stack_q8_plain(x, features, thresholds, lut_q8, scales, bias,
                             ks, n_out):
    """Plain version of the stacked int8 kernel:
    ``(y [T, n_out], leaves [L, T, Kmax])``."""
    return _stack_plain(x, features, thresholds, lut_q8, bias, ks, n_out, scales)


def fuzzy_lut_stack_q8(x: torch.Tensor, features: torch.Tensor,
                       thresholds: torch.Tensor, lut_q8: torch.Tensor,
                       scales: torch.Tensor, bias: torch.Tensor, *,
                       ks: tuple[int, ...], n_out: int,
                       return_leaves: bool = False):
    """int8 stacked kernel: the contract of
    :func:`repro_torch.kernels.fuzzy_lut.kernel.fuzzy_lut_stack` with an int8
    ``lut_q8 [L, Kmax, C, Nmax]`` and f32 ``scales [L, Kmax]``."""
    ks = tuple(int(k) for k in ks)
    depth = _check_stack("fuzzy_lut_stack_q8", x, features, thresholds, lut_q8,
                         torch.int8, bias, ks, n_out, scales)
    if x.device.type == "cpu":
        y, leaves = fuzzy_lut_stack_q8_plain(x, features, thresholds, lut_q8,
                                             scales, bias, ks, n_out)
        return (y, leaves.to(torch.int32)) if return_leaves else y
    nl, kmax = lut_q8.shape[:2]
    # padded groups are never walked; they would land on leaf 0
    leaves = (torch.zeros((nl, x.shape[0], kmax), dtype=torch.int32,
                          device=x.device) if return_leaves else None)
    y = launch_q8("fuzzy_lut_stack_q8", x, features, thresholds, lut_q8, scales,
                  bias, ks, n_out, depth, leaves)
    return (y, leaves) if return_leaves else y
