"""ExecutionPlan: compile a pegasusified model once, call it many times
(port of ``repro.engine.plan``).

  * :class:`CompiledBank` — one ``PegasusLinear`` plus every operand the
    CUDA kernels take (int32 features, thresholds, f32 LUT, int8 LUT +
    per-group scales), built once on the plan's device.
  * :class:`FusedBankStack` / :func:`fuse_banks` — Cross-bank Primitive
    Fusion: a maximal run of compatible consecutive banks runs as ONE
    stacked kernel launch. Its geometry is checked once, at build, and the
    call path never catches an error or falls back to the per-bank chain.
  * :class:`ExecutionPlan` — the whole model. A call pads the batch up to
    its bucket (powers of two up to 4096, multiples of 4096 beyond) and
    slices the padding off. On a CUDA device the whole forward runs as ONE
    CUDA graph per ``(backend, bucket)`` (and device and stream), captured
    at the first call there and replayed after — the counterpart of the
    reference's one XLA program per ``(backend, bucket)``; ``traces``
    counts the captures. On the CPU, and with ``jit=False``, the forward
    runs eagerly. ``device=`` places one call on another device, with a
    replica of the bank state built once per device; ``build_plan(devices=)``
    shards every call's padded bucket over several devices.
  * :func:`build_plan` — compiles every family the nets produce: a bank
    list (MLP-B, the AutoEncoder), the RNN's unrolled window, CNN-B/CNN-M
    (window bank, then the pooled head chain or the NAM sum) and CNN-L
    (two encoder banks, a fuzzy index and a logit LUT).

Backends are semantics-identical up to quantization:
  ``gather``    — descent + row gather + ascending-k sum (plain PyTorch)
  ``onehot``    — one-hot × LUT fp32 matmul (TF32 off)
  ``kernel``    — the f32 CUDA kernels
  ``kernel_q8`` — the int8 CUDA kernels over the memoized int8 LUT
"""

from __future__ import annotations

import dataclasses
import gc
import warnings
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.analysis.planaudit import PlanAuditError, audit_plan
from repro_torch.analysis.sanitizer import make_lock
from repro_torch.core.amm import PegasusLinear, apply_gather, apply_onehot
from repro_torch.core.fuzzy_tree import FuzzyTree, hard_index
from repro_torch.data.synthetic_traffic import WINDOW
from repro_torch.device import resolve_device
from repro_torch.kernels.fuzzy_lut import _lib
from repro_torch.kernels.fuzzy_lut.kernel import fuzzy_lut, fuzzy_lut_stack, stack_fits
from repro_torch.kernels.fuzzy_lut.ops import padded_layout
from repro_torch.kernels.fuzzy_lut.quantized import (
    fuzzy_lut_q8, fuzzy_lut_stack_q8, stage_q8,
)

__all__ = [
    "BACKENDS",
    "DEFAULT_BUCKETS",
    "DEFAULT_FUSE_NMAX_CAP",
    "STATS",
    "CompiledBank",
    "EngineStats",
    "ExecutionPlan",
    "FusedBankStack",
    "bucket_batch",
    "bucket_chunks",
    "build_plan",
    "fuse_banks",
    "resolve_devices",
]

# Per-group cap on a fused stack's padded output width: one wide bank
# joining a narrow run would pad EVERY member's LUT rows to its width.
DEFAULT_FUSE_NMAX_CAP = 2048

BACKENDS = ("gather", "onehot", "kernel", "kernel_q8")

DEFAULT_BUCKETS: tuple[int, ...] = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def bucket_batch(b: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Round a batch size up to its bucket (smallest bucket ≥ b; beyond the
    largest, the next multiple of it)."""
    if b <= 0:
        raise ValueError(f"batch must be positive, got {b}")
    for s in sorted(buckets):
        if b <= s:
            return int(s)
    top = int(max(buckets))
    return -(-b // top) * top


def bucket_chunks(
    total: int,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    max_batch: int | None = None,
) -> list[int]:
    """Split ``total`` coalesced flows into bucket-aligned micro-batch sizes.

    Full chunks are exact bucket sizes; the tail dispatches either as one
    padded chunk or as an exact bucket plus a smaller padded chunk —
    whichever wastes fewer padded rows.
    """
    if total <= 0:
        raise ValueError(f"total must be positive, got {total}")
    bs = sorted(int(b) for b in buckets)
    if max_batch is None:
        top = bs[-1]
    else:
        fits = [b for b in bs if b <= max_batch]
        top = fits[-1] if fits else bs[0]
    sizes = []
    remaining = total
    while remaining > top:
        sizes.append(top)
        remaining -= top
    if remaining:
        fit = max((b for b in bs if b <= remaining), default=0)
        if 0 < fit < remaining:
            pad_whole = bucket_batch(remaining, bs) - remaining
            rest = remaining - fit
            pad_split = bucket_batch(rest, bs) - rest
            if pad_split < pad_whole:
                sizes.append(fit)
                remaining = rest
        sizes.append(remaining)
    return sizes


@dataclasses.dataclass
class EngineStats:
    """Global counters of plan builds, dispatches and memo hits."""

    plan_builds: int = 0     # ExecutionPlan compilations
    jit_calls: int = 0       # plan dispatches
    plan_cache_hits: int = 0  # plan_for() served from the memo

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)


STATS = EngineStats()


class CompiledBank:
    """One PegasusLinear with its kernel operands built once on ``device``.

    ``self.layer`` is a replica of the source layer on the plan's device
    (a new instance), so a plan never pins the caller's model object.
    """

    def __init__(self, layer: PegasusLinear, *, device: torch.device):
        self.layer = layer.to(device)
        self.features, self.thr, self.lut, _ = padded_layout(self.layer, quant=False)
        _, _, self.lut_q8, self.scales = padded_layout(self.layer, quant=True)
        if self.features.is_cuda:   # a graph capture may not build it later
            stage_q8(self.layer.group_size, self.features, self.thr, self.lut_q8,
                     self.scales, ks=(self.layer.num_groups,),
                     n_out=self.layer.out_features)

    def apply(self, x: torch.Tensor, backend: str) -> torch.Tensor:
        if backend == "gather":
            return apply_gather(self.layer, x)
        if backend == "onehot":
            return apply_onehot(self.layer, x)
        if backend == "kernel":
            return self._apply_kernel(x, quant=False)
        if backend == "kernel_q8":
            return self._apply_kernel(x, quant=True)
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")

    def _apply_kernel(self, x: torch.Tensor, quant: bool) -> torch.Tensor:
        p = self.layer
        lead = x.shape[:-1]
        xg = x.reshape(-1, p.num_groups, p.group_size).to(torch.float32).contiguous()
        if quant:
            y = fuzzy_lut_q8(xg, self.features, self.thr, self.lut_q8, self.scales)
        else:
            y = fuzzy_lut(xg, self.features, self.thr, self.lut)
        if p.bias is not None:
            y = y + p.bias
        return y.reshape(*lead, p.out_features)


# ---------------------------------------------------------------------------
# Cross-bank Primitive Fusion: compatible consecutive banks → one kernel
# ---------------------------------------------------------------------------


class FusedBankStack:
    """A run of L compatible banks compiled into ONE stacked kernel.

    Each bank's operands are padded to the group's ``(Kmax, Nmax)`` —
    +inf thresholds and zero LUT rows on padded groups descend to leaf 0 and
    add nothing — then stacked along a leading L axis. ``__init__`` checks
    the stack's geometry and raises ``ValueError`` on one the kernel cannot
    take; ``apply`` on ``kernel``/``kernel_q8`` then launches the stacked
    kernel with no fallback. ``gather``/``onehot`` run the member banks in
    turn, which is the same function.
    """

    def __init__(self, banks: Sequence[CompiledBank]):
        if len(banks) < 2:
            raise ValueError("a fused stack needs at least 2 banks")
        for a, b in zip(banks, banks[1:]):
            if not _fusable(a, b):
                raise ValueError("banks are not shape-compatible for fusion")
        self.banks = list(banks)
        layers = [b.layer for b in banks]
        self.v = layers[0].group_size
        self.ks = tuple(l.num_groups for l in layers)
        self.n_out = layers[-1].out_features
        kmax = max(self.ks)
        nmax = max(l.out_features for l in layers)
        if not stack_fits(self.ks[0], self.v, kmax, nmax, len(layers)):
            raise ValueError(
                f"stack of {len(layers)} banks (Kmax={kmax}, Nmax={nmax}) "
                "exceeds the stacked kernel's layer count or shared memory")
        c = layers[0].num_centroids
        nl, dev = len(layers), layers[0].device
        feats = torch.zeros((nl, kmax, c - 1), dtype=torch.int32, device=dev)
        thr = torch.full((nl, kmax, c - 1), float("inf"), device=dev)
        lut = torch.zeros((nl, kmax, c, nmax), device=dev)
        lut_q8 = torch.zeros((nl, kmax, c, nmax), dtype=torch.int8, device=dev)
        scales = torch.zeros((nl, kmax), device=dev)
        bias = torch.zeros((nl, nmax), device=dev)
        for l, bank in enumerate(banks):
            k, n = bank.layer.num_groups, bank.layer.out_features
            feats[l, :k] = bank.features
            thr[l, :k] = bank.thr
            lut[l, :k, :, :n] = bank.lut
            lut_q8[l, :k, :, :n] = bank.lut_q8
            scales[l, :k] = bank.scales
            if bank.layer.bias is not None:
                bias[l, :n] = bank.layer.bias
        self.features, self.thr = feats, thr
        self.lut, self.lut_q8 = lut, lut_q8
        self.scales, self.bias = scales, bias
        if feats.is_cuda:
            stage_q8(self.v, feats, thr, lut_q8, scales, bias, ks=self.ks,
                     n_out=self.n_out)

    def apply(self, x: torch.Tensor, backend: str) -> torch.Tensor:
        if backend not in ("kernel", "kernel_q8"):
            h = x
            for bank in self.banks:
                h = bank.apply(h, backend)
            return h
        lead = x.shape[:-1]
        xg = x.reshape(-1, self.ks[0], self.v).to(torch.float32).contiguous()
        if backend == "kernel":
            y = fuzzy_lut_stack(xg, self.features, self.thr, self.lut, self.bias,
                                ks=self.ks, n_out=self.n_out)
        else:
            y = fuzzy_lut_stack_q8(xg, self.features, self.thr, self.lut_q8,
                                   self.scales, self.bias, ks=self.ks,
                                   n_out=self.n_out)
        return y.reshape(*lead, self.n_out)


def _fusable(a: CompiledBank, b: CompiledBank) -> bool:
    """Can bank ``b`` consume bank ``a``'s output inside one stacked kernel?
    Same partition width and centroid count, exact output→input chaining."""
    return (a.layer.group_size == b.layer.group_size
            and a.layer.num_centroids == b.layer.num_centroids
            and a.layer.out_features == b.layer.in_features)


def _balloons(run: Sequence[CompiledBank], bank: CompiledBank,
              nmax_cap: int | None) -> bool:
    """Would adding ``bank`` to ``run`` pad some member's output rows past
    ``nmax_cap``? Equal-width banks above the cap add no padding."""
    if nmax_cap is None:
        return False
    ns = [b.layer.out_features for b in run] + [bank.layer.out_features]
    nmax = max(ns)
    return nmax > nmax_cap and min(ns) < nmax


def _fits(run: Sequence[CompiledBank], bank: CompiledBank) -> bool:
    """Would the stacked kernel still take ``run`` with ``bank`` added?"""
    members = [*run, bank]
    return stack_fits(members[0].layer.num_groups, bank.layer.group_size,
                      max(b.layer.num_groups for b in members),
                      max(b.layer.out_features for b in members), len(members))


def fuse_banks(banks: Sequence[CompiledBank], *,
               nmax_cap: int | None = DEFAULT_FUSE_NMAX_CAP) -> list:
    """Group maximal runs of compatible consecutive banks into
    :class:`FusedBankStack` steps; lone banks pass through. A run splits
    where the next bank would balloon its padding past ``nmax_cap`` or
    leave the stacked kernel's limits."""
    steps: list = []
    run: list[CompiledBank] = []

    def flush():
        if len(run) >= 2:
            steps.append(FusedBankStack(run))
        else:
            steps.extend(run)
        run.clear()

    for bank in banks:
        if run and (not _fusable(run[-1], bank)
                    or _balloons(run, bank, nmax_cap) or not _fits(run, bank)):
            flush()
        run.append(bank)
    flush()
    return steps


# ---------------------------------------------------------------------------
# ExecutionPlan
# ---------------------------------------------------------------------------


def resolve_devices(devices) -> tuple | None:
    """Normalize a ``devices=`` knob into a canonical device tuple.

    Accepts ``None`` (the default), an int ``k`` (the first ``k`` CUDA
    devices; more than ``torch.cuda.device_count()`` raises), or a sequence
    of ``torch.device`` objects, device strings or CUDA indices. A sequence
    may repeat a device: each entry is a stream of its own in a
    ``DeviceStreamPool``. The canonical form is ``None`` or a tuple of
    indexed ``torch.device``, so ``devices=1`` and ``devices=["cuda:0"]``
    name the same placement.
    """
    if devices is None:
        return None
    avail = torch.cuda.device_count()
    if isinstance(devices, int):
        if devices < 1:
            raise ValueError(f"devices must be ≥ 1, got {devices}")
        if devices > avail:
            raise ValueError(f"devices={devices} but only {avail} CUDA devices "
                             "are visible")
        return tuple(torch.device("cuda", i) for i in range(devices))
    out = []
    for d in devices:
        if isinstance(d, int):
            if not 0 <= d < avail:
                raise ValueError(f"CUDA device {d} is not visible ({avail} are)")
            d = torch.device("cuda", d)
        out.append(resolve_device(d))
    return tuple(out) or None


# CUDA lets one stream capture run at a time in a process: every plan's
# captures take this lock (capture_error_mode="thread_local" then keeps
# other threads' allocations and syncs legal while one runs)
_CAPTURE_LOCK = make_lock("plan._capture_lock")
# per device, the one stream every capture (and its eager warm-up) runs
# on. Work another thread enqueues on a capturing stream would join the
# capture, so it must be a stream no caller runs on: it is high-priority,
# drawn from another pool than the default-priority streams that callers
# and DeviceStreamPool workers get from torch.cuda.Stream(). Touched under
# _CAPTURE_LOCK only.
_CAPTURE_STREAMS: dict[torch.device, Any] = {}


class _GraphPool:
    """The memory pool that one plan's graphs on one device and stream
    share, and the lock a replay into it holds from the copy into its
    static inputs until the copy of its output is enqueued. Each capture
    frees its intermediates back into the pool, so a graph captured later
    may keep its output in memory an earlier graph uses for intermediates:
    two replays of one pool must never interleave. The lock orders them on
    the host and, since every graph of the pool replays on that one
    stream, stream order keeps them apart on the device."""

    __slots__ = ("handle", "lock")

    def __init__(self):
        self.handle = torch.cuda.graph_pool_handle()
        self.lock = make_lock("plan._graph_pool.lock")


class _Graph:
    """One captured forward at a ``(backend, bucket)`` on one device and
    stream: the graph, its plan-owned static input and output buffers, the
    port's kernel launches one replay makes, the kernel nodes it holds (the
    port's and torch's), the rows its per-bank kernels are launched on, and
    the pool it allocated from."""

    __slots__ = ("graph", "inputs", "output", "launches", "kernels", "bank_rows", "pool")

    def __init__(self, graph, inputs: tuple, output: torch.Tensor,
                 launches: dict[str, int], kernels: int, bank_rows: int, pool: _GraphPool):
        self.graph = graph
        self.inputs = inputs
        self.output = output
        self.launches = launches
        self.kernels = kernels
        self.bank_rows = bank_rows
        self.pool = pool


class ExecutionPlan:
    """Compiled model: banks + structural forward, bound to one device.

    ``forward(apply, state, *inputs)`` walks the model's steps; ``__call__``
    pads the batch to its bucket, runs the forward with the chosen backend
    and slices the padding off — on a CUDA device by replaying the graph
    captured at the first call at that ``(backend, bucket)`` on that device
    and stream.

    **Graphs.** The first call at a ``(backend, bucket, device, stream)``
    copies the padded batch into plan-owned static input buffers, runs the
    forward once eagerly (its output answers that call), then captures the
    same forward into a ``torch.cuda.CUDAGraph`` under the process-wide
    capture lock, and counts one trace. Every later call copies its batch
    into the static inputs (zeroing the padded rows) and replays. A call
    through ``plan(...)`` returns a FRESH copy of the static output made
    on the same stream — two chunks of one request list replay one graph,
    so a view would be overwritten. The served path's
    :meth:`call_into` makes no copy of its own: its inputs cross into the
    static inputs in one copy each (from a pinned host slot, padded rows
    and all), and the static output's rows go to the caller's sink, which
    enqueues their one copy out before the lock is let go. Graphs of one
    device and stream share one memory pool, and a replay holds that
    pool's lock from its copy-in until its output copy is
    enqueued; each graph's kernel launches, tallied at capture, are added
    to the launch counters at every replay, and the kernel nodes it holds,
    counted once at capture, to :attr:`graph_kernels`, as are the rows its
    per-bank kernels take to :attr:`bank_rows`. A failed capture
    raises; it never becomes an eager run. ``jit=False`` runs the forward
    eagerly on the unpadded inputs (the reference's keyword for its eager
    path), and on the CPU every call runs eagerly with the same trace and
    bucket counters.

    **Placed calls.** ``device=`` runs one call on another device with a
    replica of the bank state built once per device (outside the replica
    lock); inputs that arrive as host arrays are copied onto it on the
    caller's current stream. This is what ``DeviceStreamPool`` workers use.

    **Sharded plans** (``build_plan(devices=)``, K > 1 devices, the
    reference's ``shard_map`` over a 1-D ``("batch",)`` mesh): a call pads
    the batch to its bucket on ``devices[0]``, splits it into K equal row
    shards, runs shard i on ``devices[i]`` (its graph at ``bucket / K``
    rows on a card, eagerly on the CPU; the bank state replicated once per
    device) and concatenates the outputs in row order on ``devices[0]``.
    Rows never interact, so no collective runs and the output is the
    single-device plan's, bit for bit. A device may repeat. A first use of
    a ``(backend, bucket)`` counts one trace, whatever the shards capture.
    """

    def __init__(self, banks: Sequence[CompiledBank],
                 forward: Callable[..., torch.Tensor], state: Any, *,
                 device: torch.device, backend: str = "onehot",
                 family: str = "sequential",
                 bucket_sizes: Sequence[int] | None = None):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
        self.banks = list(banks)
        self._forward = forward
        self._state = state
        self.device = device
        self.backend = backend
        self.family = family
        self.buckets = tuple(sorted(bucket_sizes)) if bucket_sizes else DEFAULT_BUCKETS
        self.fused_groups = 0
        self.fused_banks = 0
        self.fused_stacks: list = []
        # set by build_plan: the non-bank model state the plan froze (the
        # registry compares it with the live model), the fusion knobs the
        # plan audit explains unfused pairs with, and the audit's report
        self._aux_token: tuple = ()
        self.fuse_cfg: dict | None = None
        self.audit_report = None
        # rows a bank sees per flow where it is not one (the CNN window
        # bank runs once per window, the CNN-L banks once per packet): the
        # plan audit prices launches at the rows the largest bucket gives
        self._rows_per_flow: dict[int, int] = {}
        # counters and the graph table: the drain thread, infer() callers
        # and the stream pool's workers may call one plan at once
        self._lock = make_lock("plan._ctr.lock")
        self._traces = 0                                    # guarded-by: _lock
        self._traced: set[tuple[str, int]] = set()          # guarded-by: _lock
        self._first_uses: set[tuple] = set()                # guarded-by: _lock
        self._rows: dict[tuple[str, int], list] = {}        # guarded-by: _lock
        self._calls = 0                                     # guarded-by: _lock
        self._graphs: dict[tuple, _Graph] = {}              # guarded-by: _lock
        # kernel nodes of every graph replayed, and the rows its per-bank
        # kernels were launched on, each replay counted
        self._graph_kernels = 0                             # guarded-by: _lock
        self._bank_rows = 0                                 # guarded-by: _lock
        # per (device, stream): the graphs' memory pool and replay lock
        # (touched under _CAPTURE_LOCK only)
        self._pools: dict[tuple, _GraphPool] = {}
        self._replica_lock = make_lock("plan._replica_lock")
        self._replicas: dict[torch.device, Any] = {}        # guarded-by: _replica_lock
        self.devices: tuple | None = None     # set by shard_over (build_plan(devices=))
        STATS.plan_builds += 1

    def shard_over(self, devices: tuple | None) -> None:
        """Shard every call over ``devices`` (a tuple from
        :func:`resolve_devices` whose first entry is the plan's device, or
        None); each bucket must split evenly."""
        if devices is not None and devices[0] != self.device:
            raise ValueError(f"devices[0]={devices[0]} is not the plan's device {self.device}")
        if devices is not None and len(devices) > 1:
            bad = [b for b in self.buckets if b % len(devices)]
            if bad:
                raise ValueError(
                    f"bucket sizes {bad} are not divisible by the {len(devices)}-device "
                    "mesh: every bucket is split evenly across the batch axis (pass "
                    "bucket_sizes that the device count divides)")
        self.devices = devices

    @property
    def sharded(self) -> bool:
        """Whether every call splits over several devices (``shard_over``)."""
        return self.devices is not None and len(self.devices) > 1

    def step_rows_per_flow(self, step) -> int:
        """Rows one flow of a batch gives ``step`` (a bank or a fused stack)."""
        bank = step.banks[0] if isinstance(step, FusedBankStack) else step
        return self._rows_per_flow.get(id(bank), 1)

    @property
    def trace_count(self) -> int:
        with self._lock:
            return self._traces

    @property
    def compiled_buckets(self) -> set:
        with self._lock:
            return set(self._traced)

    @property
    def graph_kernels(self) -> int:
        """Kernels the plan's graph replays have launched: the kernel nodes
        of each graph replayed (the port's own kernels and the torch ops
        captured between them), once per replay. Eager calls, the CPU and
        a call that captures count nothing."""
        with self._lock:
            return self._graph_kernels

    @property
    def bank_rows(self) -> int:
        """Rows the plan's graph replays launched the per-bank kernels
        (``fuzzy_lut``, ``fuzzy_lut_q8``) on, bucket padding included: each
        graph's rows, summed over its per-bank steps at capture (a bucket
        times the step's rows a flow), once per replay. Fused stacks, the
        plain backends, eager calls, the CPU and a call that captures count
        nothing."""
        with self._lock:
            return self._bank_rows

    def _padded(self, x, bucket: int, device: torch.device) -> torch.Tensor:
        x = torch.as_tensor(x, device=device)
        b = x.shape[0]
        if b == bucket:
            return x
        out = torch.zeros((bucket, *x.shape[1:]), dtype=x.dtype, device=device)
        out[:b] = x
        return out

    def __call__(self, *inputs, backend: str | None = None, jit: bool = True,
                 device=None) -> torch.Tensor:
        be = self.backend if backend is None else backend
        if be not in BACKENDS:
            raise ValueError(f"unknown backend {be!r}; expected one of {BACKENDS}")
        if self.sharded:
            if device is not None:
                raise ValueError(
                    "this plan is sharded across a device mesh at build time (devices=); "
                    "per-call device placement applies only to single-device plans")
            return self._sharded_call(be, inputs, jit)
        dev = self.device if device is None else resolve_device(device)
        state = self._state_for(dev)
        if not jit:
            with torch.no_grad():
                return self._forward(lambda step, x: step.apply(x, be), state,
                                     *(torch.as_tensor(x, device=dev) for x in inputs))
        b = int(np.shape(inputs[0])[0])
        bucket = bucket_batch(b, self.buckets)
        STATS.jit_calls += 1
        if dev.type == "cuda":
            return self._graph_call(be, bucket, b, dev, state, inputs)
        padded = tuple(self._padded(x, bucket, dev) for x in inputs)
        self._note_call(be, bucket, b, first_use=(be, bucket, dev))
        with torch.no_grad():
            y = self._forward(lambda step, x: step.apply(x, be), state, *padded)
        return y if bucket == b else y[:b]

    def call_into(self, inputs: Sequence, rows: int, into: Callable[[torch.Tensor], Any], *,
                  backend: str | None = None) -> None:
        """The served path's call on a single-device CUDA plan: ``rows``
        flows, each input crossing into the graph's static input in one
        ``non_blocking`` copy, and the output's ``rows`` rows handed to
        ``into`` with no tensor made on the way.

        An input is a host view of a pinned slot or a tensor on the plan's
        device, holding between ``rows`` rows and the bucket's; the rows
        past ``rows`` are padding and must be zero (rows short of the
        bucket are zeroed on the device). ``into`` gets the static
        output's rows on the device while the pool's lock is held, and
        must enqueue on the current stream whatever reads them before it
        returns: the next replay of the graph overwrites them. The caller
        keeps a host input unwritten until an event recorded on the
        current stream after this call has completed."""
        be = self.backend if backend is None else backend
        if be not in BACKENDS:
            raise ValueError(f"unknown backend {be!r}; expected one of {BACKENDS}")
        if self.sharded or self.device.type != "cuda":
            raise ValueError("call_into replays a single-device plan's CUDA graphs; "
                             f"this plan is {'sharded' if self.sharded else self.device.type}")
        bucket = bucket_batch(rows, self.buckets)
        STATS.jit_calls += 1
        self._note_call(be, bucket, rows)
        self._replay(be, bucket, rows, self.device, self._state, inputs, into=into)

    def _sharded_call(self, be: str, inputs, jit: bool) -> torch.Tensor:
        """One call split into equal row shards, one per device (see the
        class docstring)."""
        b = int(np.shape(inputs[0])[0])
        bucket = bucket_batch(b, self.buckets)
        rows = bucket // len(self.devices)
        home = self.devices[0]
        padded = tuple(self._padded(x, bucket, home) for x in inputs)
        if jit:
            STATS.jit_calls += 1
            self._note_call(be, bucket, b, first_use=(be, bucket, self.devices))
        apply = lambda step, x: step.apply(x, be)
        outs = []
        for i, dev in enumerate(self.devices):
            shard = tuple(x[i * rows:(i + 1) * rows] for x in padded)
            state = self._state_for(dev)
            if jit and dev.type == "cuda":
                outs.append(self._replay(be, rows, rows, dev, state, shard, count=False))
            else:
                with torch.no_grad():
                    outs.append(self._forward(apply, state, *(x.to(dev) for x in shard)))
        y = torch.cat([o.to(home) for o in outs])
        return y if bucket == b else y[:b]

    def _note_call(self, be: str, bucket: int, b: int, first_use=None) -> None:
        """Count one call (and its padded rows); on the CPU, count a trace
        at the first use of ``first_use``."""
        with self._lock:
            self._calls += 1
            rows = self._rows.setdefault((be, bucket), [0, 0])
            rows[0] += b
            rows[1] += bucket
            if first_use is not None and first_use not in self._first_uses:
                self._first_uses.add(first_use)
                self._note_trace(be, bucket)

    # holds: _lock
    def _note_trace(self, be: str, bucket: int) -> None:
        self._traced.add((be, bucket))
        self._traces += 1

    def _state_for(self, device: torch.device):
        """The bank state on ``device``: the plan's own, or a replica built
        once per other device. The copy runs OUTSIDE the lock, so placed
        calls to other devices never wait on it; racing builders both copy
        once and the first one's replica is kept."""
        if device == self.device:
            return self._state
        with self._replica_lock:
            st = self._replicas.get(device)
        if st is None:
            built = _replicate(self._state, device, {})
            with self._replica_lock:
                st = self._replicas.setdefault(device, built)
        return st

    def _graph_call(self, be, bucket, b, dev, state, inputs) -> torch.Tensor:
        self._note_call(be, bucket, b)
        return self._replay(be, bucket, b, dev, state, inputs)

    def _replay(self, be, bucket, b, dev, state, inputs, count: bool = True,
                into=None) -> torch.Tensor | None:
        """Replay the graph at ``(be, bucket)`` on ``dev`` and the current
        stream, capturing it first (a trace when ``count``); return a copy
        of its ``b`` output rows, or with ``into`` hand them to it (see
        :meth:`call_into`)."""
        srcs = tuple(x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
                     for x in inputs)
        stream = torch.cuda.current_stream(dev)
        key = (be, bucket, dev, stream.cuda_stream,
               tuple((tuple(x.shape[1:]), x.dtype) for x in srcs))
        with self._lock:
            g = self._graphs.get(key)
            if g is not None:
                self._graph_kernels += g.kernels
                self._bank_rows += g.bank_rows
        if g is None:
            y = self._capture(key, be, bucket, b, dev, state, srcs, stream, count,
                              non_blocking=into is not None)
            if y is not None:
                if into is None:
                    return y
                into(y)
                return None
            with self._lock:         # a racing call captured it first
                g = self._graphs[key]
                self._graph_kernels += g.kernels
                self._bank_rows += g.bank_rows
        with g.pool.lock:
            for buf, x in zip(g.inputs, srcs):
                n = len(x)           # b rows, or up to the bucket's with zero padding
                (buf if n == bucket else buf[:n]).copy_(x, non_blocking=into is not None)
                if n < bucket:
                    buf[n:].zero_()
            g.graph.replay()
            y = g.output if b == bucket else g.output[:b]
            if into is None:
                y = y.clone()
            else:
                into(y)
                y = None
        _lib.add_launches(g.launches)
        return y

    def _capture(self, key, be, bucket, b, dev, state, srcs, stream, count: bool = True,
                 non_blocking: bool = False):
        """First call at ``key``: fill new static inputs (``non_blocking``
        from a pinned slot), run the forward once eagerly on the capture
        stream (its output answers this call), then capture it into a graph
        and count its kernel nodes and its per-bank kernels' rows before
        instantiating it. Python's cyclic collector is paused for the
        capture: it could destroy an old graph or free a pinned buffer in
        the middle of it, CUDA calls that a thread-local capture refuses,
        and the capture would fail. Returns
        None when a racing call captured ``key`` first."""
        apply = lambda step, x: step.apply(x, be)
        with _CAPTURE_LOCK, torch.cuda.device(dev):
            with self._lock:
                if key in self._graphs:
                    return None
            static = tuple(torch.zeros((bucket, *x.shape[1:]), dtype=x.dtype,
                                       device=dev) for x in srcs)
            for buf, x in zip(static, srcs):
                buf[:len(x)].copy_(x, non_blocking=non_blocking)
            side = _CAPTURE_STREAMS.get(dev)
            if side is None:
                side = _CAPTURE_STREAMS[dev] = torch.cuda.Stream(device=dev,
                                                                 priority=-1)
            pool = self._pools.get(key[2:4])
            if pool is None:
                pool = self._pools[key[2:4]] = _GraphPool()
            side.wait_stream(stream)
            with torch.cuda.stream(side), torch.no_grad():
                warm = self._forward(apply, state, *static)
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            bank_rows = 0

            def counted(step, x):
                nonlocal bank_rows
                if isinstance(step, CompiledBank) and be in ("kernel", "kernel_q8"):
                    bank_rows += x.numel() // x.shape[-1]    # one kernel row an input row
                return step.apply(x, be)

            collecting = gc.isenabled()
            gc.disable()
            try:
                with _lib.recording() as tally, torch.no_grad():
                    with torch.cuda.graph(graph, pool=pool.handle, stream=side,
                                          capture_error_mode="thread_local"):
                        out = self._forward(counted, state, *static)
            finally:
                if collecting:
                    gc.enable()
            kernels = _lib.graph_kernel_nodes(graph.raw_cuda_graph())
            graph.instantiate()
            with self._lock:
                self._graphs[key] = _Graph(graph, static, out, dict(tally), kernels,
                                           bank_rows, pool)
                if count:
                    self._note_trace(be, bucket)
        stream.wait_stream(side)
        warm.record_stream(stream)
        return warm if b == bucket else warm[:b]

    def _lut_cell_stats(self) -> tuple[int, int]:
        """(useful, dispatched) LUT cells across the plan's kernel steps."""
        fused_members = {id(b) for s in self.fused_stacks for b in s.banks}
        useful = dispatched = 0
        for s in self.fused_stacks:
            c = s.banks[0].layer.num_centroids
            dispatched += len(s.banks) * max(s.ks) * c * int(s.lut.shape[-1])
            useful += sum(b.layer.num_groups * c * b.layer.out_features
                          for b in s.banks)
        for b in self.banks:
            if id(b) not in fused_members:
                cells = (b.layer.num_groups * b.layer.num_centroids
                         * b.layer.out_features)
                useful += cells
                dispatched += cells
        return useful, dispatched

    def compile_stats(self) -> dict:
        """Per-plan dispatch counters (the serving stats surface)."""
        with self._lock:
            traces = self._traces
            jit_calls = self._calls
            buckets = sorted(self._traced)
            rows = {k: list(v) for k, v in self._rows.items()}
        useful, dispatched = self._lut_cell_stats()
        fused_eff = useful / dispatched if dispatched else 1.0

        def _waste(be: str, req: int, disp: int) -> float:
            if not disp:
                return 0.0
            eff = fused_eff if be in ("kernel", "kernel_q8") else 1.0
            return round(1.0 - (req / disp) * eff, 4)

        return {
            "traces": traces,
            "jit_calls": jit_calls,
            "bucket_hits": jit_calls - traces,
            "buckets": buckets,
            # rows asked for and rows dispatched (the bucket's), per bucket
            "rows": {f"{be}@{bucket}": rows[(be, bucket)] for be, bucket in sorted(rows)},
            "pad_waste": {
                f"{be}@{bucket}": _waste(be, req, disp)
                for (be, bucket), (req, disp) in sorted(rows.items())
            },
            "pad_waste_fused": {
                f"group{g}": {
                    "layers": len(s.banks),
                    "kmax": max(s.ks),
                    "nmax": int(s.lut.shape[-1]),
                    "frac": round(
                        1.0 - sum(b.layer.num_groups * b.layer.num_centroids
                                  * b.layer.out_features for b in s.banks)
                        / (len(s.banks) * max(s.ks)
                           * s.banks[0].layer.num_centroids
                           * int(s.lut.shape[-1])), 4),
                }
                for g, s in enumerate(self.fused_stacks)
            },
            "fused_groups": self.fused_groups,
            "fused_banks": self.fused_banks,
            # the sharded width: how many devices the batch axis splits
            # across (1 = single-device; placed calls don't change it)
            "devices": 1 if self.devices is None else len(self.devices),
            # plan-audit finding counts (repro_torch.analysis.planaudit),
            # None when the plan was built with audit="off" and never audited
            "audit": None if self.audit_report is None
            else dict(self.audit_report.counts),
        }

    @property
    def num_banks(self) -> int:
        return len(self.banks)

    def bank_inputs(self, *inputs, backend: str = "gather") -> list:
        """Forward once (unpadded), recording the first activation each
        bank receives; fused steps are walked per bank."""
        rec: dict[int, torch.Tensor] = {}

        def apply(step, x):
            if isinstance(step, FusedBankStack):
                h = x
                for member in step.banks:
                    rec.setdefault(id(member), h)
                    h = member.apply(h, backend)
                return h
            rec.setdefault(id(step), x)
            return step.apply(x, backend)

        with torch.no_grad():
            self._forward(apply, self._state,
                          *(torch.as_tensor(x, device=self.device) for x in inputs))
        return [rec.get(id(b)) for b in self.banks]

    def table_bytes(self) -> int:
        """Total LUT bytes held by the plan's banks (f32 + int8 layouts)."""
        return sum(b.lut.numel() * b.lut.element_size()
                   + b.lut_q8.numel() * b.lut_q8.element_size() for b in self.banks)


def _replicate(obj, device: torch.device, memo: dict):
    """``obj`` (a plan's state: banks, fused stacks, tensors, trees, and
    the dicts and lists holding them) rebuilt on ``device``; a bank shared
    by a stack and the state is replicated once."""
    if id(obj) in memo:
        return memo[id(obj)]
    if isinstance(obj, CompiledBank):
        out = CompiledBank(obj.layer, device=device)
    elif isinstance(obj, FusedBankStack):
        out = FusedBankStack([_replicate(b, device, memo) for b in obj.banks])
    elif isinstance(obj, (torch.Tensor, FuzzyTree)):
        out = obj.to(device)
    elif isinstance(obj, dict):
        out = {k: _replicate(v, device, memo) for k, v in obj.items()}
    elif isinstance(obj, (list, tuple)):
        out = type(obj)(_replicate(v, device, memo) for v in obj)
    else:
        out = obj
    memo[id(obj)] = out
    return out


def _compile_banks(layers: Sequence[PegasusLinear], device) -> list[CompiledBank]:
    return [CompiledBank(l, device=device) for l in layers]


def _note_fusion(plan: ExecutionPlan, steps: Sequence) -> None:
    for s in steps:
        if isinstance(s, FusedBankStack):
            plan.fused_groups += 1
            plan.fused_banks += len(s.banks)
            plan.fused_stacks.append(s)


def _sequential_plan(layers, backend, buckets, fuse, nmax_cap, device) -> ExecutionPlan:
    banks = _compile_banks(layers, device)
    steps = fuse_banks(banks, nmax_cap=nmax_cap) if fuse else list(banks)

    def forward(apply, state, x):
        h = x.to(torch.float32)
        for step in state["steps"]:
            h = apply(step, h)
        return h

    plan = ExecutionPlan(banks, forward, {"steps": steps}, device=device,
                         backend=backend, family="sequential", bucket_sizes=buckets)
    _note_fusion(plan, steps)
    return plan


def _rnn_plan(model, backend, buckets, device) -> ExecutionPlan:
    x_banks = _compile_banks(model.x_banks, device)
    h_banks = _compile_banks(model.h_banks, device)
    out_bank = CompiledBank(model.out_bank, device=device)
    window = int(model.window)   # the unroll length is frozen into the plan

    def forward(apply, state, x):
        xf = x.to(torch.float32)
        h_pre = apply(state["x"][0], xf[:, 0])
        for t in range(1, window):
            h_pre = apply(state["x"][t], xf[:, t]) + apply(state["h"][t - 1], h_pre)
        return apply(state["out"], h_pre)

    state = {"x": x_banks, "h": h_banks, "out": out_bank}
    return ExecutionPlan(x_banks + h_banks + [out_bank], forward, state, device=device,
                         backend=backend, family="rnn", bucket_sizes=buckets)


def _cnn_plan(model, backend, buckets, fuse, nmax_cap, device) -> ExecutionPlan:
    from repro_torch.nets.cnn import _windows  # structural helper, no cycle at call time

    window_bank = CompiledBank(model.window_bank, device=device)
    head_banks = _compile_banks(model.head_banks, device)
    # the head chain after the window pool is an ordinary sequential run —
    # fusable; the windowed step itself stays structural (per-window batch)
    head_steps = fuse_banks(head_banks, nmax_cap=nmax_cap) if fuse else list(head_banks)
    nam = bool(model.nam)        # static branch selector
    state = {
        "window": window_bank,
        "heads": head_steps,
        "out_bias": None if model.out_bias is None else torch.as_tensor(
            model.out_bias, dtype=torch.float32, device=device),
    }

    def forward(apply, state, x):
        win = _windows(x.to(torch.float32))           # [B, P, KERNEL*f]
        b, pcount, wdim = win.shape
        contrib = apply(state["window"], win.reshape(-1, wdim)).reshape(b, pcount, -1)
        if nam:
            return contrib.sum(dim=1) + state["out_bias"]  # single SumReduce
        h = contrib.mean(dim=1)                        # rows already ReLU'd
        for step in state["heads"]:
            h = apply(step, h)
        return h

    plan = ExecutionPlan([window_bank] + head_banks, forward, state, device=device,
                         backend=backend, family="cnn", bucket_sizes=buckets)
    plan._rows_per_flow[id(window_bank)] = int(model.pool_windows)
    _note_fusion(plan, head_steps)
    return plan


def _cnn_l_plan(model, backend, buckets, device) -> ExecutionPlan:
    from repro_torch.nets.cnn import _packet_feats

    bank1 = CompiledBank(model.bank1, device=device)
    bank2 = CompiledBank(model.bank2, device=device)
    state = {
        "b1": bank1,
        "b2": bank2,
        "emb_tree": model.emb_tree.to(device),
        "logit_lut": torch.as_tensor(model.logit_lut, dtype=torch.float32, device=device),
        "bias": torch.as_tensor(model.bias, dtype=torch.float32, device=device),
    }

    def forward(apply, state, seq, payload):
        x = _packet_feats(seq, payload) * 255.0       # [B, W, 62]
        b, w, d = x.shape
        h_pre = apply(state["b1"], x.reshape(-1, d))
        emb = torch.tanh(apply(state["b2"], h_pre))
        idx = hard_index(state["emb_tree"], emb)
        contrib = state["logit_lut"][idx].reshape(b, w, -1)
        return contrib.sum(dim=1) + state["bias"]

    plan = ExecutionPlan([bank1, bank2], forward, state, device=device, backend=backend,
                         family="cnn_l", bucket_sizes=buckets)
    # one row per packet of the traffic's window
    plan._rows_per_flow.update({id(bank1): WINDOW, id(bank2): WINDOW})
    return plan


def build_plan(
    model: Any,
    *,
    backend: str = "onehot",
    bucket_sizes: Sequence[int] | None = None,
    fuse: bool = True,
    fuse_nmax_cap: int | None = DEFAULT_FUSE_NMAX_CAP,
    device: str | torch.device | None = None,
    devices=None,
    audit: str = "warn",
) -> ExecutionPlan:
    """Compile any pegasusified model into an ExecutionPlan on ``device``.

    Dispatch is structural (no imports of the net modules at module scope):
      * ``PegasusLinear`` or a list/tuple of them → sequential stack (MLP-B,
        the AutoEncoder's ``AEBanks``)
      * ``.x_banks``/``.h_banks``    → ``PegasusRNN``
      * ``.emb_tree``/``.logit_lut`` → ``PegasusCNNL`` (two-level NAM)
      * ``.window_bank``             → ``PegasusCNN`` (B and M/NAM)
    Anything else raises ``TypeError`` at build time.

    ``backend`` is the default of ``plan(x)`` calls; ``fuse=False``
    disables cross-bank fusion; ``fuse_nmax_cap`` bounds a fused group's
    padded output width. The plan freezes all model state at build, banks
    and non-bank attributes alike (RNN window, CNN nam/out_bias, CNN-L
    emb_tree/logit_lut/bias): rebuild it after mutating the model, or go
    through ``plan_for``, which notices and recompiles. The plan runs on
    the GPU unless ``device="cpu"``.

    ``devices`` (what :func:`resolve_devices` takes: a count of CUDA
    devices or a sequence of devices, which may repeat) shards every call:
    with K > 1 devices each padded bucket splits into K equal row shards,
    each run on its device against its own replica of the plan's tensors,
    the outputs concatenated in row order on ``devices[0]`` (the plan's
    device; ``device``, if given, must name it). A bucket K does not
    divide raises ``ValueError``, and so does a per-call ``device=``.
    ``MultiModelServer(devices=...)`` places whole calls instead.

    ``audit`` runs the static plan audit
    (:mod:`repro_torch.analysis.planaudit`, PGA101-PGA106) over the new
    plan: ``"warn"`` (the default) attaches the report as
    ``plan.audit_report`` and raises a ``UserWarning`` when it carries
    error or warning findings, ``"error"`` raises
    :class:`~repro_torch.analysis.planaudit.PlanAuditError` on error
    findings, ``"off"`` skips it (``audit_report`` stays ``None``). The
    audit reads the plan's tables on the host and launches nothing, before
    any graph is captured.
    """
    if audit not in ("off", "warn", "error"):
        raise ValueError(f"audit must be 'off'|'warn'|'error', got {audit!r}")
    devs = resolve_devices(devices)
    dev = devs[0] if devs is not None and device is None else resolve_device(device)
    # the onehot backend is an fp32 matmul: TF32 would cost it fp32 parity
    torch.backends.cuda.matmul.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("could not switch TF32 matmuls off")
    if isinstance(model, PegasusLinear):
        plan = _sequential_plan([model], backend, bucket_sizes, fuse, fuse_nmax_cap, dev)
    elif isinstance(model, (list, tuple)):
        if not all(isinstance(l, PegasusLinear) for l in model):
            raise TypeError("bank list must contain only PegasusLinear")
        plan = _sequential_plan(model, backend, bucket_sizes, fuse, fuse_nmax_cap, dev)
    elif hasattr(model, "x_banks") and hasattr(model, "h_banks"):
        plan = _rnn_plan(model, backend, bucket_sizes, dev)
    elif hasattr(model, "emb_tree") and hasattr(model, "logit_lut"):
        plan = _cnn_l_plan(model, backend, bucket_sizes, dev)
    elif hasattr(model, "window_bank"):
        plan = _cnn_plan(model, backend, bucket_sizes, fuse, fuse_nmax_cap, dev)
    else:
        raise TypeError(f"don't know how to compile {type(model).__name__} into a plan")
    plan.shard_over(devs)
    plan._aux_token = _model_aux(model)
    plan.fuse_cfg = {"fuse": fuse, "nmax_cap": fuse_nmax_cap}
    _run_build_audit(plan, audit)
    return plan


def _run_build_audit(plan: ExecutionPlan, audit: str) -> None:
    """Build-time hook into the plan audit."""
    if audit == "off":
        return
    report = audit_plan(plan)
    plan.audit_report = report
    counts = report.counts
    if audit == "error" and counts["error"]:
        raise PlanAuditError(report)
    if counts["error"] or counts["warning"]:
        warnings.warn(
            f"plan audit: {counts['error']} error / {counts['warning']} "
            f"warning finding(s) — inspect plan.audit_report or rerun "
            f"`python -m repro_torch.analysis plan`:\n{report}",
            stacklevel=3)


# ---------------------------------------------------------------------------
# Model-structure helpers shared with the registry (repro_torch.engine.registry),
# which owns all plan memoization: weakref-watched, bounded, evictable.
# ---------------------------------------------------------------------------


def _model_key(model: Any, kw: dict) -> tuple:
    if isinstance(model, (list, tuple)):
        ids: tuple = tuple(id(l) for l in model)
    else:
        ids = (id(model),)
    return (*ids, tuple(sorted(kw.items())))


def _model_aux(model: Any) -> tuple:
    """Non-bank model state a compiled plan froze at build time (window
    length, NAM flag, out-bias, embedding tree, logit LUT). The registry
    must rebuild when any of it is reassigned: a stale memo hit would serve
    outputs from the pre-mutation tensors."""
    if hasattr(model, "x_banks") and hasattr(model, "h_banks"):
        return (int(model.window),)
    if hasattr(model, "emb_tree") and hasattr(model, "logit_lut"):
        return (model.emb_tree, model.logit_lut, model.bias)
    if hasattr(model, "window_bank"):
        return (bool(model.nam), model.out_bias)
    return ()


def _aux_matches(a: tuple, b: tuple) -> bool:
    """Identity for tensor-like entries (``==`` on tensors is elementwise),
    equality for plain scalars."""
    return len(a) == len(b) and all(
        x is y or (isinstance(x, (bool, int)) and isinstance(y, (bool, int))
                   and x == y)
        for x, y in zip(a, b))


def _model_banks(model: Any) -> tuple:
    """Current bank layers of a model, in plan construction order — used to
    detect in-place mutation (``peg.window_bank = ...``) that would
    otherwise hit the memo with a stale compiled plan."""
    if isinstance(model, PegasusLinear):
        return (model,)
    if isinstance(model, (list, tuple)):
        return tuple(model)
    if hasattr(model, "x_banks") and hasattr(model, "h_banks"):
        return (*model.x_banks, *model.h_banks, model.out_bank)
    if hasattr(model, "emb_tree") and hasattr(model, "logit_lut"):
        return (model.bank1, model.bank2)
    if hasattr(model, "window_bank"):
        return (model.window_bank, *model.head_banks)
    return ()
