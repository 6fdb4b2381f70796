"""Serving entry points of the port (port of ``repro.launch.serve``).

``PegasusServer`` compiles ONE model's plan once (int32 features, LUTs, int8
LUT + scales on the GPU) and serves request lists: requests are coalesced,
chunked along the bucket ladder (full chunks are exact buckets, the tail
pads minimally) and the outputs split back per request.

``MultiModelServer`` serves MANY named heterogeneous models (MLP, RNN, CNN,
AE ...) behind one server: plans pinned in a :class:`PlanRegistry`,
requests addressed by model name, same-model requests coalesced into
bucket-aligned micro-batches, models scheduled by weighted fair queueing
(:class:`~repro_torch.launch.scheduler.WFQScheduler`), per-model circuit
breakers with a fallback to the ``gather`` backend after injected faults,
bounded retries, and optionally a
:class:`~repro_torch.launch.devices.DeviceStreamPool` that places each
chunk on the least-loaded CUDA stream. ``AsyncMultiModelServer``
makes it an always-on service: a background drain thread, thread-safe
``submit()`` returning futures, ``infer_async()`` for asyncio, and bounded
queues with reject/block backpressure. On the card every plan call replays
a CUDA graph (see :class:`~repro_torch.engine.plan.ExecutionPlan`).

``Server`` is the LM half: batched greedy decode of one model from the LM
stack (:mod:`repro_torch.models`) against preallocated caches, with
``make_serve_step`` / ``make_prefill_step`` as its units; on a mesh its
params and caches are DTensors (``Server(cfg, mesh=...)``).

Run the demos on the GPU (under ``torchrun``, ``--arch`` serves on a
``(1, world)`` mesh)::

    PYTHONPATH=src python -m repro_torch.launch.serve --pegasus --backend kernel_q8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_vl_2b [--smoke]
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \\
        --arch qwen2_vl_2b --smoke
"""

from __future__ import annotations

import argparse
import asyncio
import concurrent.futures
import functools
import math
import threading
import time
import warnings
from collections import deque
from concurrent.futures import Future
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import spans as _spans
from repro_torch.analysis.sanitizer import ThreadAffinity, make_lock
from repro_torch.configs.registry import ArchConfig, get_config, smoke_config
from repro_torch.device import resolve_device
from repro_torch.engine import DEFAULT_BUCKETS, PlanRegistry, bucket_chunks, build_plan
from repro_torch.engine.plan import bucket_batch, resolve_devices
from repro_torch.models.sharding import replicate
from repro_torch.models.transformer import (
    decode_step, forward_train, init_decode_state, init_model,
)

from .chaos import InjectedFaultError
from .devices import DeviceStreamPool
from .health import CLOSED, CircuitBreaker
from .mesh import (
    batch_specs, decode_state_specs, distribute, distribute_params, mesh_device, named,
    param_specs, replicate_unit_dims, world_mesh,
)
from .request import InferRequest, InferResult
from .scheduler import (
    PRIORITY_WEIGHTS, DeadlineExceededError, QueueFullError, WFQScheduler,
)

__all__ = ["Server", "make_serve_step", "make_prefill_step", "PegasusServer", "MultiModelServer", "AsyncMultiModelServer",
           "PartialDrainError", "QueueFullError", "DeadlineExceededError",
           "PRIORITY_WEIGHTS", "InferRequest", "InferResult", "DeviceStreamPool",
           "ServerStoppedError", "PoisonedRequestError", "FALLBACK_BACKEND", "main"]

# The bottom rung of the backend fallback ladder: plain PyTorch gather — no
# CUDA kernel of ours, no one-hot matmul, the least machinery that can fail.
# A model whose preferred-backend path trips its breaker on injected faults
# keeps serving on a gather plan (degraded, counted in fallback_batches)
# until a probe back on the preferred path succeeds. A real failure (a
# kernel that does not build or launch, a failed capture) never degrades:
# its slices fail until a probe succeeds.
FALLBACK_BACKEND = "gather"


def _warn_legacy(what: str, instead: str) -> None:
    """One DeprecationWarning per call site for the pre-typed call shapes,
    kept as working shims."""
    warnings.warn(
        f"{what} is deprecated; {instead} (see repro_torch.launch.request)",
        DeprecationWarning, stacklevel=3)


def _as_requests(requests, *, named: bool) -> tuple[list, bool]:
    """Normalize a ``serve()`` argument into ``(list[InferRequest], typed)``.

    :class:`InferRequest` items pass through. Legacy items — bare arrays or
    input tuples when ``named=False`` (``PegasusServer``), ``(name,
    inputs[, deadline_ms])`` triples when ``named=True``
    (``MultiModelServer``) — are wrapped and the caller warns. Mixing the
    two shapes is a ``TypeError``."""
    items = list(requests)
    if not items:
        return [], True
    n_typed = sum(isinstance(r, InferRequest) for r in items)
    if n_typed == len(items):
        return items, True
    if n_typed:
        raise TypeError(
            "serve() got a mix of InferRequest and legacy-shaped items — "
            "pass one or the other, not both")
    out = []
    for item in items:
        if named:
            deadline_ms = item[2] if len(item) > 2 else None
            out.append(InferRequest(item[0], item[1], deadline_ms=deadline_ms))
        else:
            out.append(InferRequest(
                "", tuple(item) if isinstance(item, (tuple, list)) else item))
    return out, False


class PartialDrainError(RuntimeError):
    """Some requests did not serve — a model failed to drain and/or
    deadline-bearing requests were shed — while the rest completed.

    Carries ``partial_results`` (``{name: [outputs]}`` for every model that
    served, a failed model's served prefix included — its name in
    ``failed`` marks it incomplete), ``failed`` (``{name: exception}``),
    ``shed`` (``{name: [DeadlineExceededError per shed request]}``; shed
    work was never computed) and, as ``__cause__``, the first underlying
    exception."""

    def __init__(self, failed: dict, partial_results: dict,
                 shed: dict | None = None):
        self.failed = dict(failed)
        self.partial_results = partial_results
        self.shed = {k: list(v) for k, v in (shed or {}).items()}
        parts = []
        if self.failed:
            names = ", ".join(sorted(self.failed))
            parts.append(f"model(s) {names} failed to drain: "
                         f"{next(iter(self.failed.values()))!r}")
        if self.shed:
            n = sum(len(v) for v in self.shed.values())
            parts.append(f"{n} request(s) shed past their deadline on "
                         f"{', '.join(sorted(self.shed))}")
        super().__init__(
            "; ".join(parts) + " (served models' outputs are in "
            ".partial_results; per-model errors in .failed; shed requests "
            "in .shed)")


class ServerStoppedError(RuntimeError):
    """The server was stopped with this request still queued
    (``AsyncMultiModelServer.stop(drain=False)``): it was not served and
    will not be; resubmit after ``start()`` if the work is still wanted."""


class PoisonedRequestError(RuntimeError):
    """A request exhausted its bounded retries (``max_requeues``
    requeue-at-front attempts all failed); the last dispatch error rides in
    ``__cause__``."""


def _resolve_future(fut: Future | None, *, result=None,
                    error: BaseException | None = None) -> None:
    """Resolve a request future, tolerating a caller-side cancel racing the
    resolution (these futures are never set running, so ``cancel()`` can
    win between the done() check and the set)."""
    if fut is None or fut.done():
        return
    try:
        if error is not None:
            fut.set_exception(error)
        else:
            fut.set_result(result)
    except concurrent.futures.InvalidStateError:
        pass    # cancelled mid-resolution: the caller owns that outcome


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pageable_nbytes(x) -> int:
    """Bytes of ``x`` held in host memory that is not pinned (a numpy array,
    or a CPU tensor outside pinned memory); 0 for pinned or device tensors."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu" or x.is_pinned():
            return 0
        return x.numel() * x.element_size()
    return int(np.asarray(x).nbytes)


class _StageSlot:
    """One slot of a :class:`PinnedStage`: a host byte buffer per input
    position (and a numpy view of each), and the event recorded after the
    copies out of them; in a stage that brings outputs back, one buffer
    and the event recorded after the copy into it."""

    __slots__ = ("device", "event", "bufs", "arrays", "busy", "pin", "typed", "layout")

    def __init__(self, device: torch.device, event, pin: bool):
        self.device, self.event, self.pin = device, event, pin
        self.bufs: list[torch.Tensor] = []
        self.arrays: list[np.ndarray] = []
        self.busy = True
        self.typed: tuple = ()         # the first buffer as rows: (torch, numpy)
        self.layout: tuple | None = None

    def _bytes(self, i: int, nbytes: int) -> np.ndarray:
        """Position ``i``'s buffer, replaced by one twice as large as often
        as it takes to hold ``nbytes``; its first ``nbytes`` as numpy."""
        if i == len(self.bufs):
            self.bufs.append(torch.empty(0, dtype=torch.uint8))
            self.arrays.append(self.bufs[i].numpy())
        size = self.bufs[i].numel() or nbytes
        while size < nbytes:
            size *= 2
        if size != self.bufs[i].numel():
            self.bufs[i] = torch.empty(size, dtype=torch.uint8, pin_memory=self.pin)
            self.arrays[i] = self.bufs[i].numpy()
        return self.arrays[i][:nbytes]

    def rows(self, dtype: torch.dtype, trailing: torch.Size, n: int) -> torch.Tensor:
        """``n`` rows of ``dtype`` and shape ``trailing`` at the start of
        the first buffer, grown to hold them. The whole buffer's typed view
        is kept while it fits, so that a round costs one slice here. A slot
        serves either :meth:`pack` or this."""
        if self.layout != (dtype, trailing) or len(self.typed[0]) < n:
            row = math.prod(trailing) * dtype.itemsize
            self._bytes(0, n * row)
            cap = self.bufs[0].numel() // row
            t = self.bufs[0][:cap * row].view(dtype).view(cap, *trailing)
            self.typed, self.layout = (t, t.numpy()), (dtype, trailing)
        return self.typed[0][:n]

    def pack(self, cols: list[list], rows: int | None = None) -> list[torch.Tensor]:
        """Pack each input position's per-request host arrays (numpy arrays,
        CPU tensors or lists) into this slot's buffer for that position, one
        host copy a request; returns one ``(rows, *trailing)`` view a
        position (``rows`` the requests' total when None, the rows past the
        total zero), in the dtype ``torch.cat`` gives and raising as it
        does. Numpy requests of one dtype and trailing shape, the usual
        case, are copied by numpy, which costs less per call than torch."""
        views = []
        for i, col in enumerate(cols):
            first = col[0]
            if (isinstance(first, np.ndarray) and first.ndim
                    and all(isinstance(x, np.ndarray) and x.dtype == first.dtype
                            and x.shape[1:] == first.shape[1:] for x in col)):
                total = sum(len(x) for x in col)
                shape = (total if rows is None else rows, *first.shape[1:])
                out = self._bytes(i, math.prod(shape) * first.itemsize)
                out = out.view(first.dtype).reshape(shape)
                np.concatenate(col, out=out[:total])
                out[total:] = 0
                views.append(torch.from_numpy(out))
                continue
            parts = [torch.as_tensor(x) for x in col]
            dtype = functools.reduce(torch.promote_types, (p.dtype for p in parts))
            total = sum(p.shape[0] if p.dim() else 1 for p in parts)
            shape = (total if rows is None else rows, *parts[0].shape[1:])
            nbytes = math.prod(shape) * dtype.itemsize
            self._bytes(i, nbytes)
            view = self.bufs[i][:nbytes].view(dtype).view(shape)
            torch.cat(parts, out=view[:total])
            if total < shape[0]:
                view[total:].zero_()
            views.append(view)
        return views


class PinnedStage:
    """Page-locked host buffers that a server packs each group's host inputs
    into, so that every input crosses to the card in asynchronous copies
    (on the direct path one a chunk, straight into a graph's static input)
    instead of one blocking pageable copy a request.

    A slot is handed out only once the event recorded after its last copies
    has completed: each group of a round in flight holds a slot of its own,
    and a slot still being read by the device is never written. A second
    stage brings each group's outputs back (each chunk's rows on the direct
    path, :meth:`copy_back` off it): there a slot is handed back only once
    the host has taken the outputs out.
    ``pin`` and ``event`` (a factory of objects with ``record(stream)``,
    ``query()`` and ``synchronize()``) are what tests replace to run it
    without a card."""

    def __init__(self, *, pin: bool = True, event=None):
        self._pin = pin
        self._event = torch.cuda.Event if event is None else event
        self._slot_lock = make_lock("serve._stage_lock")
        self._slots: list[_StageSlot] = []           # guarded-by: _slot_lock

    def take(self, device: torch.device) -> _StageSlot:
        """A free slot for ``device`` whose copies have completed, else a
        new one; it is the caller's until :meth:`release`."""
        with self._slot_lock:
            for s in self._slots:
                if not s.busy and s.device == device and s.event.query():
                    s.busy = True
                    return s
            s = _StageSlot(device, self._event(), self._pin)
            self._slots.append(s)
            return s

    def release(self, slot: _StageSlot, stream) -> None:
        """Record ``slot``'s event on ``stream``, after the copies out of it
        that were enqueued there, and hand the slot back."""
        slot.event.record(stream)
        self._hand_back(slot)

    def _hand_back(self, slot: _StageSlot) -> None:
        with self._slot_lock:
            slot.busy = False

    def copy_back(self, out: torch.Tensor, stream) -> "_CopyBack":
        """Enqueue on ``stream`` one copy of ``out`` (a group's outputs on
        the device) into a slot, which does not block the host, and record
        the slot's event after it. The slot is the returned handle's until
        the host has taken the outputs out."""
        back = _CopyBack(self, self.take(out.device), len(out))
        try:
            back.write(0, out)
            back.slot.event.record(stream)
        except Exception:
            back.drop()
            raise
        return back


class _CopyBack:
    """A group's outputs on their way into a slot of a :class:`PinnedStage`,
    with the event recorded after the copy."""

    __slots__ = ("stage", "slot", "rows")

    def __init__(self, stage: PinnedStage, slot: _StageSlot, rows: int):
        self.stage, self.slot, self.rows = stage, slot, rows

    def write(self, at: int, y: torch.Tensor) -> None:
        """Enqueue on the current stream the copy of ``y``, output rows on
        the device, into the slot's rows from ``at`` on; it does not block
        the host."""
        self.slot.rows(y.dtype, y.shape[1:], self.rows)[at:at + len(y)].copy_(
            y, non_blocking=True)

    def result(self) -> np.ndarray:
        """Wait on the copy's event alone, never on the stream, which may
        hold later rounds' work; copy the outputs out of the slot and hand
        it back, so that no result aliases memory a later copy writes."""
        try:
            self.slot.event.synchronize()
            return self.slot.typed[1][:self.rows].copy()
        finally:
            self.drop()

    def drop(self) -> None:
        """Hand the slot back unread: it is taken again only once its
        event has completed."""
        self.stage._hand_back(self.slot)


class _Coalesced(NamedTuple):
    """A group's requests in one place for one plan (:func:`_coalesce`)."""

    inputs: list            # one concatenation an input position
    sizes: list[int]        # the requests' rows
    total: int
    chunks: list[int]       # the total cut by bucket_chunks
    pageable: int           # bytes bound for the device from pageable host memory
    staged: int             # bytes bound for it through the stage
    slot: "_StageSlot | None"   # held: the staged inputs are views of it


def _coalesce(requests, device: torch.device | None, stage: PinnedStage,
              buckets=DEFAULT_BUCKETS, max_batch: int | None = None,
              hold: bool = False) -> _Coalesced:
    """Per-input concatenations on ``device`` (numpy on the host when
    ``device`` is None), per-request sizes, their total and its
    ``bucket_chunks``, and the bytes bound for ``device`` from pageable
    host memory and through ``stage``.

    On a CUDA device, an input that every request holds on the host is
    packed into a slot of ``stage``. With ``hold`` its concatenation is the
    slot's host view, padded with zero rows up to the last chunk's bucket,
    and the slot comes back held: the caller copies the chunks out of it
    and then releases it (:meth:`PinnedStage.release`). Without, it
    crosses at once in one copy that does not block the host. An input
    some request holds on the card is concatenated there."""
    sizes = [int(np.shape(r[0])[0]) for r in requests]
    total = sum(sizes)
    chunks = bucket_chunks(total, buckets, max_batch)
    cols = [[r[i] for r in requests] for i in range(len(requests[0]))]
    if device is None:
        return _Coalesced([np.concatenate([_host(x) for x in col]) for col in cols],
                          sizes, total, chunks, 0, 0, None)
    staged = ([i for i, col in enumerate(cols)
               if all(not isinstance(x, torch.Tensor) or x.device.type == "cpu" for x in col)]
              if device.type == "cuda" else [])
    cat = [None] * len(cols)
    pageable = 0
    for i, col in enumerate(cols):    # first, so that nothing but the pack can raise
        if i not in staged:           # while a slot is held
            cat[i] = torch.cat([torch.as_tensor(x, device=device) for x in col])
            pageable += sum(_pageable_nbytes(x) for x in col)
    staged_bytes, slot = 0, None
    if staged:
        stream = torch.cuda.current_stream(device)
        rows = total - chunks[-1] + bucket_batch(chunks[-1], buckets) if hold else None
        slot = stage.take(device)
        try:
            for i, view in zip(staged, slot.pack([cols[i] for i in staged], rows)):
                cat[i] = view if hold else view.to(device, non_blocking=True)
                staged_bytes += view.nbytes // len(view) * total    # padding not counted
        except BaseException:
            stage.release(slot, stream)
            raise
        if not hold:
            stage.release(slot, stream)
            slot = None
    return _Coalesced(cat, sizes, total, chunks, pageable, staged_bytes, slot)


class _Group:
    """One pulled slice of one model between its begin and its finish.
    ``managed``: no caller backend override, so it rides the fallback
    ladder and feeds the model's breaker; ``probe``: the breaker's cooldown
    probe; ``degraded``: served on the fallback plan; ``error``: the
    begin's failure; ``outs``: what :func:`_serve_inline` returned, or the
    stream pool's futures; ``void``: dropped behind a failed finish."""

    __slots__ = ("name", "reqs", "t0", "managed", "probe", "degraded", "error", "outs",
                 "sizes", "total", "batches", "pageable", "staged", "t_begun", "void")

    def __init__(self, name: str, reqs: list, t0: float, managed: bool):
        self.name, self.reqs, self.t0, self.managed = name, reqs, t0, managed
        self.probe = self.degraded = self.void = False
        self.error: Exception | None = None
        self.outs = None
        self.sizes: list[int] = []
        self.total = self.batches = self.pageable = self.staged = 0
        self.t_begun = t0


def _landed(g: _Group) -> bool:
    """Whether a begun group has nothing left on the device: its copy
    back's event has completed (a query, no wait), its pool futures are
    done, or its outputs were never the device's."""
    out = g.outs
    if isinstance(out, _CopyBack):
        return out.slot.event.query()
    if isinstance(out, list):
        return all(f.done() for f in out)
    return True


def _serve_inline(plan, requests, stage: PinnedStage, back: PinnedStage, *, backend,
                  max_batch: int | None, jit: bool = True, each=None):
    """Serve ``requests`` (input tuples) through ``plan`` on the calling
    thread: coalesce them, call the plan once a chunk and start the
    outputs' way back. Returns the :class:`_Coalesced` requests and what
    :func:`_split` takes; ``each(direct)`` is called after each chunk's
    plan call.

    On a single-device CUDA plan that replays its graphs (the direct
    path), each chunk's data crosses the plan boundary once each way
    (:meth:`ExecutionPlan.call_into`): the staged inputs go from the
    stage's slot straight into the graph's static inputs, the last chunk
    with its padded rows, and the output rows straight into their rows of
    one slot of ``back``, whose event is recorded after the last chunk's
    copy. The input slot is released once every chunk's copies are
    enqueued, and a group that fails partway hands both slots back. Off
    that path each call returns a fresh tensor and :func:`_copy_back`
    brings them back."""
    direct = jit and plan.device.type == "cuda" and not plan.sharded
    rec = _spans.RECORDER
    t = 0.0 if rec is None else time.perf_counter()
    co = _coalesce(requests, plan.device, stage, plan.buckets, max_batch, hold=direct)
    if rec is not None:
        rec.add(_spans.SERVER_COALESCE, t, time.perf_counter())
    stream = torch.cuda.current_stream(plan.device) if direct else None
    sink, outs, start, last = None, [], 0, len(co.chunks) - 1
    try:
        if direct:
            sink = _CopyBack(back, back.take(plan.device), co.total)
        for i, size in enumerate(co.chunks):
            end = None if i == last else start + size     # the last takes the padded rows
            sl = co.inputs if start == 0 and end is None else [c[start:end] for c in co.inputs]
            t = 0.0 if rec is None else time.perf_counter()
            if direct:
                plan.call_into(sl, size, functools.partial(sink.write, start), backend=backend)
            else:
                outs.append(plan(*sl, backend=backend, jit=jit))
            if rec is not None:
                rec.add(_spans.PLAN_CALL, t, time.perf_counter())
            if each is not None:
                each(direct)
            start += size
        if direct:
            sink.slot.event.record(stream)
    except BaseException:
        if sink is not None:
            back.release(sink.slot, stream)
        raise
    finally:
        if co.slot is not None:
            stage.release(co.slot, stream)
    return co, (sink if direct else _copy_back(outs, back))


def _copy_back(outs: list[torch.Tensor], stage: PinnedStage):
    """Off the direct path of :func:`_serve_inline`: concatenate a group's
    chunk outputs and, on a CUDA device, enqueue their copy into a slot of
    ``stage`` behind the group's plan calls; returns the copy's handle, or
    off the card the concatenation."""
    out = torch.cat(outs) if len(outs) > 1 else outs[0]
    if out.device.type != "cuda":
        return out
    return stage.copy_back(out, torch.cuda.current_stream(out.device))


def _split(back, sizes: list[int]) -> list[np.ndarray]:
    """The outputs :func:`_serve_inline` started back, on the host (a copy
    into a slot is waited for on its event alone) and cut back into
    per-request arrays."""
    rec = _spans.RECORDER
    t = 0.0 if rec is None else time.perf_counter()
    host = back.result() if isinstance(back, _CopyBack) else back.cpu().numpy()
    if rec is not None:
        rec.add(_spans.SERVER_COPY_BACK, t, time.perf_counter())
    split, at = [], 0
    for n in sizes:
        split.append(host[at:at + n])
        at += n
    return split


def make_serve_step(cfg: ArchConfig):
    """One greedy decode step for the whole batch: ``(params, state, tokens
    [B,1], pos) → (next tokens [B,1] int32, state)``; the state is updated
    in place."""
    @torch.no_grad()
    def serve_step(params, state, tokens, pos: int, enc_out=None):
        logits, state = decode_step(cfg, params, state, tokens, pos, enc_out=enc_out)
        # argmax over a vocab-sharded dim has no DTensor rule: gather the
        # [B, V] logits first (a no-op off a mesh)
        return torch.argmax(replicate(logits), dim=-1).to(torch.int32)[:, None], state

    return serve_step


def make_prefill_step(cfg: ArchConfig, *, last_only: bool = True):
    """``(params, batch) → greedy next token [B] int32`` after the prompt."""
    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = forward_train(cfg, params, batch, last_only=last_only)
        # as in serve_step: the last position's [B, V] logits gathered
        return torch.argmax(replicate(logits[:, -1]), dim=-1).to(torch.int32)

    return prefill_step


class Server:
    """Minimal batched greedy-decode server for one LM.

    ``params`` takes weights carried across with
    :func:`repro_torch.interop.lm_params_from_arrays` (moved to ``device``);
    without it the model is drawn from a generator seeded 0 on ``device``,
    as the reference initialises from ``PRNGKey(0)`` (other numbers).
    With ``mesh`` (a ``DeviceMesh`` with "data" and "model" axes; every rank
    calls the server alike) the params are placed by ``param_specs`` and the
    caches by ``decode_state_specs``; the tokens are placed by
    ``batch_specs`` at each step and :meth:`generate` returns them whole.
    """

    def __init__(self, cfg: ArchConfig, *, mesh=None, device: str | torch.device = "cuda",
                 kv_len: int = 512, batch_size: int = 8, dtype=torch.float32,
                 params=None):
        self.cfg, self.mesh = cfg, mesh
        self.device = mesh_device(mesh) if mesh is not None else resolve_device(device)
        self.params = (init_model(cfg, 0, dtype=dtype, device=self.device)
                       if params is None else params.to(self.device))
        self.state = init_decode_state(cfg, batch_size, kv_len, dtype=dtype,
                                       device=self.device)
        self.batch_size = batch_size
        self._tok_sh = None
        if mesh is not None:
            distribute_params(self.params, named(mesh, param_specs(cfg, self.params, mesh)))
            sh = named(mesh, decode_state_specs(cfg, self.state, mesh, batch_size=batch_size))
            self.state = {k: distribute(v, replicate_unit_dims(sh[k]))
                          for k, v in self.state.items()}
            self._tok_sh = replicate_unit_dims(named(mesh, batch_specs(
                cfg, {"tokens": torch.empty((batch_size, 1))}, mesh,
                batch_size=batch_size))["tokens"])
        self._step = make_serve_step(cfg)

    def generate(self, prompt_tokens: np.ndarray, max_new: int = 16) -> np.ndarray:
        """Greedy continuation for a batch of single-token prompts:
        ``[B, 1 + max_new]`` int32, the prompt first."""
        toks = torch.as_tensor(np.asarray(prompt_tokens)[:, :1], dtype=torch.int32,
                               device=self.device)
        out = [toks]
        if self.mesh is not None:
            toks = distribute(toks, self._tok_sh)
        for t in range(max_new):
            toks, self.state = self._step(self.params, self.state, toks, t)
            if self.mesh is not None:
                out.append(toks.full_tensor())
                toks = toks.redistribute(self.mesh, self._tok_sh.placements)
            else:
                out.append(toks)
        return torch.cat(out, dim=1).cpu().numpy()


class PegasusServer:
    """Batched multi-request server over ONE compiled ExecutionPlan.

    Every request input carries a leading batch dim (axis 0 = flows).
    Serving counters change only after a call succeeds. ``devices`` builds
    the plan sharded over those devices (``build_plan(devices=)``: every
    batch split into equal row shards, one per device); ``device`` is then
    ``devices[0]``.
    """

    def __init__(self, model, *, backend: str = "onehot",
                 max_batch: int | None = None, fuse: bool = True,
                 device: str | torch.device | None = None, devices=None):
        t0 = time.perf_counter()
        self.plan = build_plan(model, backend=backend, fuse=fuse, device=device,
                               devices=devices)
        self.plan_build_ms = (time.perf_counter() - t0) * 1e3
        self.backend = backend
        self.max_batch = max(self.plan.buckets) if max_batch is None else max_batch
        self._stage = PinnedStage()
        self._back = PinnedStage()
        self.requests_served = 0
        self.batches_run = 0
        self.flows_served = 0

    def stats(self) -> dict:
        """Serving counters + the plan's build and dispatch stats, in the
        schema all three servers share: ``scheduler``, ``slo`` and
        ``health`` are empty here (one plan, no queue, no breakers)."""
        return {
            "backend": self.backend,
            "serving": {
                "requests_served": self.requests_served,
                "batches_run": self.batches_run,
                "flows_served": self.flows_served,
                "batches_dispatched": self.batches_run,
            },
            "engine": {
                "plan_build_ms": self.plan_build_ms,
                "num_banks": self.plan.num_banks,
                "table_bytes": self.plan.table_bytes(),
                **self.plan.compile_stats(),
            },
            "scheduler": {},
            "slo": {},
            "devices": {"count": 1 if self.plan.devices is None else len(self.plan.devices),
                        "per_device": []},
            "health": {"models": {}, "degraded_models": [],
                       "chaos": {"installed": False}},
        }

    def infer(self, *inputs, backend: str | None = None) -> torch.Tensor:
        """One already-batched call through the plan (one request)."""
        y = self.plan(*inputs, backend=backend)
        self.batches_run += 1
        self.requests_served += 1
        self.flows_served += int(np.shape(inputs[0])[0])
        return y

    def serve(self, requests, *, backend: str | None = None,
              jit: bool = True) -> list:
        """Serve a list of :class:`InferRequest` → list of
        :class:`InferResult` (request order; outputs as numpy arrays). A
        list of bare arrays / input tuples still works, returning the raw
        outputs, with a ``DeprecationWarning``. ``jit=False`` runs every
        chunk eagerly instead of replaying the plan's CUDA graphs."""
        reqs, typed = _as_requests(requests, named=False)
        if not reqs:
            return []
        if not typed:
            warnings.warn(
                "PegasusServer.serve(list of arrays) is deprecated; pass a "
                "list of InferRequest", DeprecationWarning, stacklevel=2)
        co, back = _serve_inline(self.plan, [r.inputs for r in reqs], self._stage, self._back,
                                 backend=backend, max_batch=self.max_batch, jit=jit)
        split = _split(back, co.sizes)
        self.batches_run += len(co.chunks)
        self.requests_served += len(co.sizes)
        self.flows_served += co.total
        if not typed:
            return split
        return [InferResult(r.model, o, n) for r, o, n in zip(reqs, split, co.sizes)]


class MultiModelServer:
    """Many heterogeneous models behind ONE server.

    Each model is compiled once and pinned under a name in a
    :class:`~repro_torch.engine.PlanRegistry` (per-model backend allowed).
    Requests address models by name; pending same-model requests are
    coalesced into bucket-aligned micro-batches, and models with pending
    work are scheduled by weighted fair queueing (deficit round-robin: each
    model's flow share follows its priority weight), so a burst on one
    model cannot starve the others and a high-priority model goes first.

    Two call styles:
      * ``infer(request)`` — immediate single-request dispatch.
      * ``submit(request)`` + ``drain()`` — enqueue across models, then
        serve everything; ``drain`` returns ``{name: [output per
        request]}`` in per-model submit order. ``serve(requests)`` wraps
        submit + drain for a mixed list, preserving order.

    Ingestion is thread-safe (the scheduler owns every queue behind one
    lock); plan dispatch stays on the draining thread, or with ``devices=``
    on the stream pool's workers. Counters are per model and committed
    only when a pulled slice fully serves; a failing slice is requeued at
    the front (bounded by ``max_requeues`` and each request's deadline),
    its exception lands in ``last_drain_errors``, and every other model
    drains normally. ``schedule_log`` records the model of every dispatched
    micro-batch.

    Plans are built on ``device`` (the GPU unless ``device="cpu"``).
    ``devices`` (see :func:`~repro_torch.engine.plan.resolve_devices`)
    adds a :class:`DeviceStreamPool`: each chunk then crosses to the
    least-loaded stream's worker as host arrays and runs there as a placed
    plan call on that worker's CUDA stream, its output returned as numpy.
    """

    def __init__(self, models: dict | None = None, *, backend: str = "onehot",
                 max_batch: int | None = None, registry=None, fuse: bool = True,
                 queue_depth: int | None = None, policy: str = "block",
                 quantum: int | None = None, devices=None,
                 device: str | torch.device = "cuda",
                 breaker_failures: int = 3, breaker_reset_s: float = 1.0,
                 max_requeues: int = 5, retry_backoff_s: float = 0.02):
        self.registry = PlanRegistry() if registry is None else registry
        self.device = resolve_device(device)
        # devices=None keeps inline dispatch on the draining thread; an
        # explicit devices=1 still gets a one-stream pool
        self.devices = resolve_devices(devices)
        self._pool = DeviceStreamPool(self.devices) if self.devices else None
        self.backend = backend
        self.fuse = fuse    # cross-bank fusion default for add_model plans
        self.max_batch = max(DEFAULT_BUCKETS) if max_batch is None else max_batch
        self.queue_depth = queue_depth   # default bound for new model queues
        self.policy = policy             # default backpressure policy
        # DRR credit per round per unit weight, in flows; None → max_batch
        # (a weight-1 model earns about one full micro-batch per round)
        self.quantum = quantum
        self._sched = WFQScheduler()
        # counter commits are read-modify-writes shared between the drain
        # thread and infer() callers
        self._ctr_lock = make_lock("serve._ctr_lock")
        self._counters: dict[str, dict] = {}        # guarded-by: _ctr_lock
        # bounded debugging/fairness surface; deque.append is atomic and
        # readers tolerate a stale tail, so it takes no lock
        self.schedule_log: deque = deque(maxlen=4096)
        self.batches_dispatched = 0                 # guarded-by: _ctr_lock
        # bytes _coalesce copied to the device from pageable host memory,
        # committed with the slice's other counters
        self.h2d_pageable_bytes = 0                 # guarded-by: _ctr_lock
        # bytes it copied through the pinned stage instead
        self.h2d_staged_bytes = 0                   # guarded-by: _ctr_lock
        # chunks whose data crossed the plan boundary once each way
        # (ExecutionPlan.call_into), counted with batches_dispatched
        self.chunks_direct = 0                      # guarded-by: _ctr_lock
        # rounds finished, and of them those finished after the next round
        # had been begun (the async loop's overlap; drain() overlaps none)
        self.rounds = 0                             # guarded-by: _ctr_lock
        self.rounds_overlapped = 0                  # guarded-by: _ctr_lock
        self._stage = PinnedStage()
        # pinned slots the outputs of each group in flight come back into
        self._back = PinnedStage()
        # bound by the async drain loop (never by the sync server): once
        # bound, all dispatch must happen on that thread
        self._dispatch_affinity = ThreadAffinity("dispatch")
        self.last_drain_errors: dict[str, Exception] = {}
        self.last_shed: dict[str, int] = {}
        # self-healing: per-model breakers guard the PREFERRED backend; after
        # breaker_failures consecutive slice failures the model serves on
        # the gather fallback until a cooldown probe succeeds — but only
        # when every failure of the streak was an injected fault
        self.breaker_failures = int(breaker_failures)
        self.breaker_reset_s = float(breaker_reset_s)
        self.max_requeues = int(max_requeues)
        self.retry_backoff_s = float(retry_backoff_s)
        self._breakers: dict[str, CircuitBreaker] = {}  # guarded-by: _ctr_lock
        self._health_ctrs: dict[str, dict] = {}         # guarded-by: _ctr_lock
        # retry pacing, touched only by the one dispatching thread
        self._retry_streak: dict[str, int] = {}
        self._retry_not_before: dict[str, float] = {}
        # the first failure of a model's current streak that was NOT an
        # injected fault: while one stands, an open breaker fails slices
        # instead of serving them on gather, which would hide a kernel,
        # launch or capture fault behind the plain path
        self._organic_fault: dict[str, Exception] = {}
        self._chaos = None      # FaultInjector, set by install_chaos()
        for name in self.registry.names():   # adopt a pre-populated registry
            self._track(name)
        for name, model in dict(models or {}).items():
            self.add_model(name, model)

    def _track(self, name: str, **sched_kw) -> None:
        """Queue + counters for a registry name this server serves. Server
        defaults for depth/policy apply only when the queue is created."""
        if name not in self._sched:
            sched_kw.setdefault("depth", self.queue_depth)
            sched_kw.setdefault("policy", self.policy)
        self._sched.add_queue(name, **sched_kw)
        with self._ctr_lock:
            self._counters.setdefault(name, {"requests_served": 0,
                                             "batches_run": 0,
                                             "flows_served": 0})
            if name not in self._breakers:
                self._breakers[name] = CircuitBreaker(
                    name, failure_threshold=self.breaker_failures,
                    reset_timeout_s=self.breaker_reset_s)
            self._health_ctrs.setdefault(name, {"fallback_batches": 0,
                                                "probe_batches": 0,
                                                "retries": 0,
                                                "poisoned": 0,
                                                "deadline_dropped": 0})

    def _breaker(self, name: str) -> CircuitBreaker | None:
        with self._ctr_lock:
            return self._breakers.get(name)

    def _tracked(self, name: str) -> None:
        with self._ctr_lock:
            known = name in self._counters
        if not known:
            if name not in self.registry:
                raise KeyError(
                    f"unknown model {name!r}; registered: {self.models()}")
            self._track(name)

    def _quantum(self) -> int:
        return max(1, int(self.max_batch if self.quantum is None else self.quantum))

    # -- model management ---------------------------------------------------

    def add_model(self, name: str, model, *, backend: str | None = None,
                  priority: str | None = None, weight: float | None = None,
                  queue_depth: int | None = None, policy: str | None = None,
                  **build_kw):
        """Compile + register one model under ``name``; returns its plan.

        ``backend`` overrides the server default for this plan;
        ``priority`` (a class of :data:`PRIORITY_WEIGHTS`) or an explicit
        ``weight`` sets its WFQ share; ``queue_depth``/``policy`` bound its
        queue (``"reject"`` raises :class:`QueueFullError` at submit,
        ``"block"`` parks the submitter); ``build_kw`` goes to
        ``build_plan`` (``fuse``, ``bucket_sizes``, ``device``, ``audit``
        ...).
        Re-registering a name rebuilds its plan and re-applies any explicit
        scheduling field."""
        build_kw.setdefault("fuse", self.fuse)
        build_kw.setdefault("device", self.device)
        plan = self.registry.register(name, model, backend=backend or self.backend,
                                      **build_kw)
        sched_kw: dict = {"priority": priority, "weight": weight}
        if queue_depth is not None:
            sched_kw["depth"] = queue_depth
        if policy is not None:
            sched_kw["policy"] = policy
        self._track(name, **sched_kw)
        return plan

    def set_priority(self, name: str, *, priority: str | None = None,
                     weight: float | None = None) -> float:
        """Re-class a served model's WFQ weight (effective next round)."""
        self._tracked(name)
        return self._sched.set_weight(name, weight=weight, priority=priority)

    def remove_model(self, name: str) -> bool:
        """Evict a model; its queued requests' futures fail with KeyError."""
        dropped = self._sched.remove_queue(name)
        err = KeyError(f"model {name!r} removed with requests pending")
        for r in dropped:
            _resolve_future(r.future, error=err)
        with self._ctr_lock:
            self._counters.pop(name, None)
            self._breakers.pop(name, None)
            self._health_ctrs.pop(name, None)
        return self.registry.evict(name)

    def models(self) -> list[str]:
        return self.registry.names()

    def install_chaos(self, injector) -> None:
        """Wire a :class:`~repro_torch.launch.chaos.FaultInjector` into every
        dispatch edge this server owns: its plan calls, the registry's plan
        builds and the stream pool's dispatches."""
        self._chaos = injector
        self.registry.chaos = injector
        if self._pool is not None:
            self._pool.chaos = injector

    def uninstall_chaos(self) -> None:
        """Detach the injector from every hook :meth:`install_chaos` set."""
        self._chaos = None
        self.registry.chaos = None
        if self._pool is not None:
            self._pool.chaos = None

    # -- request paths ------------------------------------------------------

    def infer(self, request, *legacy_inputs, backend: str | None = None):
        """Immediate single-request dispatch through the named plan on the
        calling thread (no queue, no coalescing, no deadline). Takes an
        :class:`InferRequest` and returns an :class:`InferResult` whose
        output is a tensor on the plan's device; the legacy
        ``infer(name, *inputs)`` shape returns the raw output. Plan errors
        propagate without touching the counters."""
        if isinstance(request, InferRequest):
            if legacy_inputs:
                raise TypeError(
                    "infer(InferRequest) takes no extra positional inputs "
                    "— they ride in request.inputs")
            name, inputs = request.model, request.inputs
        else:
            _warn_legacy("MultiModelServer.infer(name, *inputs)",
                         "pass an InferRequest")
            name, inputs = request, legacy_inputs
        self._tracked(name)
        y = self.registry.get(name)(*inputs, backend=backend)
        flows = int(np.shape(inputs[0])[0])
        with self._ctr_lock:
            c = self._counters[name]
            c["requests_served"] += 1    # success-only counting
            c["batches_run"] += 1
            c["flows_served"] += flows
        if isinstance(request, InferRequest):
            return InferResult(name, y, flows)
        return y

    def _enqueue(self, name: str, inputs: tuple, future: Future | None,
                 timeout: float | None, deadline_ms: float | None = None,
                 priority: str = "normal", typed: bool = False) -> int:
        """Queue one request; ``typed``: ``future`` takes its
        :class:`InferResult`, else its raw output."""
        self._tracked(name)
        # requests stay where they are (host arrays or tensors): the
        # dispatch moves them onto the device that runs the chunk
        inputs = tuple(x if isinstance(x, torch.Tensor) else np.asarray(x)
                       for x in inputs)
        return self._sched.submit(name, inputs, int(np.shape(inputs[0])[0]),
                                  future=future, timeout=timeout, deadline_ms=deadline_ms,
                                  priority=priority, typed=typed)

    def submit(self, request, *legacy_inputs, timeout: float | None = None,
               deadline_ms: float | None = None) -> int:
        """Enqueue one :class:`InferRequest` for the next :meth:`drain`;
        returns its queue position at insert time.

        ``timeout`` is the seconds to wait for space in a bounded
        ``policy="block"`` queue (``None`` waits forever). Raises
        ``KeyError`` (unknown model), :class:`QueueFullError` (full, or
        over the ``admit_ms`` horizon) and :class:`DeadlineExceededError`
        (admission control predicts a missed deadline). The legacy
        ``submit(name, *inputs, deadline_ms=...)`` shape still works."""
        if isinstance(request, InferRequest):
            if legacy_inputs or deadline_ms is not None:
                raise TypeError(
                    "submit(InferRequest) takes no extra inputs or "
                    "deadline_ms — they ride in the request")
            return self._enqueue(request.model, request.inputs, None, timeout,
                                 deadline_ms=request.deadline_ms,
                                 priority=request.priority)
        _warn_legacy("MultiModelServer.submit(name, *inputs)", "pass an InferRequest")
        return self._enqueue(request, legacy_inputs, None, timeout,
                             deadline_ms=deadline_ms)

    def pending(self) -> dict[str, int]:
        return self._sched.pending()

    def discard_pending(self, name: str) -> int:
        """Drop a model's queued requests (returns how many) — the escape
        hatch for a poisoned queue. Their futures are cancelled (or failed,
        if already running)."""
        dropped = self._sched.discard(name)
        err = RuntimeError(f"request discarded from {name!r}'s queue")
        for r in dropped:
            if r.future is not None and not r.future.done():
                if not r.future.cancel():
                    r.future.set_exception(err)
        return len(dropped)

    # -- dispatch -----------------------------------------------------------

    def _dispatched(self, name: str, direct: bool) -> None:
        """Count one chunk dispatched for ``name``."""
        self.schedule_log.append(name)
        with self._ctr_lock:
            self.batches_dispatched += 1
            self.chunks_direct += direct

    def _begin_group(self, name: str, reqs: list, backend: str | None) -> _Group:
        """Phase 1 of serving one pulled slice: coalesce → bucket_chunks
        micro-batches → plan calls → the outputs' copy back
        (:func:`_serve_inline`). Kernel launches, graph replays and the
        copies into a pinned slot are asynchronous, so this returns once
        every chunk is enqueued on the device: the caller begins every
        group of a round before finishing any, and the async loop the next
        round's before finishing this one. ``outs`` holds the handle
        :func:`_split` takes; with a stream pool each chunk is handed, as
        host arrays, to the least-loaded stream and ``outs`` holds the
        pool's futures of numpy outputs. A dispatch failure rides in
        ``error``."""
        # sanitizer checkpoint: once the async loop binds the dispatch
        # affinity, any other thread dispatching is a second dispatcher
        self._dispatch_affinity.assert_here()
        t0 = time.perf_counter()
        # queue-wait ends when the slice starts dispatching, not at pull
        for r in reqs:
            r.t_dispatch = t0
        rec = _spans.RECORDER
        if rec is not None:
            rec.add_all(_spans.SCHEDULER_QUEUE, [r.t_submit for r in reqs], t0)
        g = _Group(name, reqs, t0, managed=backend is None)
        try:
            br = self._breaker(name) if g.managed else None
            if br is not None and br.state != CLOSED:
                # the preferred path's breaker is tripped: a granted
                # cooldown probe retries it; else, after injected faults
                # only, the slice serves DEGRADED on the gather plan (same
                # model, same tables), and after a real one it fails fast
                # into the retry / poisoned-request / deadline triage
                if br.allow():
                    g.probe = True
                elif name in self._organic_fault:
                    raise RuntimeError(
                        f"model {name!r}: its breaker is open after a failure "
                        f"of its {self.registry.backend_of(name)!r} path; not "
                        f"serving it on {FALLBACK_BACKEND!r}"
                    ) from self._organic_fault[name]
                else:
                    g.degraded = True
            if self._chaos is not None:
                self._chaos.fire(
                    "plan_call", model=name,
                    backend=(FALLBACK_BACKEND if g.degraded else
                             backend or self.registry.backend_of(name)))
            if g.degraded:
                plan = self.registry.get_with_backend(name, FALLBACK_BACKEND)
            else:
                plan = self.registry.get(name)
            if g.degraded or g.probe:
                with self._ctr_lock:
                    h = self._health_ctrs.get(name)
                    if h is not None:
                        h["fallback_batches" if g.degraded else "probe_batches"] += 1
            inputs = [r.inputs for r in reqs]
            if self._pool is None:
                co, g.outs = _serve_inline(plan, inputs, self._stage, self._back,
                                           backend=backend, max_batch=self.max_batch,
                                           each=functools.partial(self._dispatched, name))
            else:
                t = 0.0 if rec is None else time.perf_counter()
                co = _coalesce(inputs, None, self._stage, plan.buckets, self.max_batch)
                if rec is not None:
                    rec.add(_spans.SERVER_COALESCE, t, time.perf_counter())
                g.outs, start = [], 0
                for size in co.chunks:
                    sl = tuple(c[start:start + size] for c in co.inputs)
                    # the chunk runs on the stream with the least pending
                    # work; assert_worker pins "all plan calls run on pool
                    # workers" under the sanitizer (a no-op otherwise)
                    g.outs.append(self._pool.submit(
                        lambda d, plan=plan, sl=sl: (
                            self._pool.assert_worker(),
                            plan(*sl, backend=backend, device=d).cpu().numpy())[1],
                        size))
                    self._dispatched(name, False)
                    start += size
        except Exception as e:
            g.error = e
            return g
        g.sizes, g.total, g.batches = co.sizes, co.total, len(co.chunks)
        g.pageable, g.staged, g.t_begun = co.pageable, co.staged, time.perf_counter()
        return g

    def _finish_group(self, g: _Group, behind: _Group | None = None):
        """Phase 2: wait for the group's outputs, split them per request,
        commit counters, record latency and resolve each future once (with
        the request's :class:`InferResult` where it is typed). On failure the
        model's breaker records it (preferred path only) and the slice goes
        through :meth:`_retry_or_fail`. Returns the per-request numpy
        outputs, or None on failure.

        ``behind`` is the model's group in the round already begun behind
        this one, if any. Should this group fail, that one is voided: its
        requests go back behind this slice's survivors, and its own finish
        drops its outputs and touches nothing else, so that one model's
        futures resolve in order and its breaker sees what it saw before."""
        name, reqs = g.name, g.reqs
        if g.void:
            if isinstance(g.outs, _CopyBack):
                g.outs.drop()
            return None
        err = g.error
        if err is None:
            t_finish = time.perf_counter()
            try:
                if self._pool is not None:
                    arrs = [f.result() for f in g.outs]
                    out = np.concatenate(arrs) if len(arrs) > 1 else arrs[0]
                    split = np.split(out, np.cumsum(g.sizes)[:-1])
                else:
                    split = _split(g.outs, g.sizes)      # waits on the copy alone
            except Exception as e:
                err = e
        # a degraded (fallback) slice neither extends nor resets the
        # preferred path's streak
        br = self._breaker(name) if g.managed and not g.degraded else None
        if err is not None:
            self.last_drain_errors[name] = err
            if behind is not None:
                behind.void = True
                self._sched.requeue_front(name, behind.reqs)
            if br is not None:
                br.record_failure()
                if not isinstance(err, InjectedFaultError):
                    self._organic_fault.setdefault(name, err)
            self._retry_or_fail(name, reqs, err, probe=g.probe)
            return None
        if br is not None:
            br.record_success()      # a probe's success reinstates
            self._organic_fault.pop(name, None)
        self._retry_streak.pop(name, None)
        self._retry_not_before.pop(name, None)
        # service = this group's own dispatch phase + its own finish, not
        # the wall time since begin (which would charge later groups for
        # earlier groups' host work)
        service_ms = ((g.t_begun - g.t0) + (time.perf_counter() - t_finish)) * 1e3
        self._sched.record_service(name, reqs, service_ms)
        with self._ctr_lock:
            c = self._counters.get(name)   # None once remove_model'd
            if c is not None:
                c["requests_served"] += len(reqs)
                c["batches_run"] += g.batches
                c["flows_served"] += g.total
            self.h2d_pageable_bytes += g.pageable
            self.h2d_staged_bytes += g.staged
        rec = _spans.RECORDER
        t = 0.0 if rec is None else time.perf_counter()
        for r, o in zip(reqs, split):
            if r.typed:
                o = InferResult(name, o, r.size, queue_wait_ms=(r.t_dispatch - r.t_submit) * 1e3)
            _resolve_future(r.future, result=o)
        if rec is not None:
            rec.add(_spans.SERVER_RESOLVE, t, time.perf_counter())
        return split

    def _retry_or_fail(self, name: str, reqs: list, err: Exception, *,
                       probe: bool = False) -> None:
        """Failure triage for one slice. Per request: a deadline already
        burned through fails now with the dispatch error; a request at
        ``max_requeues`` fails typed :class:`PoisonedRequestError`;
        everything else is requeued at the front with its count bumped (a
        failed breaker probe charges no count). Consecutive failed slices
        back off exponentially (``retry_backoff_s`` doubling, capped at
        1 s) on the async loop."""
        now = time.perf_counter()
        survivors: list = []
        n_deadline = n_poison = 0
        for r in reqs:
            if (r.deadline_ms is not None
                    and (now - r.t_submit) * 1e3 >= r.deadline_ms):
                _resolve_future(r.future, error=err)
                n_deadline += 1
            elif not probe and r.requeues >= self.max_requeues:
                perr = PoisonedRequestError(
                    f"request for {name!r} failed {r.requeues + 1} times "
                    f"(max_requeues={self.max_requeues}); giving up — "
                    "discard or fix the request")
                perr.__cause__ = err
                _resolve_future(r.future, error=perr)
                n_poison += 1
            else:
                if not probe:
                    r.requeues += 1
                survivors.append(r)
        if survivors:
            self._sched.requeue_front(name, survivors)
            streak = self._retry_streak.get(name, 0)
            self._retry_not_before[name] = now + min(
                self.retry_backoff_s * (2 ** streak), 1.0)
            self._retry_streak[name] = streak + 1
        with self._ctr_lock:
            h = self._health_ctrs.get(name)
            if h is not None:
                h["retries"] += len(survivors)
                h["poisoned"] += n_poison
                h["deadline_dropped"] += n_deadline

    def drain(self, *, backend: str | None = None) -> dict:
        """Serve every queued request in WFQ rounds; returns ``{name:
        [np.ndarray per request, in submit order]}``.

        Failures are isolated per model: a failing slice is requeued at the
        front with its counters untouched, the model is skipped for the
        rest of this drain, and every other model drains normally; the
        errors land in ``last_drain_errors`` and drain raises only if NO
        model served. Deadline-bearing requests whose slack ran out while
        queued are shed (their futures fail with
        :class:`DeadlineExceededError`); ``last_shed`` counts them."""
        self.last_drain_errors = {}
        results: dict = {}
        failed: set = set()
        quantum = self._quantum()
        while True:
            groups = self._sched.pull_round(quantum, exclude=failed)
            if not groups:
                break
            # dispatch EVERY group, then wait on each: the device works
            # across models while the host splits and converts
            begun = [self._begin_group(name, reqs, backend) for name, reqs in groups]
            for g in begun:
                outs = self._finish_group(g)
                if outs is None:
                    failed.add(g.name)
                else:
                    results.setdefault(g.name, []).extend(outs)
            with self._ctr_lock:
                self.rounds += 1
        self.last_shed = {name: len(reqs)
                          for name, reqs in self._sched.take_shed().items()}
        if self.last_drain_errors and not results:
            raise next(iter(self.last_drain_errors.values()))
        return results

    def serve(self, requests, *, backend: str | None = None) -> list:
        """Submit a mixed list of :class:`InferRequest`, drain, and return
        one :class:`InferResult` per request, in request order — only when
        every request served; else raises :class:`PartialDrainError` with
        the served outputs in ``.partial_results``. The legacy ``(name,
        inputs[, deadline_ms])`` tuples still work, returning raw outputs.
        ``backend`` overrides every plan's backend for this drain."""
        reqs, typed = _as_requests(requests, named=True)
        if not typed:
            _warn_legacy("MultiModelServer.serve(list of (name, inputs) tuples)",
                         "pass a list of InferRequest")
        order: list[tuple[InferRequest, Future]] = []
        for req in reqs:
            # a private future per request keeps served/shed alignment
            fut: Future = Future()
            try:
                self._enqueue(req.model, req.inputs, fut, None, deadline_ms=req.deadline_ms,
                              priority=req.priority, typed=typed)
            except DeadlineExceededError as e:
                _resolve_future(fut, error=e)   # admission refusal == shed
            order.append((req, fut))
        by_model = self.drain(backend=backend)
        # a model in last_drain_errors did NOT fully serve, even if an
        # earlier slice of it landed in by_model
        failed = {name: self.last_drain_errors[name]
                  for name in dict.fromkeys(r.model for r, _ in order)
                  if name in self.last_drain_errors}
        shed: dict[str, list] = {}
        for req, fut in order:
            if fut.done():
                exc = fut.exception()
                if isinstance(exc, DeadlineExceededError):
                    shed.setdefault(req.model, []).append(exc)
        if failed or shed:
            cause = (next(iter(failed.values())) if failed
                     else next(iter(shed.values()))[0])
            raise PartialDrainError(failed, by_model, shed=shed) from cause
        return [fut.result() for _, fut in order]

    def close(self) -> None:
        """Release the stream pool's workers (a no-op without one); queued
        device work finishes first."""
        if self._pool is not None:
            self._pool.close()

    def stats(self) -> dict:
        """The serving-stats schema shared with ``PegasusServer``:
        ``serving`` (per-model and aggregate counters), ``engine`` (registry
        cache, per-model plan stats), ``scheduler`` (queue config, latency
        percentiles), ``slo`` (admission/shed/goodput counters),
        ``devices`` (the stream pool) and ``health`` (breakers, fallback
        and retry counters, degraded models, the chaos injector)."""
        reg = self.registry.stats()
        zeros = {"requests_served": 0, "batches_run": 0, "flows_served": 0}
        # registry names and plans BEFORE the counter lock: registry._lock
        # ranks outside serve._ctr_lock
        names = self.models()
        plans = self.registry.plans()
        graph_kernels = sum(plan.graph_kernels for plan in plans)
        bank_rows = sum(plan.bank_rows for plan in plans)
        with self._ctr_lock:
            per_model = {name: {**zeros, **self._counters.get(name, {})}
                         for name in names}
            batches_dispatched = self.batches_dispatched
            h2d_pageable_bytes = self.h2d_pageable_bytes
            h2d_staged_bytes = self.h2d_staged_bytes
            chunks_direct = self.chunks_direct
            rounds, rounds_overlapped = self.rounds, self.rounds_overlapped
            breakers = dict(self._breakers)
            hctrs = {n: dict(c) for n, c in self._health_ctrs.items()}
        health_models: dict = {}
        degraded_models: list = []
        for n in names:
            br = breakers.get(n)
            if br is None:
                continue
            bst = br.stats()
            is_degraded = bst["state"] != CLOSED
            if is_degraded:
                degraded_models.append(n)
            health_models[n] = {
                **bst, **hctrs.get(n, {}),
                "degraded": is_degraded,
                "preferred_backend": reg.get(n, {}).get("backend"),
                "fallback_backend": FALLBACK_BACKEND,
            }
        return {
            "backend": self.backend,
            "serving": {
                "requests_served": sum(m["requests_served"] for m in per_model.values()),
                "batches_run": sum(m["batches_run"] for m in per_model.values()),
                "flows_served": sum(m["flows_served"] for m in per_model.values()),
                "batches_dispatched": batches_dispatched,
                "h2d_pageable_bytes": h2d_pageable_bytes,
                "h2d_staged_bytes": h2d_staged_bytes,
                "chunks_direct": chunks_direct,
                "graph_kernels": graph_kernels,
                "bank_rows": bank_rows,
                "rounds": rounds,
                "rounds_overlapped": rounds_overlapped,
                "models": per_model,
            },
            "engine": {"cache": self.registry.cache_info(), "models": reg},
            "scheduler": {"models": self._sched.describe(),
                          "latency": self._sched.latency_stats()},
            "slo": {"models": self._sched.counters()},
            "devices": (self._pool.stats() if self._pool is not None
                        else {"count": 1, "per_device": []}),
            "health": {
                "models": health_models,
                "degraded_models": sorted(degraded_models),
                "chaos": (self._chaos.stats() if self._chaos is not None
                          else {"installed": False}),
            },
        }

    def slo_counters(self) -> dict:
        """The scheduler's per-model SLO counters alone."""
        return self._sched.counters()

    def reset_slo_counters(self) -> None:
        self._sched.reset_counters()

    def reset_latency_stats(self) -> None:
        self._sched.reset_latency()


class AsyncMultiModelServer(MultiModelServer):
    """The always-on :class:`MultiModelServer`: a background drain thread
    plus future-returning ``submit()``.

    ``submit(request)`` is safe from any thread and returns a
    :class:`concurrent.futures.Future` of the request's
    :class:`InferResult` (or its dispatch error: async requests are not
    requeued past their retries — the future carries the exception).
    Queues are bounded (``queue_depth``, default 1024 requests per model)
    with ``policy`` backpressure: ``"block"`` parks the submitter until the
    loop frees space, ``"reject"`` raises :class:`QueueFullError` at once.
    The loop pulls one WFQ round at a time, begins it before finishing the
    round before it (one round in flight at most beyond the one being
    finished; ``stats()["serving"]`` counts ``rounds`` and
    ``rounds_overlapped``), and funnels every plan call through its thread
    (or, with ``devices=``, the stream pool's workers).
    Use it as a context manager, or ``start()``/``stop()``::

        with AsyncMultiModelServer({"ids": banks}, backend="kernel") as srv:
            futs = [srv.submit(InferRequest("ids", x)) for x in bursts]
            outs = [f.result().output for f in futs]

    ``stop(drain=True)`` (what ``__exit__`` calls) waits for the queues to
    empty, then joins the loop: pending futures all resolve first.
    """

    def __init__(self, models: dict | None = None, *,
                 queue_depth: int | None = 1024, policy: str = "block",
                 idle_wait: float = 0.05, **kw):
        super().__init__(models, queue_depth=queue_depth, policy=policy, **kw)
        self._idle_wait = idle_wait
        self._stop_flag = threading.Event()
        self._thread: threading.Thread | None = None
        self.loop_errors: deque = deque(maxlen=64)   # unexpected loop crashes

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "AsyncMultiModelServer":
        """Spawn the background drain loop (idempotent); returns ``self``."""
        if self._thread is None or not self._thread.is_alive():
            self._stop_flag.clear()
            self._thread = threading.Thread(
                target=self._serve_loop, name="pegasus-drain", daemon=True)
            self._thread.start()
        return self

    def stop(self, *, drain: bool = True, timeout: float | None = None) -> None:
        """Stop the loop. ``drain=True`` first waits for every queue to
        empty, so in-flight futures all resolve; ``drain=False`` halts once
        the round in flight is finished and fails every still-pending
        future with
        :class:`ServerStoppedError`. ``timeout`` bounds drain-wait + join in
        seconds; on expiry the loop may still be alive (``running`` stays
        true) and a later ``stop()`` can finish the job."""
        if self._thread is None:
            if not drain:
                self._fail_pending_stopped()
            return
        deadline = None if timeout is None else time.monotonic() + timeout
        if drain:
            while self.pending() and self._thread.is_alive():
                if deadline is not None and time.monotonic() > deadline:
                    break
                time.sleep(0.002)
        self._stop_flag.set()
        self._sched.kick()
        self._thread.join(None if deadline is None
                          else max(0.0, deadline - time.monotonic()))
        # forget the thread only once it exited: else start() could spawn
        # a second concurrent dispatcher
        if not self._thread.is_alive():
            self._thread = None
            if drain and self.pending():
                # a submit raced the stop flag: serve the stragglers inline,
                # and fail any future a failing slice would strand
                try:
                    self.drain()
                except Exception:
                    pass                        # recorded per model below
                for name in list(self.pending()):
                    err = self.last_drain_errors.get(name) or RuntimeError(
                        f"server stopped with {name!r} requests pending")
                    for r in self._sched.discard(name):
                        _resolve_future(r.future, error=err)
            elif not drain:
                self._fail_pending_stopped()

    def _fail_pending_stopped(self) -> None:
        for name in list(self.pending()):
            err = ServerStoppedError(
                f"server stopped (drain=False) with {name!r} requests "
                "pending — the request was not served; resubmit after "
                "start() if still wanted")
            for r in self._sched.discard(name):
                _resolve_future(r.future, error=err)

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def __enter__(self) -> "AsyncMultiModelServer":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()

    # -- ingestion ----------------------------------------------------------

    def submit(self, request, *legacy_inputs, timeout: float | None = None,
               deadline_ms: float | None = None) -> Future:
        """Thread-safe enqueue of one :class:`InferRequest`; returns a
        future of its :class:`InferResult`. As
        :meth:`MultiModelServer.submit`, except that a shed or
        admission-refused request FAILS THE FUTURE with
        :class:`DeadlineExceededError` instead of raising here. The legacy
        ``submit(name, *inputs)`` shape returns a future of the raw
        output."""
        fut: Future = Future()
        if isinstance(request, InferRequest):
            if legacy_inputs or deadline_ms is not None:
                raise TypeError(
                    "submit(InferRequest) takes no extra inputs or "
                    "deadline_ms — they ride in the request")
            try:
                self._enqueue(request.model, request.inputs, fut, timeout,
                              deadline_ms=request.deadline_ms,
                              priority=request.priority, typed=True)
            except DeadlineExceededError as e:
                _resolve_future(fut, error=e)
            return fut
        _warn_legacy("AsyncMultiModelServer.submit(name, *inputs)",
                     "pass an InferRequest")
        try:
            self._enqueue(request, legacy_inputs, fut, timeout,
                          deadline_ms=deadline_ms)
        except DeadlineExceededError as e:
            _resolve_future(fut, error=e)
        return fut

    async def infer_async(self, request, *legacy_inputs,
                          timeout: float | None = None,
                          deadline_ms: float | None = None):
        """``await`` the :class:`InferResult` of one request from a running
        event loop without blocking it: the enqueue (which ``"block"``
        backpressure may park) runs in a worker thread, then the future is
        awaited. Raises ``RuntimeError`` if the drain loop is not
        running."""
        if not self.running:
            raise RuntimeError(
                "the background drain loop is not running — start() the "
                "server (or use it as a context manager) before "
                "infer_async(), otherwise the await would never resolve")
        fut = await asyncio.to_thread(self.submit, request, *legacy_inputs,
                                      timeout=timeout, deadline_ms=deadline_ms)
        return await asyncio.wrap_future(fut)

    def serve(self, requests, *, backend: str | None = None) -> list:
        """Submit everything and wait for the results in order; each future
        fails on its own, and this raises the first failed request's error
        once all are settled."""
        if backend is not None:
            raise ValueError(
                "AsyncMultiModelServer.serve dispatches via the background "
                "loop; per-call backend overrides are a sync-drain feature "
                "(register the model with the backend you want instead)")
        if not self.running:
            raise RuntimeError(
                "the background drain loop is not running — start() the "
                "server (or use it as a context manager) before serve(), "
                "otherwise the submitted futures would never resolve")
        reqs, typed = _as_requests(requests, named=True)
        if not typed:
            _warn_legacy("AsyncMultiModelServer.serve(list of (name, inputs) "
                         "tuples)", "pass a list of InferRequest")
        futs = [self.submit(req) for req in reqs]
        concurrent.futures.wait(futs)   # settle everything before raising
        if not typed:
            return [f.result().output for f in futs]
        return [f.result() for f in futs]

    # -- the background loop ------------------------------------------------

    def _serve_loop(self) -> None:
        # claim the dispatch edge for this thread (released on exit so a
        # stop()'s inline straggler drain stays legal)
        self._dispatch_affinity.bind()
        try:
            self._serve_loop_body()
        finally:
            self._dispatch_affinity.release()

    def _serve_loop_body(self) -> None:
        """Rounds two deep: each iteration pulls round N + 1 (without
        waiting while round N is in flight), begins its groups, whose work
        the device queues behind round N's, then finishes round N. A round
        whose outputs have already landed has nothing left to hide and is
        finished before the pull, so that the requests its futures'
        callbacks send can join round N + 1. With nothing to pull the loop
        finishes round N at once, and it parks only when no round is in
        flight. A round with a failed begin, a breaker probe or a degraded
        group is finished before the next pull, as without the overlap."""
        ahead: list = []            # the round begun and not yet finished
        try:
            while not self._stop_flag.is_set():
                try:
                    now = time.perf_counter()
                    landed = bool(ahead) and all(_landed(g) for g in ahead)
                    if landed:
                        done, ahead = ahead, []
                        self._finish_round(done)
                    # models inside their retry backoff wait out the pause
                    t_pull = time.perf_counter()
                    backoff = frozenset(
                        n for n, t in self._retry_not_before.items() if t > t_pull)
                    groups = self._sched.pull_round(self._quantum(), exclude=backoff)
                    rec = _spans.RECORDER
                    t_pulled = 0.0 if rec is None else time.perf_counter()
                    if not groups and not ahead and not landed:
                        if backoff:
                            time.sleep(0.002)
                        else:
                            self._sched.wait_for_work(self._idle_wait)
                        if rec is not None:
                            rec.add(_spans.SERVER_WAIT, t_pulled, time.perf_counter())
                        continue
                    if rec is not None:
                        rec.add(_spans.SCHEDULER_PULL, t_pull, t_pulled)
                    done, ahead = ahead, [self._begin_group(name, reqs, None)
                                          for name, reqs in groups]
                    if done:
                        self._finish_round(done, after=ahead)
                    # a model whose breaker is not closed gets no group
                    # begun behind one of its own: a probe voided behind a
                    # failed finish would hold its slot for good
                    if any(g.error is not None or g.probe or g.degraded for g in ahead):
                        done, ahead = ahead, []
                        self._finish_round(done)
                    if rec is not None:
                        rec.add(_spans.SERVER_ROUND, now, time.perf_counter())
                except Exception as e:           # pragma: no cover - safety
                    self.loop_errors.append(e)
                    time.sleep(self._idle_wait)
        finally:
            # stopping: the round in flight is finished, never stranded
            if ahead:
                rec = _spans.RECORDER
                t = 0.0 if rec is None else time.perf_counter()
                self._finish_round(ahead)
                if rec is not None:
                    rec.add(_spans.SERVER_ROUND, t, time.perf_counter())

    def _finish_round(self, groups: list, after: list = ()) -> None:
        """Finish a begun round's groups in order and count the round;
        ``after`` is the round already begun behind it (see
        :meth:`_finish_group`'s ``behind``)."""
        for g in groups:
            try:
                self._finish_group(
                    g, behind=next((h for h in after if h.name == g.name), None))
            except Exception as e:
                # _finish_group routes dispatch errors onto futures;
                # anything escaping it would strand this group's
                self.loop_errors.append(e)
                for r in g.reqs:
                    _resolve_future(r.future, error=e)
        with self._ctr_lock:
            self.rounds += 1
            self.rounds_overlapped += bool(after)


def _pegasus_demo(args) -> None:
    """--pegasus: train MLP-B on synthetic traffic, compile one plan and
    serve request batches on the chosen backend."""
    from repro_torch.data.synthetic_traffic import make_dataset
    from repro_torch.nets.mlp import pegasusify_mlp, train_mlp

    device = resolve_device(args.device)
    ds = make_dataset("peerrush", flows_per_class=120)
    mlp = train_mlp(ds.train["stats"], ds.train["label"], ds.num_classes,
                    steps=120, device=device)
    banks = pegasusify_mlp(mlp, ds.train["stats"].astype(np.float32), refine_steps=0)
    server = PegasusServer(banks, backend=args.backend, fuse=not args.no_fuse,
                           device=device)
    st0 = server.plan.compile_stats()
    print(f"plan compiled in {server.plan_build_ms:.1f} ms "
          f"({server.plan.num_banks} banks, {st0['fused_groups']} fused "
          f"groups covering {st0['fused_banks']} banks, backend={args.backend}, "
          f"device={device})")
    x = ds.test["stats"].astype(np.float32)
    requests = [InferRequest("mlp", x[i : i + args.batch])
                for i in range(0, min(len(x), 8 * args.batch), args.batch)]
    server.serve(requests)  # warm-up: first use of each bucket
    t0 = time.perf_counter()
    results = server.serve(requests)
    dt = time.perf_counter() - t0
    flows = sum(r.flows for r in results)
    print(f"served {len(requests)} requests ({flows} flows) in {dt * 1e3:.1f} ms "
          f"→ {flows / dt:.0f} flows/s on backend={args.backend}")
    st = server.stats()["engine"]
    print(f"dispatch: {st['traces']} first uses, {st['bucket_hits']} bucket "
          f"hits over {st['jit_calls']} calls; buckets={st['buckets']}")


def _lm_demo(args) -> None:
    """--arch: greedy decode with :class:`Server` from single-token prompts."""
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    server = Server(cfg, mesh=world_mesh(args.device), device=args.device,
                    batch_size=args.batch)
    prompts = np.ones((args.batch, 1), np.int32)
    t0 = time.perf_counter()
    out = server.generate(prompts, max_new=args.max_new)
    dt = time.perf_counter() - t0
    print(f"generated {out.shape} in {dt:.2f}s "
          f"({args.batch * args.max_new / dt:.1f} tok/s, device={server.device})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="serve this LM config with Server")
    ap.add_argument("--smoke", action="store_true", help="the arch's tiny smoke config")
    ap.add_argument("--max-new", type=int, default=16, help="tokens to generate")
    ap.add_argument("--pegasus", action="store_true",
                    help="serve a pegasusified MLP-B via the execution engine")
    ap.add_argument("--backend", default="onehot",
                    choices=["gather", "onehot", "kernel", "kernel_q8"],
                    help="engine backend bound to the serving plan")
    ap.add_argument("--no-fuse", action="store_true",
                    help="disable cross-bank primitive fusion")
    ap.add_argument("--batch", type=int, default=4,
                    help="flows per request (--pegasus) or sequences (--arch)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.pegasus:
        _pegasus_demo(args)
        return
    if args.arch is None:
        ap.error("--arch is required unless --pegasus is given")
    _lm_demo(args)


if __name__ == "__main__":
    main()
