"""DeviceStreamPool: N per-device executor streams behind one submit()
(port of the JAX package's ``launch/devices.py``).

The multi-device serving fan-out: ONE WFQ pull loop drains the scheduler
and hands each bucket-aligned chunk to this pool, which places it on the
**least-loaded stream** — the one with the fewest *pending flows* (queued
+ in-flight), ties broken by lowest stream index so placement is
deterministic and testable. Each entry of ``devices`` owns a daemon worker
thread, a FIFO deque and, on a CUDA device, its own ``torch.cuda.Stream``
(a device may repeat: each entry is a stream of its own). A chunk
dispatched to stream *i* runs ``fn(device_i)`` on that worker inside
``torch.cuda.stream(stream_i)``: the placed plan call inside copies the
chunk's host arrays onto the device, replays its graph and copies the
result back on that stream, so no device tensor crosses streams. On the
CPU a worker has no stream and runs ``fn`` inline on its thread. Futures
are the hand-off: ``submit`` returns a ``concurrent.futures.Future`` that
the worker resolves with the result or the exception.

Why flows and not chunk count: chunks are bucket-padded and ragged
(17-flow and 512-flow chunks cost very differently), so queue depth in
chunks is a poor load signal; pending flow count tracks actual work.

**Supervision.** A dispatch error lands on the chunk's future —
but an error OUTSIDE that per-dispatch ``except`` (an injected crash via
the ``chaos`` hook, a bookkeeping bug) kills the worker thread, which
used to strand its FIFO silently. Now:

  * a dying worker marks its stream **dead**, migrates its queued chunks
    (and the un-started in-hand chunk) to surviving streams, and a
    respawn is scheduled with doubling backoff — transient crashes heal;
  * every stream carries a :class:`~repro_torch.launch.health.CircuitBreaker`:
    consecutive dispatch failures trip it OPEN, ``_place`` routes around
    it and migrates nothing (the worker is alive, just quarantined —
    :meth:`_quarantine` moves its backlog), and a cooldown probe chunk
    auto-reinstates it;
  * workers found dead without supervision having seen the death are
    detected lazily in ``_place`` and at ``stats()`` time (surfaced as
    ``dead_streams``) and reaped the same way — the detection stands
    alone even if respawn never succeeds;
  * with ZERO healthy streams the pool degrades to **inline dispatch** on
    the submitting thread instead of queueing onto dead FIFOs (or
    deadlocking a caller that blocks on the future). Chunks that cannot
    migrate anywhere fail their futures with the crash error — the
    serving layer's bounded retry owns resubmission.

This is deliberately engine-agnostic — ``fn`` is any callable taking a
device. The serving layer passes ``lambda d: plan(*chunk, backend=be,
device=d)`` turned into numpy; tests pass stubs.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError

import torch

from repro_torch.analysis.sanitizer import (ThreadAffinity, ThreadAffinityError,
                                            make_lock)

from .health import CLOSED, OPEN, CircuitBreaker

__all__ = ["DeviceStreamPool"]


class _Stream:
    """One executor: worker thread + FIFO + load counters, and on a CUDA
    device the stream its work is enqueued on."""

    __slots__ = ("device", "index", "stream", "q", "pending_flows",
                 "dispatched_chunks", "dispatched_flows", "busy_s", "errors",
                 "dead", "crashes", "respawns", "thread", "breaker")

    def __init__(self, device, index: int, breaker: CircuitBreaker):
        self.device = device         # immutable after construction
        self.index = index           # immutable after construction
        # immutable: a respawned worker enqueues on the same stream
        self.stream = (torch.cuda.Stream(device=device)
                       if device.type == "cuda" else None)
        self.breaker = breaker       # immutable ref (its own lock inside)
        self.q: deque = deque()      # guarded-by: _lock
        # queued + in-flight flows (the load signal)
        self.pending_flows = 0       # guarded-by: _lock
        self.dispatched_chunks = 0   # guarded-by: _lock
        self.dispatched_flows = 0    # guarded-by: _lock
        self.busy_s = 0.0            # guarded-by: _lock
        self.errors = 0              # guarded-by: _lock
        self.dead = False            # guarded-by: _lock
        self.crashes = 0             # guarded-by: _lock
        self.respawns = 0            # guarded-by: _lock
        self.thread: threading.Thread | None = None   # guarded-by: _lock


class DeviceStreamPool:
    """Per-device worker threads with least-loaded-by-flows placement and
    crash supervision (module docstring)."""

    def __init__(self, devices, *, chaos=None, breaker_failures: int = 3,
                 breaker_reset_s: float = 0.25,
                 respawn_backoff_s: float = 0.05,
                 max_respawn_backoff_s: float = 2.0):
        devices = tuple(torch.device(d) for d in devices)
        if not devices:
            raise ValueError("DeviceStreamPool needs at least one device")
        # chaos hook (see repro_torch.launch.chaos): assigned before traffic,
        # read as a plain attribute on the worker hot path — None means
        # the hook costs one attribute load + is-None check per chunk
        self.chaos = chaos
        self.respawn_backoff_s = float(respawn_backoff_s)      # immutable
        self.max_respawn_backoff_s = float(max_respawn_backoff_s)  # immutable
        self._streams = tuple(
            _Stream(d, i, CircuitBreaker(
                f"stream-{i}", failure_threshold=breaker_failures,
                reset_timeout_s=breaker_reset_s))
            for i, d in enumerate(devices))
        self._lock = make_lock("devices._lock")
        self._work = threading.Condition(self._lock)
        self._closed = False         # guarded-by: _lock
        self._inline_dispatches = 0  # guarded-by: _lock
        self._migrated_chunks = 0    # guarded-by: _lock
        self._t0 = time.perf_counter()
        # marks the zero-healthy inline-dispatch path on ITS OWN thread so
        # assert_worker stays honest for every other thread
        self._inline_tls = threading.local()
        # sanitizer surface: each worker binds its affinity at thread start,
        # so "plan dispatch happens on a pool worker" is assertable
        # (assert_worker); all binds are no-ops unless PEGASUS_SANITIZE=1
        self._affinities = {i: ThreadAffinity(f"device-stream-{i}")
                            for i in range(len(self._streams))}
        with self._lock:
            for s in self._streams:
                self._spawn(s)

    @property
    def devices(self) -> tuple:
        return tuple(s.device for s in self._streams)

    def __len__(self) -> int:
        return len(self._streams)

    # holds: _lock
    def _spawn(self, s: _Stream) -> None:
        """Start a worker for ``s``. Under the lock, so no reader sees the
        new thread before it is alive and reaps the stream as dead."""
        s.thread = threading.Thread(target=self._run, args=(s,),
                                    name=f"device-stream-{s.index}", daemon=True)
        s.thread.start()

    # -- placement -----------------------------------------------------------

    # holds: _lock
    def _place(self, flows: int, orphans: list) -> _Stream | None:
        """Pick the stream for a new chunk: least pending flows among live
        breaker-CLOSED streams. A quarantined (breaker-OPEN) stream whose
        cooldown elapsed takes the chunk as its reinstatement probe —
        recovery needs traffic. Workers found dead are reaped here (the
        standalone detection fix: their FIFOs migrate or fail instead of
        stranding); ``(future, error)`` pairs the CALLER must resolve
        outside the lock are appended to ``orphans``. Returns ``None``
        when no stream can take work — the caller degrades to inline
        dispatch."""
        live = []
        for s in self._streams:
            if not s.dead and (s.thread is None or not s.thread.is_alive()):
                exc = RuntimeError(
                    f"device-stream-{s.index} worker found dead (killed "
                    "outside the dispatch handler); chunk could not be "
                    "migrated")
                orphans.extend((f, exc) for f in self._mark_dead(s, None))
            if not s.dead:
                live.append(s)
        if not live:
            return None
        for s in live:
            if s.breaker.state != CLOSED and s.breaker.allow():
                return s               # cooldown elapsed: probe chunk
        ready = [s for s in live if s.breaker.state == CLOSED]
        if not ready:
            return None
        # min pending flows, tie → lowest index (tuple order is stable, and
        # min() keeps the first minimum, so index order IS the tiebreak)
        return min(ready, key=lambda s: s.pending_flows)

    def assert_worker(self) -> None:
        """Sanitizer checkpoint: raise :class:`ThreadAffinityError` unless
        the calling thread is one of this pool's workers (no-op with the
        sanitizer off — the affinities never bind) OR the pool is running
        this chunk inline on the caller's thread (zero-healthy degraded
        mode). The serving layer calls this from its dispatch closures,
        pinning the "ALL plan calls run on device workers" invariant at
        runtime."""
        if getattr(self._inline_tls, "active", False):
            return
        idents = {a.bound_ident for a in self._affinities.values()}
        idents.discard(None)
        if idents and threading.get_ident() not in idents:
            raise ThreadAffinityError(
                f"thread {threading.current_thread().name} is not a "
                "DeviceStreamPool worker")

    def submit(self, fn, flows: int) -> Future:
        """Place ``fn(device)`` on the least-loaded healthy stream; returns
        a Future.

        ``flows`` is the work size used for the load signal — pass the
        chunk's flow count (NOT the padded bucket size: the caller knows
        the real rows, and padding is uniform per bucket anyway).

        With zero healthy streams (every worker dead or quarantined) the
        chunk runs INLINE on this thread — degraded but never deadlocked —
        and ``stats()["inline_dispatches"]`` counts it.
        """
        fut: Future = Future()
        flows = int(flows)
        orphans: list = []
        inline_device = None
        with self._work:
            if self._closed:
                raise RuntimeError("DeviceStreamPool is closed")
            s = self._place(flows, orphans)
            if s is not None:
                s.pending_flows += flows
                s.q.append((fn, flows, fut))
                self._work.notify_all()
            else:
                self._inline_dispatches += 1
                inline_device = self._streams[0].device
        for ofut, oexc in orphans:
            _fail(ofut, oexc)
        if s is None:
            self._inline_tls.active = True
            try:
                if fut.set_running_or_notify_cancel():
                    try:
                        out = fn(inline_device)
                    except BaseException as exc:  # noqa: BLE001
                        fut.set_exception(exc)
                    else:
                        fut.set_result(out)
            finally:
                self._inline_tls.active = False
        return fut

    # -- worker --------------------------------------------------------------

    def _run(self, s: _Stream) -> None:
        self._affinities[s.index].bind()
        item = None
        try:
            while True:
                with self._work:
                    while not s.q and not self._closed:
                        self._work.wait()
                    if not s.q and self._closed:
                        return
                    item = s.q.popleft()
                fn, flows, fut = item
                # chaos hook OUTSIDE the per-dispatch except, deliberately:
                # an injected raise kills this worker exactly like any
                # unexpected error would, exercising the supervision path
                chaos = self.chaos
                if chaos is not None:
                    chaos.fire("stream_dispatch", stream=s.index)
                if not fut.set_running_or_notify_cancel():
                    with self._lock:
                        s.pending_flows -= flows
                    item = None
                    continue
                t0 = time.perf_counter()
                try:
                    out = _on_stream(s, fn)
                except BaseException as exc:  # noqa: BLE001 — future carries it
                    with self._lock:
                        s.pending_flows -= flows
                        s.errors += 1
                        s.busy_s += time.perf_counter() - t0
                    fut.set_exception(exc)
                    if s.breaker.record_failure() == OPEN:
                        self._quarantine(s)
                else:
                    with self._lock:
                        s.pending_flows -= flows
                        s.dispatched_chunks += 1
                        s.dispatched_flows += flows
                        s.busy_s += time.perf_counter() - t0
                    fut.set_result(out)
                    s.breaker.record_success()
                item = None
        except BaseException as exc:  # noqa: BLE001 — worker death: supervise
            self._affinities[s.index].release()
            with self._work:
                orphans = [(f, exc) for f in self._mark_dead(s, item)]
            for ofut, oexc in orphans:
                _fail(ofut, oexc)

    def _quarantine(self, s: _Stream) -> None:
        """A live stream's breaker just tripped OPEN: migrate its queued
        chunks to surviving CLOSED streams so they don't wait out the
        cooldown behind a failing device. With no survivor they stay — the
        worker is alive and keeps draining (better than dropping)."""
        with self._work:
            targets = [t for t in self._streams
                       if t is not s and not t.dead
                       and t.thread is not None and t.thread.is_alive()
                       and t.breaker.state == CLOSED]
            if not targets:
                return
            moved = False
            while s.q:
                it = s.q.popleft()
                s.pending_flows -= it[1]
                tgt = min(targets, key=lambda t: t.pending_flows)
                tgt.pending_flows += it[1]
                tgt.q.append(it)
                self._migrated_chunks += 1
                moved = True
            if moved:
                self._work.notify_all()

    # holds: _lock
    def _mark_dead(self, s: _Stream, item) -> list:
        """Reap a dead worker's stream: mark it dead, migrate its FIFO
        (plus the un-started in-hand ``item``, if any) to surviving
        streams, and schedule a respawn with doubling backoff. Returns the
        futures of chunks with nowhere to go — the caller MUST fail them
        outside the lock (resolving futures under it could run arbitrary
        done-callbacks while we hold it)."""
        s.dead = True
        s.crashes += 1
        s.errors += 1
        s.breaker.record_failure()
        doomed = []
        if item is not None:
            s.pending_flows -= item[1]
            if not item[2].done():
                doomed.append(item)
        while s.q:
            it = s.q.popleft()
            s.pending_flows -= it[1]
            if not it[2].done():
                doomed.append(it)
        targets = [t for t in self._streams
                   if t is not s and not t.dead
                   and t.thread is not None and t.thread.is_alive()]
        orphans, moved = [], False
        for it in doomed:
            # a future already RUNNING (death hit between set_running and
            # resolution) cannot be re-run elsewhere — fail it instead
            if targets and not it[2].running():
                tgt = min(targets, key=lambda t: t.pending_flows)
                tgt.pending_flows += it[1]
                tgt.q.append(it)
                self._migrated_chunks += 1
                moved = True
            else:
                orphans.append(it[2])
        if moved:
            self._work.notify_all()
        if not self._closed:
            backoff = min(self.respawn_backoff_s * (2 ** (s.crashes - 1)),
                          self.max_respawn_backoff_s)
            t = threading.Timer(backoff, self._respawn, args=(s,))
            t.daemon = True
            t.start()
        return orphans

    def _respawn(self, s: _Stream) -> None:
        """Backoff-timer callback: bring a dead stream's worker back.

        Keyed on ``s.dead``, not on the thread: the worker that died may
        still be alive when the timer fires (failing its orphans, running
        their done-callbacks), and reading it as healthy would lose the
        stream for the life of the pool."""
        with self._lock:
            if self._closed or not s.dead:
                return
            s.dead = False
            s.respawns += 1
            self._spawn(s)

    # -- ops surface ---------------------------------------------------------

    def stats(self) -> dict:
        """``{"count": N, "dead_streams": ..., "per_device": [{...}, ...]}``
        — the ``devices`` section of the unified server ``stats()`` schema.
        Silently-dead workers are detected (and reaped) here too, so the
        stats surface never under-reports ``dead_streams``."""
        elapsed = max(time.perf_counter() - self._t0, 1e-9)
        orphans: list = []
        with self._lock:
            for s in self._streams:
                if (not s.dead
                        and (s.thread is None or not s.thread.is_alive())):
                    exc = RuntimeError(
                        f"device-stream-{s.index} worker found dead at "
                        "stats() time; chunk could not be migrated")
                    orphans.extend(
                        (f, exc) for f in self._mark_dead(s, None))
            doc = {
                "count": len(self._streams),
                "dead_streams": sum(1 for s in self._streams if s.dead),
                "healthy_streams": sum(
                    1 for s in self._streams
                    if not s.dead and s.breaker.state == CLOSED),
                "inline_dispatches": self._inline_dispatches,
                "migrated_chunks": self._migrated_chunks,
                "per_device": [
                    {
                        "device": str(s.device),
                        "dispatched_chunks": s.dispatched_chunks,
                        "dispatched_flows": s.dispatched_flows,
                        "queue_depth": len(s.q),
                        "pending_flows": s.pending_flows,
                        "errors": s.errors,
                        "busy_ms": s.busy_s * 1e3,
                        "utilization": s.busy_s / elapsed,
                        "dead": s.dead,
                        "crashes": s.crashes,
                        "respawns": s.respawns,
                        "state": s.breaker.state,
                    }
                    for s in self._streams
                ],
            }
        for ofut, oexc in orphans:
            _fail(ofut, oexc)
        return doc

    def close(self, timeout: float = 5.0) -> None:
        """Stop accepting work, let queued work finish, join the workers.
        Pending respawn timers see ``_closed`` and stand down."""
        with self._work:
            if self._closed:
                return
            self._closed = True
            self._work.notify_all()
            threads = [s.thread for s in self._streams
                       if s.thread is not None]
        for t in threads:
            t.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _on_stream(s: _Stream, fn):
    """``fn(device)`` with ``s``'s CUDA stream current (inline on the CPU)."""
    if s.stream is None:
        return fn(s.device)
    with torch.cuda.stream(s.stream):
        return fn(s.device)


def _fail(fut: Future, exc: BaseException) -> None:
    """Fail an orphaned chunk future, tolerating a racing cancel/resolve."""
    if fut.done():
        return
    try:
        fut.set_exception(exc)
    except InvalidStateError:
        pass
