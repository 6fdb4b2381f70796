"""Serving scheduler: thread-safe bounded queues + weighted fair queueing (a
copy of the JAX package's ``launch/scheduler.py`` kept inside the port).

The dataplane premise is continuous line-rate traffic — requests arrive
whenever they arrive, not when the host happens to call ``drain()``. This
module is the contention-management core the serving layer
(:mod:`repro_torch.launch.serve`) builds on:

  * :class:`WFQScheduler` — owns every per-model request queue behind ONE
    lock. ``submit`` is safe from any thread; ``pull_round`` hands the
    dispatcher (the sync ``drain()`` loop or the async background thread)
    the next slice of work according to **deficit round-robin** (DRR), the
    classic O(1) weighted-fair-queueing realization: per round, each
    backlogged model's deficit counter grows by ``quantum x weight`` and the
    model releases queued requests until the counter is spent. Under
    saturation every model's served flows/s converge to its weight share —
    a 4:1 weight skew is a 4:1 flow share — while an idle model's credit
    resets (no banking unused bandwidth). Requests are the atomic pull
    unit; the dispatcher cuts each pulled slice into bucket-aligned
    micro-batches (``repro_torch.engine.bucket_chunks``), so deficit accounting
    in flows is exactly accounting in micro-batch work.
  * **Priority classes** — named weights (:data:`PRIORITY_WEIGHTS`:
    ``high=4, normal=1, low=0.25``). Within a DRR round, backlogged models
    are visited in descending-weight order (stable on ties), so a
    high-priority model's requests both dispatch earlier in every round and
    get a larger flow share across rounds: its queue-wait percentiles sit
    strictly below a low-priority model's under saturation.
  * **Backpressure** — queues are optionally bounded (``depth``). Policy
    ``"reject"`` fails an over-limit ``submit`` immediately with
    :class:`QueueFullError`; ``"block"`` parks the submitting thread until
    the dispatcher frees space (or ``timeout`` elapses, then
    ``QueueFullError``). Unbounded (``depth=None``) keeps the
    submit-never-fails behavior of the synchronous server.
  * **Deadlines + slack-based shedding** — a request may carry a
    ``deadline_ms`` budget (milliseconds from submit to completion). At
    pull time a queue head whose queue-wait already exceeds its *slack*
    (``deadline_ms`` minus the model's EWMA slice service time) is SHED
    instead of dispatched: its future fails with a typed
    :class:`DeadlineExceededError` and the dispatcher never sees it —
    under overload the scheduler spends capacity only on requests that can
    still finish in time, so goodput-within-deadline plateaus at capacity
    instead of collapsing to zero as every queue ages past its budget.
  * **Admission control** — the reservoirs observe each model's service
    rate (EWMA flows/s), so at submit time the backlog already queued
    predicts the newcomer's queue-wait. A deadline-bearing request whose
    predicted wait exceeds its own budget is rejected up front
    (:class:`DeadlineExceededError` — fail fast, don't queue doomed work),
    and a queue configured with ``admit_ms`` caps its backlog at
    ``service_rate x admit_ms`` worth of flows for ALL requests
    (:class:`QueueFullError`): the backlog cap derives from measured
    capacity, not a guessed depth.
  * **SLO counters** — per-model ``admitted`` / ``rejected`` / ``shed`` /
    ``goodput_flows`` / ``late_flows`` counters (:meth:`counters`) plus
    starvation metrics (current head wait and max observed wait) that make
    a weight≫1 skew's starvation of low-weight queues measurable.
  * **Latency instrumentation** — every request is stamped at submit;
    ``pull_round`` stamps a PROVISIONAL dispatch time, and the dispatcher
    may re-stamp ``t_dispatch`` when the slice actually starts dispatching
    (``MultiModelServer._begin_group`` does — a round's groups run
    sequentially, so later groups keep waiting past their pull) before
    reporting the slice's service wall time via :meth:`record_service`.
    Per-model bounded reservoirs yield queue-wait / service-time
    percentiles (:meth:`latency_stats`) — the observable the WFQ tests and
    the ``async_serve`` bench gate assert on.

The scheduler never touches a plan or a device: requests reach it as numpy
arrays or tensors, and dispatching (every compiled-plan call, with its
host→device copies) stays in the server, so the async runtime funnels plan
execution through one thread while ingestion fans across many (producers
pay only the queue lock).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np

from repro_torch.analysis.sanitizer import make_lock

__all__ = [
    "LATENCY_WINDOW",
    "PRIORITY_RANK",
    "PRIORITY_WEIGHTS",
    "DeadlineExceededError",
    "ModelQueue",
    "QueueFullError",
    "WFQScheduler",
]

# priority class → WFQ weight; an explicit float weight overrides the class
PRIORITY_WEIGHTS = {"high": 4.0, "normal": 1.0, "low": 0.25}

# per-model reservoir size for queue-wait / service-time samples: percentiles
# over the last ~2k requests, bounded so a long-lived server never grows it
LATENCY_WINDOW = 2048

# weights are clamped ≥ this: a zero weight would never accumulate deficit
# and its backlogged queue could never release an oversize request
_MIN_WEIGHT = 1e-3

# distinguishes "depth not passed" from the legitimate depth=None (unbounded)
_UNSET = object()


def _resolve_weight(weight: float | None, priority: str | None) -> float:
    """weight/priority → clamped WFQ weight; explicit weight wins."""
    if weight is None:
        if priority is not None and priority not in PRIORITY_WEIGHTS:
            raise ValueError(
                f"unknown priority {priority!r}; expected one of "
                f"{sorted(PRIORITY_WEIGHTS)} (or pass weight=)")
        weight = PRIORITY_WEIGHTS[priority or "normal"]
    return max(float(weight), _MIN_WEIGHT)


class QueueFullError(RuntimeError):
    """A bounded model queue rejected (or timed out blocking on) a submit.

    Also raised by rate-based admission control when a queue configured
    with ``admit_ms`` already holds more backlog than its observed service
    rate can clear within that horizon."""


class DeadlineExceededError(RuntimeError):
    """A deadline-bearing request was shed (or refused admission).

    Raised on the request's future when its queue-wait exceeded its slack
    at pull time (``deadline_ms`` minus the model's EWMA service time —
    dispatching it would only produce a late, worthless verdict), or
    synchronously from ``submit`` when admission control predicts the
    backlog already queued makes the deadline unreachable. Either way the
    request NEVER dispatches: no plan call, no counters committed beyond
    the shed/rejected tallies."""


# EWMA smoothing for the per-model service-rate / service-time estimates
# that drive admission control and shed slack. 0.3 ≈ "the last ~5 slices
# dominate": fast enough to track a recompile or host-throttle shift,
# smooth enough that one outlier slice cannot swing admission decisions.
_EWMA_ALPHA = 0.3


#: Per-REQUEST urgency rank within one model's queue (orthogonal to the
#: per-model PRIORITY_WEIGHTS class that sets the cross-model WFQ share):
#: a submit with a higher rank queue-jumps ahead of strictly-lower-rank
#: entries, FIFO among equals.
PRIORITY_RANK = {"low": 0, "normal": 1, "high": 2}


class _Request:
    """One queued request: the input tuple plus its lifecycle stamps.
    ``deadline_ms`` is the completion budget in milliseconds from submit
    (None = no deadline: never shed, never admission-checked); ``rank``
    is the per-request urgency (:data:`PRIORITY_RANK`); ``typed``: the
    future takes the request's ``InferResult``, not its raw output."""

    __slots__ = ("inputs", "size", "future", "typed", "deadline_ms",
                 "t_submit", "t_dispatch", "rank", "requeues")

    def __init__(self, inputs: tuple, size: int, future: Future | None,
                 deadline_ms: float | None = None, rank: int = 1,
                 typed: bool = False):
        self.inputs = inputs
        self.size = size
        self.future = future
        self.typed = typed
        self.deadline_ms = deadline_ms
        self.t_submit = time.perf_counter()
        self.t_dispatch = 0.0
        self.rank = rank
        # failure-retry count (bounded by the server's max_requeues; a
        # request past the cap fails typed PoisonedRequestError) — bumped
        # by the dispatch thread only, between scheduler ownership spans
        self.requeues = 0


class ModelQueue:
    """One model's FIFO + its scheduling config. All access goes through the
    owning :class:`WFQScheduler`'s lock — this class adds no locking.
    ``flows`` tracks the queued backlog in flows (sum of request sizes) so
    admission control predicts queue-wait in O(1)."""

    __slots__ = ("name", "weight", "depth", "policy", "admit_ms", "reqs",
                 "flows")

    def __init__(self, name: str, *, weight: float = 1.0,
                 depth: int | None = None, policy: str = "block",
                 admit_ms: float | None = None):
        if policy not in ("block", "reject"):
            raise ValueError(f"unknown backpressure policy {policy!r}; "
                             "expected 'block' or 'reject'")
        if depth is not None and depth < 1:
            raise ValueError(f"queue depth must be ≥ 1 or None, got {depth}")
        if admit_ms is not None and admit_ms <= 0:
            raise ValueError(f"admit_ms must be > 0 or None, got {admit_ms}")
        self.name = name
        # every field below is owned by the scheduler that holds this queue
        # — ModelQueue adds no locking of its own
        self.weight = max(float(weight), _MIN_WEIGHT)   # guarded-by: _lock
        self.depth = depth                              # guarded-by: _lock
        self.policy = policy                            # guarded-by: _lock
        self.admit_ms = admit_ms                        # guarded-by: _lock
        self.reqs: deque[_Request] = deque()            # guarded-by: _lock
        self.flows = 0                                  # guarded-by: _lock


class WFQScheduler:
    """Thread-safe request queues scheduled by deficit round-robin.

    One lock guards the queue map, every queue's deque, the deficit
    counters, and the latency reservoirs; the two conditions share it
    (``_space``: submitters blocked on a full queue; ``_work``: a dispatcher
    waiting for anything to do). Plan dispatch happens OUTSIDE the lock —
    ``pull_round`` pops requests and returns, so a plan call on the device
    never blocks ingestion.
    """

    def __init__(self):
        self._lock = make_lock("scheduler._lock", reentrant=True)
        self._space = threading.Condition(self._lock)
        self._work = threading.Condition(self._lock)
        self._queues: dict[str, ModelQueue] = {}        # guarded-by: _lock
        self._deficit: dict[str, float] = {}            # guarded-by: _lock
        self._latency: dict[str, dict] = {}             # guarded-by: _lock
        # SLO bookkeeping: per-model counters, EWMA service rate (flows/s)
        # and slice service time (ms), and the shed requests awaiting
        # collection by the dispatcher (bounded: an uncollected backlog of
        # shed bookkeeping must not leak on a standalone scheduler)
        self._counters: dict[str, dict] = {}            # guarded-by: _lock
        self._rate: dict[str, float] = {}               # guarded-by: _lock
        self._svc_ms: dict[str, float] = {}             # guarded-by: _lock
        self._shed_pending: dict[str, deque] = {}       # guarded-by: _lock

    # -- queue management ---------------------------------------------------

    def add_queue(self, name: str, *, weight: float | None = None,
                  priority: str | None = None, depth=_UNSET,
                  policy: str | None = None, admit_ms=_UNSET) -> ModelQueue:
        """Create the queue for ``name`` (``priority`` names a class in
        :data:`PRIORITY_WEIGHTS`; an explicit ``weight`` wins;
        ``admit_ms`` caps the backlog at the observed service rate times
        that horizon — see :meth:`submit`). If the queue already exists,
        any EXPLICITLY-passed field is applied to it via :meth:`configure`
        (so re-registering a model with a new priority, bound, or policy
        is honored)."""
        w = _resolve_weight(weight, priority)
        with self._lock:
            q = self._queues.get(name)
            if q is None:
                q = ModelQueue(name, weight=w,
                               depth=None if depth is _UNSET else depth,
                               policy=policy or "block",
                               admit_ms=None if admit_ms is _UNSET
                               else admit_ms)
                self._queues[name] = q
                self._deficit[name] = 0.0
            else:
                if weight is not None or priority is not None:
                    q.weight = w
                if depth is not _UNSET or policy is not None \
                        or admit_ms is not _UNSET:
                    self.configure(name, depth=depth, policy=policy,
                                   admit_ms=admit_ms)
            return q

    def configure(self, name: str, *, weight: float | None = None,
                  priority: str | None = None, depth=_UNSET,
                  policy: str | None = None, admit_ms=_UNSET) -> None:
        """Re-configure a live queue; only explicitly-passed fields change
        (``depth=None`` means unbounded and ``admit_ms=None`` disables
        admission control, so absence is a sentinel)."""
        with self._lock:
            q = self._queues[name]
            if weight is not None or priority is not None:
                q.weight = _resolve_weight(weight, priority)
            if depth is not _UNSET:
                if depth is not None and depth < 1:
                    raise ValueError(
                        f"queue depth must be ≥ 1 or None, got {depth}")
                q.depth = depth
                self._space.notify_all()     # a raised bound frees submitters
            if policy is not None:
                if policy not in ("block", "reject"):
                    raise ValueError(
                        f"unknown backpressure policy {policy!r}; expected "
                        "'block' or 'reject'")
                q.policy = policy
            if admit_ms is not _UNSET:
                if admit_ms is not None and admit_ms <= 0:
                    raise ValueError(
                        f"admit_ms must be > 0 or None, got {admit_ms}")
                q.admit_ms = admit_ms

    def remove_queue(self, name: str) -> list[_Request]:
        """Drop a queue; returns its still-pending requests so the caller can
        fail their futures."""
        with self._lock:
            q = self._queues.pop(name, None)
            self._deficit.pop(name, None)
            self._latency.pop(name, None)
            self._counters.pop(name, None)
            self._rate.pop(name, None)
            self._svc_ms.pop(name, None)
            self._shed_pending.pop(name, None)
            if q is None:
                return []
            reqs = list(q.reqs)
            q.reqs.clear()
            q.flows = 0
            # anyone blocked submitting to this queue must wake and notice
            self._space.notify_all()
            return reqs

    def set_weight(self, name: str, *, weight: float | None = None,
                   priority: str | None = None) -> float:
        """Re-class a live queue (takes effect next DRR round). One of
        ``weight``/``priority`` is required — a bare call must not silently
        demote the queue to the normal class."""
        if weight is None and priority is None:
            raise ValueError("pass weight= or priority= (a bare set_weight "
                             "would silently reset to the normal class)")
        with self._lock:
            q = self._queues[name]
            q.weight = _resolve_weight(weight, priority)
            return q.weight

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._queues

    def pending(self) -> dict[str, int]:
        with self._lock:
            return {n: len(q.reqs) for n, q in self._queues.items() if q.reqs}

    def describe(self) -> dict:
        """Static scheduling config + live backlog (the stats surface)."""
        with self._lock:
            return {
                name: {"weight": q.weight, "depth": q.depth,
                       "policy": q.policy, "admit_ms": q.admit_ms,
                       "pending": len(q.reqs), "pending_flows": q.flows}
                for name, q in sorted(self._queues.items())
            }

    # -- ingestion ----------------------------------------------------------

    def submit(self, name: str, inputs: tuple, size: int, *,
               future: Future | None = None,
               timeout: float | None = None,
               deadline_ms: float | None = None,
               priority: str = "normal", typed: bool = False) -> int:
        """Enqueue one request; returns its queue position at insert time.

        ``size`` is the request's flow count (its leading batch dim — the
        unit every scheduling quantity is denominated in); ``timeout`` is
        in seconds, ``deadline_ms`` in milliseconds from NOW to completion.
        ``priority`` is the PER-REQUEST urgency within this model's queue
        (:data:`PRIORITY_RANK`): a ``"high"`` request is inserted ahead of
        every queued ``normal``/``low`` entry (FIFO among equal ranks);
        the default ``"normal"`` path stays an O(1) append whenever the
        queue tail is not lower-ranked. Cross-MODEL share is still the
        queue's weight class — this knob never changes it. ``typed`` rides
        on the queued request for the server that resolves ``future``.

        Failure modes, in check order:

          * **Admission control** (before any queueing or blocking) — once
            the queue has an observed service rate, the backlog predicts
            the newcomer's queue-wait. A ``deadline_ms`` request predicted
            to miss its own budget raises :class:`DeadlineExceededError`;
            a queue with ``admit_ms`` set rejects ANY request once its
            backlog exceeds ``rate x admit_ms`` worth of flows
            (:class:`QueueFullError`). Before the first served slice there
            is no rate estimate and everything is admitted.
          * **Depth backpressure** — per the queue's policy: ``reject``
            raises :class:`QueueFullError` when full; ``block`` waits for
            space up to ``timeout`` seconds (``None`` = forever), then
            raises. ``KeyError`` if the model is removed while blocked.
        """
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0 or None, "
                             f"got {deadline_ms}")
        try:
            rank = PRIORITY_RANK[priority]
        except KeyError:
            raise ValueError(
                f"priority must be one of {tuple(PRIORITY_RANK)}, "
                f"got {priority!r}") from None
        with self._lock:
            q = self._queues[name]
            rate = self._rate.get(name)
            if rate and (deadline_ms is not None or q.admit_ms is not None):
                predicted_ms = q.flows / rate * 1e3
                if q.admit_ms is not None and predicted_ms > q.admit_ms:
                    self._ctr(name)["rejected"] += 1
                    raise QueueFullError(
                        f"admission control: {name!r} backlog of {q.flows} "
                        f"flows predicts {predicted_ms:.0f} ms queue-wait > "
                        f"admit_ms {q.admit_ms:.0f} at the observed "
                        f"{rate:.0f} flows/s")
                if deadline_ms is not None and predicted_ms > deadline_ms:
                    self._ctr(name)["rejected"] += 1
                    raise DeadlineExceededError(
                        f"admission control: {name!r} backlog predicts "
                        f"{predicted_ms:.0f} ms queue-wait > the request's "
                        f"{deadline_ms:.0f} ms deadline — refusing doomed "
                        "work")
            if q.depth is not None and len(q.reqs) >= q.depth:
                if q.policy == "reject":
                    raise QueueFullError(
                        f"queue for {name!r} full ({q.depth} pending, "
                        "policy=reject)")
                deadline = (None if timeout is None
                            else time.monotonic() + timeout)
                # re-check depth each wake: configure() may have lifted the
                # bound to None (unbounded) while this submitter slept
                while q.depth is not None and len(q.reqs) >= q.depth:
                    remaining = (None if deadline is None
                                 else deadline - time.monotonic())
                    if remaining is not None and remaining <= 0:
                        raise QueueFullError(
                            f"queue for {name!r} still full ({q.depth} "
                            f"pending) after blocking {timeout}s")
                    self._space.wait(remaining)
                    if name not in self._queues:   # removed while we slept
                        raise KeyError(
                            f"model {name!r} was removed while its queue "
                            "was full")
                    q = self._queues[name]
            req = _Request(inputs, int(size), future, deadline_ms, rank, typed)
            pos = len(q.reqs)
            if rank > 0 and pos and q.reqs[-1].rank < rank:
                # queue-jump: slot ahead of every strictly-lower-rank entry
                # (scan from the back so equal ranks stay FIFO); the default
                # all-normal queue never enters this branch
                while pos > 0 and q.reqs[pos - 1].rank < rank:
                    pos -= 1
                q.reqs.insert(pos, req)
            else:
                q.reqs.append(req)
            q.flows += req.size
            self._ctr(name)["admitted"] += 1
            self._work.notify_all()
            return pos

    def requeue_front(self, name: str, reqs: list[_Request]) -> None:
        """Put a failed slice back at the FRONT of its queue, in order —
        the sync drain's retry semantics (counters untouched, FIFO kept)."""
        if not reqs:
            return
        with self._lock:
            q = self._queues.get(name)
            if q is None:
                return
            q.reqs.extendleft(reversed(reqs))
            q.flows += sum(r.size for r in reqs)
            self._work.notify_all()

    def discard(self, name: str) -> list[_Request]:
        """Clear a queue (poisoned-request escape hatch); returns the dropped
        requests so the caller can fail their futures. The queue's deficit
        resets with it — an emptied queue must not bank credit (an oversize
        head may have inflated it via the catch-up jump)."""
        with self._lock:
            q = self._queues.get(name)
            if q is None:
                return []
            reqs = list(q.reqs)
            q.reqs.clear()
            q.flows = 0
            self._deficit[name] = 0.0
            self._space.notify_all()
            return reqs

    # -- scheduling ---------------------------------------------------------

    def pull_round(self, quantum: float,
                   exclude: frozenset | set = frozenset()
                   ) -> list[tuple[str, list[_Request]]]:
        """One deficit-round-robin round: every backlogged model (minus
        ``exclude``), in descending-weight order, earns ``quantum x weight``
        credit and releases FIFO requests while the next one fits.

        **Deadline shedding happens here**: before a queue head is
        considered for dispatch, a deadline-bearing head whose queue-wait
        already exceeds its slack (``deadline_ms`` minus the model's EWMA
        slice service time — dispatching it now would still finish late)
        is popped, its future failed with :class:`DeadlineExceededError`,
        and NO credit is charged. Shed requests are retrievable once via
        :meth:`take_shed` for dispatcher bookkeeping. Requests without a
        deadline are never shed.

        Guarantees progress: if no backlogged head fits its credit this
        round (a request larger than one quantum), every backlogged queue
        is advanced the minimal whole number of rounds that lets SOME head
        fit — one O(1) jump instead of busy-looping round by round under
        the lock, with the same weight-proportional credit each queue would
        have earned. A model whose queue empties forfeits leftover credit
        (classic DRR: idle models don't bank bandwidth). Returns
        ``[(name, [requests]), ...]`` in dispatch order; empty means
        nothing eligible is pending (everything pending may have been
        shed).
        """
        with self._lock:
            out: list[tuple[str, list[_Request]]] = []
            while not out:
                backlogged = [q for q in self._queues.values()
                              if q.reqs and q.name not in exclude]
                if not backlogged:
                    break
                # descending weight, stable on ties (dict = insertion order)
                backlogged.sort(key=lambda q: -q.weight)
                now = time.perf_counter()
                for q in backlogged:
                    credit = self._deficit[q.name] + quantum * q.weight
                    pulled: list[_Request] = []
                    while q.reqs:
                        head = q.reqs[0]
                        if self._past_slack(q.name, head, now):
                            q.reqs.popleft()
                            q.flows -= head.size
                            self._shed(q.name, head, now)
                            continue
                        if head.size > credit:
                            break
                        q.reqs.popleft()
                        q.flows -= head.size
                        credit -= head.size
                        head.t_dispatch = now
                        pulled.append(head)
                    # empty queue forfeits credit; a backlogged one keeps it
                    self._deficit[q.name] = credit if q.reqs else 0.0
                    if pulled:
                        out.append((q.name, pulled))
                        c = self._ctr(q.name)
                        c["dispatched_flows"] += sum(r.size for r in pulled)
                        c["max_wait_ms"] = max(
                            c["max_wait_ms"],
                            (now - pulled[0].t_submit) * 1e3)
                if not out:
                    # every head is oversize: jump the minimal number of
                    # extra rounds (per-queue credit stays ∝ weight).
                    # Re-filter: shedding above may have emptied queues.
                    backlogged = [q for q in backlogged
                                  if q.reqs and q.name not in exclude]
                    if not backlogged:
                        continue
                    k = max(1, min(
                        -(-(q.reqs[0].size - self._deficit[q.name])
                          // (quantum * q.weight))
                        for q in backlogged))
                    for q in backlogged:
                        self._deficit[q.name] += k * quantum * q.weight
            if out:
                self._space.notify_all()
            return out

    # holds: _lock
    def _past_slack(self, name: str, req: _Request, now: float) -> bool:
        """True when dispatching ``req`` now would still miss its deadline:
        queue-wait so far > deadline minus the model's EWMA service time
        (no estimate yet → the raw deadline is the slack).

        The estimate's claim on the slack is capped at HALF the request's
        budget — a request always gets at least ``deadline/2`` of queue
        time before shedding. Uncapped, a transiently-inflated estimate (a
        trace compile timed into a slice, one throttled run) exceeding the
        deadline sheds EVERY request instantly — and since only served
        slices update the EWMA, nothing ever corrects it: the queue sheds
        forever on a stale number. The cap keeps at least the fresh tail
        dispatching, whose real service times decay the estimate back
        down (self-healing observed vs permanent starvation without it)."""
        if req.deadline_ms is None:
            return False
        wait_ms = (now - req.t_submit) * 1e3
        est_ms = min(self._svc_ms.get(name, 0.0), 0.5 * req.deadline_ms)
        return wait_ms > req.deadline_ms - est_ms

    # holds: _lock
    def _shed(self, name: str, req: _Request, now: float) -> None:
        """Shed bookkeeping (caller holds the lock): counters, the
        take_shed() handoff, and the future's typed failure."""
        wait_ms = (now - req.t_submit) * 1e3
        c = self._ctr(name)
        c["shed"] += 1
        c["shed_flows"] += req.size
        c["max_wait_ms"] = max(c["max_wait_ms"], wait_ms)
        pend = self._shed_pending.get(name)
        if pend is None:
            pend = self._shed_pending[name] = deque(maxlen=LATENCY_WINDOW)
        pend.append(req)
        self._space.notify_all()        # shedding frees bounded-queue space
        fut = req.future
        if fut is not None and not fut.done():
            try:
                fut.set_exception(DeadlineExceededError(
                    f"request to {name!r} shed after {wait_ms:.1f} ms "
                    f"queue-wait against a {req.deadline_ms:.0f} ms deadline "
                    f"(est. service {self._svc_ms.get(name, 0.0):.1f} ms)"))
            except Exception:           # cancelled mid-shed: caller owns it
                pass

    def take_shed(self) -> dict[str, list]:
        """Hand the dispatcher every request shed since the last call
        (``{name: [requests]}``) and clear the pending list. Futures are
        already failed at shed time — this exists for dispatcher-side
        bookkeeping (e.g. ``serve()``'s PartialDrainError shed report)."""
        with self._lock:
            out = {name: list(reqs)
                   for name, reqs in self._shed_pending.items() if reqs}
            self._shed_pending.clear()
            return out

    def wait_for_work(self, timeout: float | None) -> bool:
        """Park until any queue is non-empty (or timeout); returns whether
        work is pending. The async drain loop's idle wait."""
        with self._lock:
            if any(q.reqs for q in self._queues.values()):
                return True
            self._work.wait(timeout)
            return any(q.reqs for q in self._queues.values())

    def kick(self) -> None:
        """Wake a parked dispatcher (used by stop())."""
        with self._lock:
            self._work.notify_all()

    # -- latency + SLO instrumentation --------------------------------------

    # holds: _lock
    def _ctr(self, name: str) -> dict:
        """Per-model SLO counter record (caller holds the lock)."""
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = {
                "admitted": 0, "rejected": 0, "shed": 0, "shed_flows": 0,
                "dispatched_flows": 0, "served_flows": 0,
                "goodput_flows": 0, "late_flows": 0, "max_wait_ms": 0.0,
            }
        return c

    def record_service(self, name: str, reqs: list[_Request],
                       service_ms: float) -> None:
        """Fold one served slice into the reservoirs: each request's
        queue-wait (submit → pull), the slice's service wall time, the
        EWMA service-rate/-time estimates admission control and shed slack
        read, and the goodput split (a deadline-bearing request completing
        within its budget counts its flows as goodput; past it, as late)."""
        now = time.perf_counter()
        with self._lock:
            lat = self._latency.get(name)
            if lat is None:
                lat = self._latency[name] = {
                    "queue_wait_ms": deque(maxlen=LATENCY_WINDOW),
                    "service_ms": deque(maxlen=LATENCY_WINDOW),
                }
            flows = 0
            c = self._ctr(name)
            for r in reqs:
                lat["queue_wait_ms"].append(
                    (r.t_dispatch - r.t_submit) * 1e3)
                lat["service_ms"].append(service_ms)
                flows += r.size
                if r.deadline_ms is not None:
                    if (now - r.t_submit) * 1e3 <= r.deadline_ms:
                        c["goodput_flows"] += r.size
                    else:
                        c["late_flows"] += r.size
            c["served_flows"] += flows
            if service_ms > 0 and flows:
                rate = flows / (service_ms / 1e3)
                prev = self._rate.get(name)
                self._rate[name] = (rate if prev is None else
                                    (1 - _EWMA_ALPHA) * prev
                                    + _EWMA_ALPHA * rate)
                prev_ms = self._svc_ms.get(name)
                self._svc_ms[name] = (service_ms if prev_ms is None else
                                      (1 - _EWMA_ALPHA) * prev_ms
                                      + _EWMA_ALPHA * service_ms)

    def counters(self) -> dict:
        """Per-model SLO counters (admission/shed/goodput) plus live
        starvation metrics, all denominated in flows unless named ``_ms``:

          * ``admitted`` / ``rejected`` — requests accepted vs refused by
            admission control (depth-policy rejections raise out of
            ``submit`` and are NOT counted here),
          * ``shed`` / ``shed_flows`` — requests dropped at pull time for
            a missed deadline slack,
          * ``dispatched_flows`` / ``served_flows`` — flows handed to the
            dispatcher vs flows whose slice completed,
          * ``goodput_flows`` / ``late_flows`` — served flows that made vs
            missed their deadline (no-deadline flows count in neither),
          * ``max_wait_ms`` — worst queue-wait ever observed (dispatch or
            shed) — the starvation high-water mark for weight≫1 skews,
          * ``head_wait_ms`` — the CURRENT oldest pending request's wait
            (0 when idle): a growing value on a backlogged low-weight
            queue is starvation happening right now,
          * ``service_rate_flows_s`` / ``service_ms_ewma`` — the EWMA
            estimates driving admission control and shed slack.
        """
        now = time.perf_counter()
        with self._lock:
            out = {}
            for name in sorted(set(self._counters) | set(self._queues)):
                c = dict(self._ctr(name))
                q = self._queues.get(name)
                c["head_wait_ms"] = (
                    (now - q.reqs[0].t_submit) * 1e3
                    if q is not None and q.reqs else 0.0)
                c["service_rate_flows_s"] = self._rate.get(name)
                c["service_ms_ewma"] = self._svc_ms.get(name)
                out[name] = c
            return out

    def reset_counters(self) -> None:
        """Zero the SLO counters (benchmarks reset between phases); the
        EWMA rate/service estimates persist — they describe the model, not
        the measurement window."""
        with self._lock:
            self._counters.clear()

    def reset_latency(self) -> None:
        """Drop the reservoirs (benchmarks reset after warmup)."""
        with self._lock:
            self._latency.clear()

    def latency_stats(self) -> dict:
        """Per-model queue-wait + service-time percentiles over the
        reservoir window."""
        with self._lock:
            snap = {name: {k: list(v) for k, v in lat.items()}
                    for name, lat in self._latency.items()}
        out = {}
        for name, lat in sorted(snap.items()):
            entry = {"samples": len(lat["queue_wait_ms"])}
            for key, samples in lat.items():
                if samples:
                    p50, p90, p99 = np.percentile(
                        np.asarray(samples, np.float64), [50, 90, 99])
                    entry[key] = {"p50": round(float(p50), 3),
                                  "p90": round(float(p90), 3),
                                  "p99": round(float(p99), 3)}
            out[name] = entry
        return out
