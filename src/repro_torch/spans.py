"""Spans of the serving path, kept in memory: where the drain thread's time
goes, round by round, on the clock the requests are stamped with.

One recorder serves the whole process. It is off unless :func:`enable` was
called: ``RECORDER`` is then None, and each instrumented site costs one
global load and a ``None`` test. Once on, a site stamps the start and end
of its step and records the span with its name and thread::

    from repro_torch import spans

    spans.enable()
    ...                          # serve
    recs = spans.disable()       # a Records snapshot; the recorder is off again
    rounds = recs.of("server.round")

Stamps come from ``time.perf_counter()``, the clock of ``t_submit`` and
``t_dispatch`` (a span reuses a stamp the code already took). A span is
written once, when it ends, into preallocated typed columns, so recording
allocates no Python object the cyclic collector would track and keeps no
per-thread state. A slot is claimed by ``next()`` on a shared counter,
which takes no lock; once ``capacity`` slots are used, further spans are
dropped and counted, and the recorder never blocks or grows. Spans on one
thread nest, so a span's parent, the innermost span of its thread that
holds it, is found when the records are read; a request's wait
(``scheduler.queue``) belongs to the span that holds its end, the round
that dispatched it.

The names, by layer (``layer.step``); what a round spends outside them is
the server's own bookkeeping (chunking, counters, the split per request):

=====================  ====================================================
``server.round``       one iteration of the async drain loop that pulled
                       work or finished a round: round N's finish if its
                       outputs had landed, the pull of round N + 1 and
                       its begin, else then round N's finish
``server.wait``        the drain thread parked for work or in a retry backoff
``scheduler.pull``     ``WFQScheduler.pull_round``
``scheduler.queue``    one per request, from its submit to its dispatch
``server.coalesce``    the requests packed into a pinned slot (off the
                       card's direct path, also copied to the device)
``plan.call``          one plan call per chunk (copy-in, graph replay, and
                       the output's copy into a pinned slot; no clone)
``server.copy_back``   the wait for a group's outputs on the host (on the
                       card: on the event after their copy into a pinned
                       slot alone) and their copy out of the slot
``server.resolve``     the futures resolved, their callbacks included
=====================  ====================================================

Each span costs the thread that records it a few microseconds, so the
set is kept to the steps the benchmark's metrics read.
"""

from __future__ import annotations

import array
import itertools
from threading import get_ident

import numpy as np

__all__ = ["NAMES", "RECORDER", "Recorder", "Records", "enable", "disable"]

NAMES = ("server.round", "server.wait", "scheduler.pull", "scheduler.queue",
         "server.coalesce", "plan.call", "server.copy_back", "server.resolve")
(SERVER_ROUND, SERVER_WAIT, SCHEDULER_PULL, SCHEDULER_QUEUE, SERVER_COALESCE,
 PLAN_CALL, SERVER_COPY_BACK, SERVER_RESOLVE) = range(len(NAMES))


def _parents(name, start, end, thread) -> np.ndarray:
    """Each span's parent: the innermost span of its thread that holds it
    (a ``scheduler.queue`` span: that holds its end); -1 for none. Of two
    spans with the same interval the one recorded later, which ended
    later, is the parent."""
    parent = np.full(len(name), -1, np.int64)
    # a request's wait is placed at its end, when its thread dispatched it,
    # and holds no other span
    queue = name == SCHEDULER_QUEUE
    first = np.where(queue, end, start)
    for t in np.unique(thread):
        mine = np.flatnonzero(thread == t)
        order = mine[np.lexsort((-mine, -end[mine], first[mine]))]
        stack: list[tuple[float, int]] = []        # (end, index) of the open spans
        for i, e, q in zip(order.tolist(), end[order].tolist(), queue[order].tolist()):
            while stack and stack[-1][0] < e:
                stack.pop()
            if stack:
                parent[i] = stack[-1][1]
            if not q:
                stack.append((e, i))
    return parent


class Records:
    """A snapshot of a recorder's spans, one entry per span in the order
    they ended: ``name`` (an index into ``names``), ``start`` and ``end``
    (perf-counter seconds), ``thread`` (the recording thread's ident) and
    ``parent`` (an index into these arrays, -1 for none). ``dropped``
    counts the spans that found the recorder full."""

    def __init__(self, name, start, end, thread, dropped: int):
        self.names = NAMES
        self.name, self.start, self.end, self.thread = name, start, end, thread
        self.parent = _parents(name, start, end, thread)
        self.dropped = int(dropped)

    def __len__(self) -> int:
        return len(self.name)

    def of(self, name: str) -> np.ndarray:
        """Indexes of the spans called ``name``."""
        return np.flatnonzero(self.name == NAMES.index(name))


class Recorder:
    """Fixed-capacity span columns (see the module docstring)."""

    def __init__(self, capacity: int = 1 << 20):
        if capacity < 1:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = cap = int(capacity)
        self._cols = names, starts, ends, threads = (
            array.array("b", [0]) * cap, array.array("d", [0.0]) * cap,
            array.array("d", [0.0]) * cap, array.array("Q", [0]) * cap)
        self._claim = claim = itertools.count().__next__

        # closures over the columns: the fewest lookups a span can cost
        def add(name: int, start: float, end: float) -> None:
            """Record span ``name`` from ``start`` to ``end`` on this thread."""
            i = claim()
            if i < cap:
                names[i] = name
                starts[i] = start
                ends[i] = end
                threads[i] = get_ident()

        def add_all(name: int, begins, end: float) -> None:
            """Record one span ``name`` from each of ``begins`` to ``end``."""
            thread = get_ident()
            for start in begins:
                i = claim()
                if i < cap:
                    names[i] = name
                    starts[i] = start
                    ends[i] = end
                    threads[i] = thread

        self.add, self.add_all = add, add_all

    def records(self) -> Records:
        """Copy out every span recorded so far."""
        claimed = self._claim()          # claims one slot more, which stays empty
        n = min(claimed, self.capacity)
        cols = [np.frombuffer(c, dtype=c.typecode)[:n].copy() for c in self._cols]
        return Records(*cols, dropped=max(0, claimed - self.capacity))


RECORDER: Recorder | None = None


def enable(capacity: int = 1 << 20) -> Recorder:
    """Turn the process's recorder on with room for ``capacity`` spans."""
    global RECORDER
    if RECORDER is not None:
        raise RuntimeError("the span recorder is on already; disable() it first")
    RECORDER = Recorder(capacity)
    return RECORDER


def disable() -> Records:
    """Turn the recorder off and return what it recorded."""
    global RECORDER
    rec = RECORDER
    if rec is None:
        raise RuntimeError("the span recorder is off")
    RECORDER = None
    return rec.records()
