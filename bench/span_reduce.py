"""The program's span records beside the device trace.

``records`` is what ``repro_torch.spans.disable()`` returns: per span a
``name`` (an index into ``names``), ``start`` and ``end`` on the
perf-counter clock, ``parent`` (an index, -1 for none) and ``thread``. The device trace's busy intervals
(``bench.tracing.Tracer.result()["spans"]``) are on the same clock, so the
two compare with no conversion. Nothing here imports the program: a run
whose program records no spans passes none.
"""

from __future__ import annotations

import numpy as np

__all__ = ["named", "window", "server_self_s", "drain_thread", "idle_by_span",
           "idle_in_rounds_s"]

# spans that record no work of the thread that holds them: a request's wait
QUEUE = "scheduler.queue"


def named(records, *names: str) -> np.ndarray:
    """Mask of the spans called one of ``names``."""
    return np.isin(records.name, [records.names.index(n) for n in names])


def window(records, mask: np.ndarray, t0: float, t1: float) -> np.ndarray:
    """``mask`` narrowed to the spans that lie inside ``[t0, t1]``."""
    return mask & (records.start >= t0) & (records.end <= t1)


def _roots(records) -> np.ndarray:
    """Each span's outermost ancestor (itself when it has no parent)."""
    root = np.arange(len(records))
    while True:
        up = records.parent[root]
        more = up >= 0
        if not more.any():
            return root
        root = np.where(more, up, root)


def server_self_s(records, t0: float, t1: float) -> float:
    """Seconds of the ``server.round`` spans inside ``[t0, t1]`` less the
    spans of other layers (``scheduler.*``, ``plan.*``) whose parent is a
    ``server.*`` span of those rounds: the server's own time."""
    rounds = window(records, named(records, "server.round"), t0, t1)
    if not rounds.any():
        return 0.0
    server = np.array([n.startswith("server.") for n in records.names])
    parent = records.parent
    has_parent = parent >= 0
    foreign = has_parent & ~server[records.name] & (records.name != records.names.index(QUEUE))
    foreign &= server[records.name[np.where(has_parent, parent, 0)]]
    foreign &= rounds[_roots(records)]
    dur = records.end - records.start
    return float(dur[rounds].sum() - dur[foreign].sum())


def drain_thread(records):
    """The thread that recorded the most ``server.round`` spans, or None."""
    threads = records.thread[named(records, "server.round")]
    if not threads.size:
        return None
    ids, counts = np.unique(threads, return_counts=True)
    return ids[np.argmax(counts)]


def _idle(busy, t_a: float, t_b: float) -> list[tuple[float, float]]:
    """The gaps of sorted, disjoint ``busy`` intervals inside ``[t_a, t_b]``."""
    out, at = [], t_a
    for s, e in busy:
        s, e = min(max(s, t_a), t_b), min(max(e, t_a), t_b)
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < t_b:
        out.append((at, t_b))
    return out


def _own_pieces(records, mask: np.ndarray) -> list[tuple[float, float, str]]:
    """Where each span of ``mask`` (one thread's, nested) is the innermost
    one open: its interval less its children's, in time order."""
    idx = np.flatnonzero(mask)
    order = idx[np.lexsort((idx, -records.end[idx], records.start[idx]))]
    starts, ends = records.start[order].tolist(), records.end[order].tolist()
    names = [records.names[k] for k in records.name[order].tolist()]
    pieces: list[tuple[float, float, str]] = []
    stack: list[list] = []          # [end, name, covered up to]

    def pop():
        top = stack.pop()
        if top[0] > top[2]:
            pieces.append((top[2], top[0], top[1]))
        if stack:
            stack[-1][2] = max(stack[-1][2], top[0])

    for s, e, name in zip(starts, ends, names):
        while stack and stack[-1][0] <= s:
            pop()
        if stack:
            parent = stack[-1]
            e = min(e, parent[0])
            if s > parent[2]:
                pieces.append((parent[2], s, parent[1]))
            parent[2] = max(parent[2], s)
            s = max(s, parent[2])
        stack.append([e, name, s])
    while stack:
        pop()
    return pieces


def _overlap(pieces, gaps) -> dict[str, float]:
    """Length of each label's pieces that lies inside ``gaps`` (both sorted
    and disjoint)."""
    out: dict[str, float] = {}
    i = j = 0
    while i < len(pieces) and j < len(gaps):
        s = max(pieces[i][0], gaps[j][0])
        e = min(pieces[i][1], gaps[j][1])
        if e > s:
            out[pieces[i][2]] = out.get(pieces[i][2], 0.0) + (e - s)
        if pieces[i][1] < gaps[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle_by_span(busy, records, t_a: float, t_b: float) -> dict[str, float]:
    """Device-idle seconds of ``[t_a, t_b]`` by the innermost span the
    drain thread had open (request waits aside), largest first;
    ``outside_spans`` holds the rest. The values sum to the idle time."""
    gaps = _idle(busy, t_a, t_b)
    total = sum(e - s for s, e in gaps)
    thread = drain_thread(records)
    out: dict[str, float] = {}
    if thread is not None:
        mask = ((records.thread == thread) & (records.name != records.names.index(QUEUE))
                & (records.end > t_a) & (records.start < t_b))
        out = _overlap(_own_pieces(records, mask), gaps)
    out["outside_spans"] = total - sum(out.values())
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def idle_in_rounds_s(busy, records, t_a: float, t_b: float) -> float:
    """Device-idle seconds of ``[t_a, t_b]`` while the drain thread was
    inside a ``server.round``."""
    thread = drain_thread(records)
    if thread is None:
        return 0.0
    m = named(records, "server.round") & (records.thread == thread)
    rounds = sorted(zip(records.start[m], records.end[m], ["r"] * int(m.sum())))
    return _overlap(rounds, _idle(busy, t_a, t_b)).get("r", 0.0)
