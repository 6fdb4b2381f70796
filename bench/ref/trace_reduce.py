"""Device time by name and the device's busy time over a traced window.

Frozen copy of the reduction in ``chip_smoke.py`` ``profile_fn``, with two
changes: the window is the traced run's own (``start``, ``end`` on the
trace's clock), given by the caller, with device intervals clipped to it
(``profile_fn`` took the span from the first to the last event); and it
reads plain ``(name, start, end)`` device intervals, so that kernels
launched from threads the profiler does not follow count too. Busy time is
the union of device activity (kernels, copies, memsets) inside the window.
"""

from __future__ import annotations

__all__ = ["reduce_intervals", "is_copy"]


def is_copy(name: str) -> bool:
    """A copy or memset, not a computing kernel."""
    return name.lower().startswith(("memcpy", "memset"))


def reduce_intervals(intervals, start: float, end: float) -> dict | None:
    """``intervals``: ``(name, start, end)`` of every device activity.
    Returns ``window``, ``busy``, ``idle_share``, ``by_name`` (device time
    per name, largest first) and ``spans`` (the merged busy intervals), all
    in the intervals' unit, or None when the window holds no device time."""
    spans, by_name = [], {}
    for name, st, en in intervals:
        st, en = max(st, start), min(en, end)
        if en <= st:
            continue
        by_name[name] = by_name.get(name, 0.0) + (en - st)
        spans.append((st, en))
    if not spans:
        return None
    spans.sort()
    merged = [list(spans[0])]
    for st, en in spans[1:]:
        if st > merged[-1][1]:
            merged.append([st, en])
        else:
            merged[-1][1] = max(merged[-1][1], en)
    busy = sum(en - st for st, en in merged)
    window = end - start
    return dict(window=window, busy=busy, idle_share=1 - busy / window,
                by_name=dict(sorted(by_name.items(), key=lambda kv: -kv[1])),
                spans=[tuple(s) for s in merged])
