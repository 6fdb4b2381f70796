"""The traced sub-window of a ``--trace 1`` run.

A thread starts ``torch.profiler`` (device activity, which CUPTI records
for every thread of the process) a fixed time into the window and, for a
fixed time, samples which function of the port the server's dispatch
thread is in every millisecond. The profiler follows only the thread that
started it, so the samples stand in for the dispatch thread's host trace.
It is stopped only once the window is over (stopping stalls the process),
and the reduction keeps the sub-window alone. Nothing is written to disk.
"""

from __future__ import annotations

import bisect
import sys
import threading
import time
from pathlib import Path

from bench.ref.trace_reduce import reduce_intervals

__all__ = ["Tracer", "warm_profiler"]

SAMPLE_S = 0.001


def warm_profiler() -> None:
    """Start and stop the profiler once, so that its first start (CUPTI's
    set-up) falls in the set-up and not in the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def _label(frame) -> str:
    """The innermost function of the port on ``frame``'s stack, as
    ``module.function`` (else the innermost function)."""
    f, first = frame, None
    while f is not None:
        name = f.f_code.co_filename
        if first is None:
            first = f.f_code.co_name
        if "repro_torch" in name:
            return f"{Path(name).stem}.{f.f_code.co_name}"
        f = f.f_back
    return first or "?"


class Tracer(threading.Thread):
    """Trace ``[start_at, start_at + duration]`` (perf-counter seconds).
    ``counters()`` (the server's serving counters and the launch count) is
    read at both ends: ``at_start`` is the window before the sub-window."""

    def __init__(self, start_at: float, duration: float, thread_name: str, counters):
        super().__init__(name="bench-tracer", daemon=True)
        self.start_at, self.duration = start_at, duration
        self.thread_name, self.counters = thread_name, counters
        # set once the window's requests are done: stopping the profiler
        # stalls the process for about a second, so it waits till then
        self.window_over = threading.Event()
        self.samples: list[tuple[float, str]] = []
        self.error: BaseException | None = None

    def run(self) -> None:
        try:
            self._run()
        except BaseException as e:          # reported by result(), never lost
            self.error = e

    def _run(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        ident = next((t.ident for t in threading.enumerate() if t.name == self.thread_name),
                     None)
        time.sleep(max(0.0, self.start_at - time.perf_counter()))
        self.at_start = self.counters()
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
        with record_function("bench.trace.start"):
            self.t_a = time.perf_counter()
            self.wall_a = time.time_ns() * 1e-9
        self.count_a = self.counters()[0]["flows_served"]
        end = self.t_a + self.duration
        while (now := time.perf_counter()) < end:
            frame = sys._current_frames().get(ident)
            self.samples.append((now, "idle" if frame is None else _label(frame)))
            time.sleep(SAMPLE_S)
        self.count_b = self.counters()[0]["flows_served"]
        with record_function("bench.trace.end"):
            self.t_b = time.perf_counter()
        self.window_over.wait()
        torch.cuda.synchronize()
        prof.stop()
        self.prof = prof

    def result(self) -> dict | None:
        """Device time by name, busy and idle over the sub-window, the
        dispatch thread's functions while the device was idle, and the
        flows served in it; None when the trace holds no device time."""
        if self.error is not None:
            raise RuntimeError("the traced sub-window failed") from self.error
        from torch.autograd import DeviceType

        events = self.prof.profiler.kineto_results.events()
        device = [(e.name(), e.start_ns() * 1e-9, e.end_ns() * 1e-9) for e in events
                  if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
        marks = [e.start_ns() * 1e-9 for e in events
                 if e.name() == "bench.trace.start" and e.device_type() != DeviceType.CUDA]
        # trace clock minus perf clock: from the start mark, else from the
        # wall clock (the profiler stamps host and device on it)
        offsets = [m - self.t_a for m in marks[:1]] + [self.wall_a - self.t_a]
        self.diagnostics = {"device_events": len(device), "marks": len(marks)}
        if device:
            self.diagnostics["device_span_from_t_a_s"] = [
                min(d[1] for d in device) - offsets[0] - self.t_a,
                max(d[2] for d in device) - offsets[0] - self.t_a]
        for how, offset in zip(("mark", "wall")[2 - len(offsets):], offsets):
            red = reduce_intervals([(n, a - offset, b - offset) for n, a, b in device],
                                   self.t_a, self.t_b)
            if red is not None:
                self.diagnostics["aligned_by"] = how
                break
        if red is None:
            return None
        starts = [s for s, _ in red["spans"]]
        idle_by: dict[str, float] = {}
        for (t, label), nxt in zip(self.samples, self.samples[1:] + [(self.t_b, "")]):
            k = bisect.bisect_right(starts, t) - 1
            if k < 0 or t >= red["spans"][k][1]:
                idle_by[label] = idle_by.get(label, 0.0) + (nxt[0] - t)
        red["idle_by_host"] = dict(sorted(idle_by.items(), key=lambda kv: -kv[1]))
        red["flows"] = self.count_b - self.count_a
        red["samples"] = len(self.samples)
        return red
