"""The one traffic generator: every mix under ``bench/mixes/`` is a file of
parameters for it.

Two loop types:

* ``"closed"``: ``clients`` callers, each sending its next request when its
  last one returns (``{"type": "closed", "clients": 8, "sizes": [...]}``).
* ``"open"``: requests due on a schedule whatever the server does, at a
  mean ``rate`` per second, with ``"arrivals": "poisson"`` or ``"onoff"``
  (Poisson arrivals only inside ``on_s`` of every ``on_s + off_s``, at the
  rate that keeps the mean at ``rate``).

Sizes are drawn uniformly from ``sizes``; each request's flows are a slice
of the flow pool at an offset drawn uniformly. Everything comes from one
``numpy`` generator per seed, so a seed fixes the sequence of sizes,
offsets and due times. A closed loop has no thread of its own: a request's
completion callback (on the server's dispatch thread) sends its client's
next request, so the load adds no thread to the process.
"""

from __future__ import annotations

import time

import numpy as np

__all__ = ["Log", "open_schedule", "drive_open", "drive_closed", "request_draws"]


class Log:
    """Per-request records, made as requests are sent: ``size``, ``offset``,
    ``due`` (perf-counter seconds; the send time in a closed loop),
    ``sent``, ``done`` (NaN until it completes), ``qwait`` (the scheduler's
    queue wait in ms), ``ok`` and ``keep`` (its output is kept for the
    check). ``outputs`` maps a kept request to its output rows. Storage
    grows by whole chunks that never move, so the completion callbacks on
    the server's thread write while the sender adds requests."""

    FIELDS = {"size": np.int64, "offset": np.int64, "due": np.float64, "sent": np.float64,
              "done": np.float64, "qwait": np.float64, "ok": np.bool_, "keep": np.bool_}
    SHIFT = 14

    def __init__(self):
        self.n = 0
        self.chunks: dict[str, list[np.ndarray]] = {name: [] for name in self.FIELDS}
        self.outputs: dict[int, np.ndarray] = {}
        self.errors: list[BaseException] = []

    def new(self, size: int, offset: int, due: float, sent: float, keep: bool) -> int:
        i = self.n
        if i >> self.SHIFT == len(self.chunks["size"]):
            for name, dtype in self.FIELDS.items():
                fill = np.nan if dtype is np.float64 else 0
                self.chunks[name].append(np.full(1 << self.SHIFT, fill, dtype=dtype))
        for name, value in (("size", size), ("offset", offset), ("due", due),
                            ("sent", sent), ("keep", keep)):
            self.set(name, i, value)
        self.n = i + 1
        return i

    def set(self, name: str, i: int, value) -> None:
        self.chunks[name][i >> self.SHIFT][i & ((1 << self.SHIFT) - 1)] = value

    def get(self, name: str, i: int):
        return self.chunks[name][i >> self.SHIFT][i & ((1 << self.SHIFT) - 1)]

    def view(self, name: str) -> np.ndarray:
        """A copy of field ``name`` over the requests made so far."""
        parts = self.chunks[name]
        return np.concatenate(parts)[: self.n] if parts else np.zeros(0, self.FIELDS[name])


def request_draws(mix: dict, rng: np.random.Generator, n: int, pool_rows: int):
    """``n`` request sizes and pool offsets, and a uniform draw per request
    that decides whether its output is kept for the check."""
    sizes = rng.choice(np.asarray(mix["sizes"], np.int64), size=n)
    offsets = rng.integers(0, pool_rows - max(mix["sizes"]) + 1, size=n)
    return sizes, offsets, rng.random(n)


def open_schedule(mix: dict, rng: np.random.Generator, seconds: float) -> np.ndarray:
    """Due times in ``[0, seconds)`` of an open loop."""
    rate = float(mix["rate"])
    kind = mix.get("arrivals", "poisson")
    if kind == "poisson":
        span, r = seconds, rate
    elif kind == "onoff":
        on, off = float(mix["on_s"]), float(mix["off_s"])
        span, r = seconds * on / (on + off), rate * (on + off) / on
    else:
        raise ValueError(f"unknown arrivals {kind!r}")
    gaps = rng.exponential(1.0 / r, size=int(r * span * 1.2) + 64)
    due = np.cumsum(gaps)
    while due[-1] < span:
        due = np.concatenate([due, due[-1] + np.cumsum(rng.exponential(1.0 / r, size=1024))])
    due = due[due < span]
    if kind == "onoff":
        due = np.floor(due / on) * (on + off) + np.mod(due, on)
    return due


def drive_open(send, due: np.ndarray, t0: float) -> None:
    """Send request ``j`` (``send(j)``) at ``t0 + due[j]``, or at once when
    the generator runs late; how late it ran is in each request's ``sent``."""
    for j in range(len(due)):
        wait = t0 + due[j] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        send(j)


def drive_closed(send, clients: int, stop_at: float) -> None:
    """Start ``clients`` requests (``send(c)`` for client ``c``) and wait
    until ``stop_at``; each completion sends its client's next request from
    the completion callback, until ``stop_at``."""
    for c in range(clients):
        send(c)
    while (left := stop_at - time.perf_counter()) > 0:
        time.sleep(min(left, 0.05))
