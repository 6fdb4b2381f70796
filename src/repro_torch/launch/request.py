"""Typed request/result surface for serving (a copy of
``repro.launch.request`` kept inside the port).

``InferRequest`` is frozen — a request is a value. ``inputs`` is always a
tuple (a bare array normalizes to a 1-tuple). ``InferResult`` carries the
output plus its flow count and, where a scheduler observed it, the queue
wait.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

__all__ = ["InferRequest", "InferResult", "PRIORITIES"]

#: Valid per-request priorities, in ascending urgency.
PRIORITIES = ("low", "normal", "high")


@dataclass(frozen=True)
class InferRequest:
    """One inference request: which model, what inputs, how urgent.

    ``model`` is the registered model name (ignored by the single-model
    ``PegasusServer``); ``inputs`` one array or a tuple of arrays with the
    flows on axis 0; ``deadline_ms`` an optional latency budget; ``priority``
    one of :data:`PRIORITIES`.
    """

    model: str
    inputs: Any
    deadline_ms: float | None = None
    priority: str = "normal"

    def __post_init__(self):
        if self.priority not in PRIORITIES:
            raise ValueError(
                f"priority must be one of {PRIORITIES}, got {self.priority!r}")
        if not isinstance(self.inputs, tuple):
            object.__setattr__(
                self, "inputs",
                tuple(self.inputs) if isinstance(self.inputs, list)
                else (self.inputs,))
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got {self.deadline_ms}")

    @property
    def flows(self) -> int:
        """Number of flows (batch rows) this request carries."""
        return int(self.inputs[0].shape[0])


@dataclass(frozen=True)
class InferResult:
    """One served response: the output rows of this request, the flow
    count, and the queue wait (None where no scheduler queued it)."""

    model: str
    output: Any
    flows: int
    queue_wait_ms: float | None = field(default=None, compare=False)
