"""Circuit breakers for the self-healing serving stack (a copy of the JAX
package's ``launch/health.py`` kept inside the port).

One :class:`CircuitBreaker` guards one failure domain — a served model's
preferred-backend path (``MultiModelServer``/``AsyncMultiModelServer``) or
one device stream (``DeviceStreamPool``). The state machine is the
classic three-state breaker:

  * **CLOSED** — healthy; every call proceeds. ``failure_threshold``
    CONSECUTIVE failures trip it OPEN (one success resets the streak).
  * **OPEN** — quarantined; :meth:`allow` refuses until
    ``reset_timeout_s`` has elapsed since the trip, then transitions to
    HALF_OPEN and grants a probe.
  * **HALF_OPEN** — probation; up to ``half_open_probes`` in-flight
    probes are granted. A probe success auto-reinstates (→ CLOSED), a
    probe failure re-opens and restarts the cooldown.

What the owner does with a refused :meth:`allow` is its policy, not the
breaker's: the server routes the model onto the gather fallback ladder
(serving degraded), the device pool places chunks on other streams. State
plus transition counters surface through the nested ``stats()`` schema
(``health.models.<name>`` / ``devices.per_device[i]`` — see
docs/RELIABILITY.md).

The clock is injectable (``clock=time.monotonic`` by default) so the
lifecycle tests drive cooldowns without sleeping. All mutable state lives
behind one ``health._lock`` (ranked in the sanitizer's lock hierarchy as the
innermost serving rank: breaker calls happen under ``devices._lock`` in
placement, never the other way around).
"""

from __future__ import annotations

import time

from repro_torch.analysis.sanitizer import make_lock

__all__ = ["CircuitBreaker", "CLOSED", "OPEN", "HALF_OPEN"]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """Three-state consecutive-failure breaker (module docstring).

    Args:
        name: label used in stats/errors (e.g. the model name or
            ``"stream-2"``).
        failure_threshold: consecutive failures that trip CLOSED → OPEN.
        reset_timeout_s: cooldown before an OPEN breaker grants a probe.
        half_open_probes: max concurrent probe grants while HALF_OPEN.
        clock: monotonic-seconds callable (injectable for tests).
    """

    def __init__(self, name: str = "", *, failure_threshold: int = 3,
                 reset_timeout_s: float = 1.0, half_open_probes: int = 1,
                 clock=time.monotonic):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be ≥ 1, got {failure_threshold}")
        if reset_timeout_s < 0:
            raise ValueError(
                f"reset_timeout_s must be ≥ 0, got {reset_timeout_s}")
        if half_open_probes < 1:
            raise ValueError(
                f"half_open_probes must be ≥ 1, got {half_open_probes}")
        self.name = name                              # immutable
        self.failure_threshold = int(failure_threshold)   # immutable
        self.reset_timeout_s = float(reset_timeout_s)     # immutable
        self.half_open_probes = int(half_open_probes)     # immutable
        self._clock = clock                           # immutable
        self._lock = make_lock("health._lock")
        self._state = CLOSED        # guarded-by: _lock
        self._consecutive = 0       # guarded-by: _lock
        self._opened_at = 0.0       # guarded-by: _lock
        self._probes = 0            # guarded-by: _lock
        # transition counters (the stats surface)
        self._opened = 0            # guarded-by: _lock
        self._reopened = 0          # guarded-by: _lock
        self._half_opened = 0       # guarded-by: _lock
        self._reinstated = 0        # guarded-by: _lock

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May a call proceed on the guarded path right now?

        CLOSED always allows. OPEN refuses during the cooldown, then
        transitions to HALF_OPEN and grants (the caller's call IS the
        probe). HALF_OPEN grants while probe slots remain. A grant from a
        non-CLOSED state must be answered with :meth:`record_success` or
        :meth:`record_failure`, or the probe slot stays occupied."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() - self._opened_at < self.reset_timeout_s:
                    return False
                self._state = HALF_OPEN
                self._half_opened += 1
                self._probes = 1
                return True
            # HALF_OPEN: bounded concurrent probes
            if self._probes < self.half_open_probes:
                self._probes += 1
                return True
            return False

    def record_success(self) -> str:
        """A guarded call succeeded: reset the failure streak and, from
        probation, auto-reinstate (→ CLOSED). Returns the new state."""
        with self._lock:
            self._consecutive = 0
            if self._state != CLOSED:
                self._state = CLOSED
                self._probes = 0
                self._reinstated += 1
            return self._state

    def record_failure(self) -> str:
        """A guarded call failed: extend the streak; trip OPEN from CLOSED
        at the threshold, re-open immediately from HALF_OPEN (a failed
        probe restarts the cooldown). Returns the new state — callers key
        quarantine work (queue migration, fallback rebuild) off the
        transition to ``OPEN``."""
        with self._lock:
            self._consecutive += 1
            if self._state == HALF_OPEN:
                self._state = OPEN
                self._opened_at = self._clock()
                self._probes = 0
                self._reopened += 1
            elif (self._state == CLOSED
                    and self._consecutive >= self.failure_threshold):
                self._state = OPEN
                self._opened_at = self._clock()
                self._opened += 1
            return self._state

    def stats(self) -> dict:
        """State + transition counters — one entry of the nested
        ``stats()`` health schema."""
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive,
                "opened": self._opened,
                "reopened": self._reopened,
                "half_opens": self._half_opened,
                "reinstated": self._reinstated,
                "failure_threshold": self.failure_threshold,
                "reset_timeout_s": self.reset_timeout_s,
            }
