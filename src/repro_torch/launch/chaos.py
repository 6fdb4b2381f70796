"""Deterministic fault injection for the serving stack (the chaos harness; a
copy of the JAX package's ``launch/chaos.py`` kept inside the port).

The self-healing machinery in :mod:`repro_torch.launch.serve` /
:mod:`repro_torch.launch.devices` (circuit breakers, the backend fallback
ladder, bounded retry, device-stream supervision — see
docs/RELIABILITY.md) only earns trust if its error paths can be exercised
ON DEMAND, deterministically, in tests and benches. This module provides
that: a seeded :class:`FaultInjector` holding scoped fault specs that make
a named model's plan call, a plan build, or a device-stream dispatch
raise / hang / slow on the Nth matching occurrence — transient (``count``
fires) or persistent (``count=None``).

Installation is EXPLICIT, never monkey-patching: the serving components
carry a ``chaos`` hook attribute (``None`` by default) and call
``injector.fire(site, **scope)`` at their dispatch edges —

  * ``MultiModelServer.install_chaos(injector)`` wires the server, its
    ``PlanRegistry``, and its ``DeviceStreamPool`` in one call;
  * ``PlanRegistry.chaos`` / ``DeviceStreamPool.chaos`` are directly
    assignable for component-level tests.

Zero overhead when disabled: with no injector installed the hot path is a
single ``is not None`` check per dispatch edge (the edges are per
micro-batch / per chunk, never per flow), and the engine's bare ``plan()``
path — the regression-gated per-call number — carries no hook at all.

Sites and their scope keys (a spec field left ``None`` matches anything):

  ========================  =====================================
  site                      scope keys passed by the hooks
  ========================  =====================================
  ``"plan_call"``           ``model``, ``backend``
  ``"plan_build"``          ``model``, ``backend``
  ``"stream_dispatch"``     ``stream`` (device-stream index)
  ========================  =====================================

Determinism: matching, occurrence counting, and the probabilistic draw
(one ``random.Random(seed)`` owned by the injector) all happen in
``fire()`` call order under one lock, so the same seed and the same call
sequence produce the identical fired-fault :meth:`schedule` — the
property the chaos test suite pins.
"""

from __future__ import annotations

import time

from repro_torch.analysis.sanitizer import make_lock

__all__ = ["FaultInjector", "FaultSpec", "InjectedFaultError",
           "SITES", "MODES"]

SITES = ("plan_call", "plan_build", "stream_dispatch")
MODES = ("raise", "hang", "slow")

# default stall for mode="slow" / mode="hang" when the spec leaves
# delay_ms unset: a slow call stutters, a hung call stalls long enough
# that any reasonable supervision/timeout fires first (tests pass a short
# explicit delay_ms instead — a true infinite hang would wedge the suite).
_SLOW_MS = 50.0
_HANG_MS = 30_000.0


class InjectedFaultError(RuntimeError):
    """The typed error an armed fault spec raises at its site. Carries the
    site and scope so handlers (and test assertions) can tell an injected
    fault from an organic one."""

    def __init__(self, site: str, scope: dict):
        self.site = site
        self.scope = dict(scope)
        detail = ", ".join(f"{k}={v!r}" for k, v in sorted(scope.items())
                           if v is not None)
        super().__init__(f"injected fault at {site} ({detail or 'any'})")


class FaultSpec:
    """One scoped fault plan. Built via :meth:`FaultInjector.inject`; the
    mutable counters are owned by the injector's lock."""

    __slots__ = ("site", "model", "backend", "stream", "mode", "after",
                 "count", "probability", "delay_ms", "error",
                 "matched", "fired")

    def __init__(self, site: str, *, model=None, backend=None, stream=None,
                 mode: str = "raise", after: int = 1, count: int | None = 1,
                 probability: float = 1.0, delay_ms: float | None = None):
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r}; expected one "
                             f"of {SITES}")
        if mode not in MODES:
            raise ValueError(f"unknown fault mode {mode!r}; expected one "
                             f"of {MODES}")
        if after < 1:
            raise ValueError(f"after is the 1-based Nth matching "
                             f"occurrence; got {after}")
        if count is not None and count < 1:
            raise ValueError(f"count must be ≥ 1 or None (persistent); "
                             f"got {count}")
        self.site = site                # immutable after construction
        self.model = model              # immutable after construction
        self.backend = backend          # immutable after construction
        self.stream = stream            # immutable after construction
        self.mode = mode                # immutable after construction
        self.after = int(after)         # immutable after construction
        self.count = count              # immutable after construction
        self.probability = float(probability)   # immutable
        if delay_ms is None:
            delay_ms = _HANG_MS if mode == "hang" else _SLOW_MS
        self.delay_ms = float(delay_ms)          # immutable
        self.error = None               # optional raise payload; immutable
        self.matched = 0                # guarded-by: _lock
        self.fired = 0                  # guarded-by: _lock

    # holds: _lock (the owning injector's — counters read/written under it)
    def _matches(self, scope: dict) -> bool:
        return ((self.model is None or scope.get("model") == self.model)
                and (self.backend is None
                     or scope.get("backend") == self.backend)
                and (self.stream is None
                     or scope.get("stream") == self.stream))

    def describe(self) -> dict:
        """Schema-stable spec description (counters read by the owner)."""
        return {"site": self.site, "model": self.model,
                "backend": self.backend, "stream": self.stream,
                "mode": self.mode, "after": self.after, "count": self.count,
                "probability": self.probability, "delay_ms": self.delay_ms}


class FaultInjector:
    """Seeded, scoped, deterministic fault injection (module docstring).

    Typical use::

        inj = FaultInjector(seed=7)
        # 2nd-and-every-later plan call for "ids" on its kernel path fails
        inj.inject("plan_call", model="ids", backend="kernel",
                   mode="raise", after=2, count=None)
        server.install_chaos(inj)

    ``fire()`` is the hook the serving components call; user code never
    calls it directly.
    """

    def __init__(self, seed: int = 0):
        import random
        self.seed = seed
        self._rng = random.Random(seed)   # guarded-by: _lock
        self._lock = make_lock("chaos._lock")
        self._specs: list[FaultSpec] = []     # guarded-by: _lock
        self._schedule: list[dict] = []       # guarded-by: _lock
        self._fired_total = 0                 # guarded-by: _lock
        # arm flag: a plain bool read on the hot path (GIL-atomic; a racing
        # disarm may let one in-flight fire through, which is fine — the
        # injector is test/bench machinery, not a safety interlock)
        self.armed = True

    # -- authoring -----------------------------------------------------------

    def inject(self, site: str, *, model: str | None = None,
               backend: str | None = None, stream: int | None = None,
               mode: str = "raise", after: int = 1, count: int | None = 1,
               probability: float = 1.0, delay_ms: float | None = None,
               error: BaseException | None = None) -> FaultSpec:
        """Register one scoped fault plan; returns the spec.

        Args:
            site: one of :data:`SITES`.
            model / backend / stream: scope filters — ``None`` matches any.
            mode: ``"raise"`` raises :class:`InjectedFaultError` (or
                ``error``), ``"slow"`` sleeps ``delay_ms`` then proceeds,
                ``"hang"`` is a long bounded stall (default 30 s — pass a
                short ``delay_ms`` in tests).
            after: the fault arms from the Nth MATCHING occurrence
                (1-based); earlier occurrences pass through.
            count: how many times it fires once armed; ``None`` =
                persistent (every matching occurrence from ``after`` on).
            probability: chance an armed occurrence actually fires, drawn
                from the injector's seeded RNG (deterministic per seed).
            delay_ms: stall length for ``slow``/``hang``.
            error: optional exception instance to raise instead of
                :class:`InjectedFaultError` (``raise`` mode only).
        """
        spec = FaultSpec(site, model=model, backend=backend, stream=stream,
                         mode=mode, after=after, count=count,
                         probability=probability, delay_ms=delay_ms)
        spec.error = error
        with self._lock:
            self._specs.append(spec)
        return spec

    def clear(self) -> None:
        """Drop every spec (fired-schedule history is kept — determinism
        assertions compare full histories)."""
        with self._lock:
            self._specs.clear()

    # -- the hook ------------------------------------------------------------

    def fire(self, site: str, **scope) -> None:
        """Component hook: evaluate every spec against this occurrence and
        act. Matching/counting/drawing happens under the lock; the ACTION
        (sleep or raise) happens outside it so a stalled fault cannot
        serialize unrelated hooks."""
        if not self.armed:
            return
        acting: list[FaultSpec] = []
        with self._lock:
            for spec in self._specs:
                if spec.site != site or not spec._matches(scope):
                    continue
                spec.matched += 1
                if spec.matched < spec.after:
                    continue
                if spec.count is not None and spec.fired >= spec.count:
                    continue
                if (spec.probability < 1.0
                        and self._rng.random() >= spec.probability):
                    continue
                spec.fired += 1
                self._fired_total += 1
                self._schedule.append({
                    "site": site, "mode": spec.mode,
                    "occurrence": spec.matched,
                    "model": scope.get("model"),
                    "backend": scope.get("backend"),
                    "stream": scope.get("stream"),
                })
                acting.append(spec)
        for spec in acting:
            if spec.mode in ("slow", "hang"):
                time.sleep(spec.delay_ms / 1e3)
            if spec.mode == "raise":
                raise (spec.error if spec.error is not None
                       else InjectedFaultError(site, scope))

    # -- introspection -------------------------------------------------------

    def schedule(self) -> list[dict]:
        """Every fired fault, in fire order — the deterministic record the
        same-seed-same-schedule test compares."""
        with self._lock:
            return [dict(e) for e in self._schedule]

    def stats(self) -> dict:
        """The ``health.chaos`` section of the server stats schema."""
        with self._lock:
            return {
                "installed": True,
                "seed": self.seed,
                "armed": self.armed,
                "fired": self._fired_total,
                "specs": [dict(s.describe(), matched=s.matched,
                               fired=s.fired) for s in self._specs],
            }
