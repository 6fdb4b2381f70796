"""Runtime concurrency sanitizer: lock-order + thread-affinity checks (a
copy of the JAX package's ``analysis/sanitizer.py`` kept inside the port,
with the lock hierarchy it checks against, :data:`LOCK_RANKS`).

It catches what a static lint cannot — lock orders composed ACROSS call
boundaries at runtime, and code running on the wrong thread.
Enabled by ``PEGASUS_SANITIZE=1`` (read at lock construction, i.e. server
construction — setting it for a test session is enough); disabled, the
factories return plain stdlib primitives with zero overhead.

``make_lock(name)`` is the drop-in the serving stack uses instead of
``threading.Lock()``/``RLock()``. Under the sanitizer it returns an
:class:`InstrumentedLock` that

* records the process-wide acquisition graph (edge ``A -> B`` whenever a
  thread acquires B while holding A) and raises :class:`LockOrderError`
  the moment an edge would close a cycle — the canonical deadlock shape
  (thread 1: A then B, thread 2: B then A) is reported on the SECOND
  acquisition, deterministically, whether or not the schedules actually
  interleave into a deadlock this run;
* checks every new edge against the declared hierarchy
  (:data:`LOCK_RANKS`) and raises on an inversion;
* raises on re-entry of a lock created with ``reentrant=False`` instead of
  deadlocking on it (the instrumented lock is internally an RLock, so
  silent re-entry would otherwise change semantics).

The lock implements the full ``threading.Condition`` owner protocol
(``_is_owned`` / ``_release_save`` / ``_acquire_restore``), so
``threading.Condition(make_lock(...))`` works unchanged — including the
held-stack bookkeeping across a ``wait()``'s release/reacquire.

:class:`ThreadAffinity` asserts "this code runs only on thread X": the
owning thread calls ``bind()``, any checkpoint calls ``assert_here()``.
Unbound (or sanitizer off) it never fires, so the assertions are free in
production. ``AsyncMultiModelServer``'s drain loop binds the dispatch
affinity; ``DeviceStreamPool`` binds one per worker and exposes
``assert_worker()``.
"""

from __future__ import annotations

import os
import threading

__all__ = [
    "LOCK_RANKS", "enabled", "make_lock", "InstrumentedLock", "LockOrderError",
    "ThreadAffinity", "ThreadAffinityError", "reset_lock_graph",
]

# The declared acquisition hierarchy, OUTER to INNER, keyed by the
# qualified name passed to make_lock(): a lock may be acquired while
# holding only locks of a lower rank (e.g. registry.stats() holding
# registry._lock while compile_stats() takes the plan counter lock is
# legal: rank 0 -> rank 5). Breaker state is queried under devices._lock
# in stream placement (3 -> 6) and never wraps another lock; the injector
# lock only guards spec matching and counting. Unranked names (the plan's
# graph-pool locks, the process-wide capture lock) get cycle detection only.
LOCK_RANKS = {
    "registry._lock": 0,
    "scheduler._lock": 1,
    "serve._ctr_lock": 2,
    "devices._lock": 3,
    "plan._replica_lock": 4,
    "plan._ctr.lock": 5,
    "health._lock": 6,
    "chaos._lock": 7,
}


def enabled() -> bool:
    """True when ``PEGASUS_SANITIZE`` is set to anything but ''/0."""
    return os.environ.get("PEGASUS_SANITIZE", "") not in ("", "0")


class LockOrderError(RuntimeError):
    """An acquisition closed a cycle or inverted the declared hierarchy."""


class ThreadAffinityError(RuntimeError):
    """Code bound to one thread executed on another."""


# process-wide acquisition graph: {held lock name: {acquired-next names}}.
# Guarded by a PLAIN lock — it must not instrument itself.
_graph: dict[str, set] = {}
_graph_lock = threading.Lock()
_tls = threading.local()


def reset_lock_graph() -> None:
    """Forget every recorded edge (test isolation: a fixture-built A->B
    edge must not poison later tests' graphs)."""
    with _graph_lock:
        _graph.clear()


def _held() -> list:
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


def _find_path(src: str, dst: str) -> list | None:
    """DFS path src -> ... -> dst through the edge graph (caller holds
    _graph_lock); None if unreachable."""
    stack, seen = [(src, [src])], {src}
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        for nxt in _graph.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


class InstrumentedLock:
    """RLock-backed lock that validates every acquisition's ordering."""

    def __init__(self, name: str, *, reentrant: bool = False):
        self.name = name
        self.reentrant = reentrant
        self._inner = threading.RLock()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        kind = "RLock" if self.reentrant else "Lock"
        return f"<InstrumentedLock {self.name} ({kind})>"

    # -- ordering checks ----------------------------------------------------

    def _check_order(self, held: list) -> None:
        distinct = [n for n in dict.fromkeys(held) if n != self.name]
        if not distinct:
            return
        with _graph_lock:
            # cycle first: does the graph already know a path name -> held?
            for h in distinct:
                path = _find_path(self.name, h)
                if path is not None:
                    raise LockOrderError(
                        f"lock-order cycle: acquiring {self.name!r} while "
                        f"holding {h!r}, but the recorded order is "
                        f"{' -> '.join(path)} (a thread that interleaves "
                        "these acquisitions deadlocks)")
            my_rank = LOCK_RANKS.get(self.name)
            for h in distinct:
                _graph.setdefault(h, set()).add(self.name)
                h_rank = LOCK_RANKS.get(h)
                if (my_rank is not None and h_rank is not None
                        and h_rank > my_rank):
                    raise LockOrderError(
                        f"hierarchy inversion: {self.name!r} (rank "
                        f"{my_rank}) acquired while holding {h!r} (rank "
                        f"{h_rank}); declared order is outer->inner by "
                        "ascending rank (rules.LOCK_RANKS)")

    # -- lock protocol ------------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        held = _held()
        if self.name in held:
            if not self.reentrant:
                raise LockOrderError(
                    f"non-reentrant lock {self.name!r} re-acquired by its "
                    "owning thread (this deadlocks a plain threading.Lock)")
            ok = self._inner.acquire(blocking, timeout)
        else:
            self._check_order(held)
            ok = self._inner.acquire(blocking, timeout)
        if ok:
            held.append(self.name)
        return ok

    def release(self) -> None:
        self._inner.release()
        held = _held()
        # drop the most recent entry for this lock
        for i in range(len(held) - 1, -1, -1):
            if held[i] == self.name:
                del held[i]
                break

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:  # pragma: no cover - parity with Lock API
        if self._inner.acquire(blocking=False):
            self._inner.release()
            return False
        return True

    # -- Condition owner protocol -------------------------------------------

    def _is_owned(self) -> bool:
        return self._inner._is_owned()

    def _release_save(self):
        # Condition.wait: fully release (all recursion levels) while parked
        state = self._inner._release_save()
        held = _held()
        count = held.count(self.name)
        _tls.held = [n for n in held if n != self.name]
        return (state, count)

    def _acquire_restore(self, saved) -> None:
        state, count = saved
        self._inner._acquire_restore(state)
        _held().extend([self.name] * count)


def make_lock(name: str, *, reentrant: bool = False):
    """The serving stack's lock factory: a plain ``Lock``/``RLock`` in
    production, an :class:`InstrumentedLock` under ``PEGASUS_SANITIZE=1``.

    ``name`` is the qualified name ranked in ``rules.LOCK_RANKS``
    (e.g. ``"scheduler._lock"``) — unranked names still get cycle
    detection, just not hierarchy checks."""
    if enabled():
        return InstrumentedLock(name, reentrant=reentrant)
    return threading.RLock() if reentrant else threading.Lock()


class ThreadAffinity:
    """Assert that checkpointed code runs only on the bound thread."""

    def __init__(self, name: str):
        self.name = name
        self._ident: int | None = None

    def bind(self) -> None:
        """Claim the current thread as the owner (no-op when the sanitizer
        is off, so production binds cost one env check)."""
        if not enabled():
            return
        self._ident = threading.get_ident()

    def release(self) -> None:
        self._ident = None

    @property
    def bound_ident(self) -> int | None:
        return self._ident

    def assert_here(self) -> None:
        """Raise unless on the bound thread (never fires while unbound)."""
        if self._ident is not None and threading.get_ident() != self._ident:
            raise ThreadAffinityError(
                f"{self.name}: expected thread {self._ident}, running on "
                f"{threading.get_ident()} ({threading.current_thread().name})")
