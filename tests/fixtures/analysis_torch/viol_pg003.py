"""Seeded PG003 violations for the port's lint — fixture, parsed by tests,
never imported. The ranks come from the names the locks are created
under, looked up in the runtime sanitizer's LOCK_RANKS (registry._lock 0,
scheduler._lock 1, serve._ctr_lock 2); an unranked lock is never a
finding."""

import threading

from repro_torch.analysis.sanitizer import make_lock


class S:
    def __init__(self):
        self._lock = make_lock("registry._lock")
        self._ctr_lock = make_lock("serve._ctr_lock")
        self._space = threading.Condition(self._lock)
        self._side_lock = make_lock("plan._capture_lock")

    def declared_order(self):
        with self._lock:
            with self._ctr_lock:
                return 1

    def inverted_order(self):
        with self._ctr_lock:
            with self._lock:  # VIOLATION PG003
                return 2

    def condition_counts_as_its_lock(self):
        with self._ctr_lock:
            with self._space:  # VIOLATION PG003
                return 3

    def unranked_is_free(self):
        with self._ctr_lock:
            with self._side_lock:
                return 4
