"""Seeded PG002 violations for the port's lint (the reference's fixture) —
parsed by tests, never imported."""

import threading


class Store:
    def __init__(self):
        self._lock = threading.Lock()
        self._items = {}  # guarded-by: _lock
        self.count = 0    # guarded-by: _lock

    def unguarded_read(self):
        return len(self._items)  # VIOLATION PG002

    def unguarded_write(self):
        self.count += 1  # VIOLATION PG002

    def guarded(self):
        with self._lock:
            self._items["k"] = 1
            self.count += 1
        return True

    # holds: _lock
    def helper_with_contract(self):
        return self._items.get("k")

    def condition_alias_counts(self):
        # _work/_space Conditions share _lock, so holding one IS holding it
        with self._work:
            return dict(self._items)
