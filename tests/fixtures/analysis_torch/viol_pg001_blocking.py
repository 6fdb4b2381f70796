"""Seeded PG001 violations for the port's receiver-sensitive blocking table
(queue.Queue.get/put, threading.Event.wait) — lint fixture, parsed by
tests, never imported.

Lines carrying a ``# VIOLATION PGxxx`` marker are asserted (by exact line
number) to be flagged; everything else must stay clean — in particular
``dict.get(key)``, a PLURAL container of queues, and ``Condition.wait()``
(which releases the lock while parked).
"""

import queue
import threading


class Mailroom:
    def __init__(self):
        self._lock = threading.Lock()
        self.work_queue = queue.Queue()
        self.inbox = queue.Queue()
        self.done_event = threading.Event()
        self.ready = threading.Event()
        self._queues = {}
        self._cond = threading.Condition(self._lock)

    def drain_under_lock(self):
        with self._lock:
            item = self.work_queue.get()  # VIOLATION PG001
            self.inbox.put(item)  # VIOLATION PG001
        return item

    def wait_under_lock(self):
        with self._lock:
            self.done_event.wait()  # VIOLATION PG001
            self.ready.wait(timeout=1.0)  # VIOLATION PG001

    def bare_q_under_lock(self, q):
        with self._lock:
            return q.get()  # VIOLATION PG001

    def clean_paths(self, name):
        with self._lock:
            # dict.get(key) takes a positional arg: not a blocking Queue.get
            q = self._queues.get(name)
            # plural receiver = a container OF queues, not a queue itself
            self._queues.setdefault(name, q)
            # Condition.wait releases the lock while parked — the one
            # legitimate way to sleep under a lock
            self._cond.wait(timeout=0.01)
        # queue ops OUTSIDE the lock are ordinary blocking calls: fine
        self.work_queue.put(name)
        return self.work_queue.get()
