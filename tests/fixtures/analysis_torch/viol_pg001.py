"""Seeded PG001 violations for the port's lint — fixture, parsed by tests,
never imported.

Lines carrying a ``# VIOLATION PGxxx`` marker are asserted (by exact line
number) to be flagged; everything else must stay clean.
"""

import threading
import time

import torch


class Server:
    def __init__(self):
        self._lock = threading.Lock()

    def build_under_lock(self, model):
        with self._lock:
            plan = build_plan(model)  # VIOLATION PG001
        return plan

    def sleep_under_lock(self):
        with self._lock:
            time.sleep(0.1)  # VIOLATION PG001

    def block_under_lock(self, t, fut):
        with self._lock:
            t.join()  # VIOLATION PG001
            return fut.result()  # VIOLATION PG001

    def host_syncs_under_lock(self, y, event, stream):
        with self._lock:
            host = y.cpu()  # VIOLATION PG001
            n = y.sum().item()  # VIOLATION PG001
            arr = host.numpy()  # VIOLATION PG001
            rows = y.tolist()  # VIOLATION PG001
            torch.cuda.synchronize()  # VIOLATION PG001
            event.synchronize()  # VIOLATION PG001
            stream.synchronize()  # VIOLATION PG001
        return n, arr, rows

    def clean_paths(self, names, plan, x):
        label = ", ".join(names)
        with self._lock:
            # str.join on a literal separator is formatting, not blocking
            tag = " | ".join(names)
            # a launch or a graph replay enqueues work and returns
            y = plan(x)
        out = y.cpu().numpy()  # the sync OUTSIDE the lock: fine
        return label, tag, out
