"""Suppression fixture for the port's lint: justified suppressions are
silent; a bare ``disable=`` (no written reason) is itself a PG000 finding
— but the suppression is still honored, so the PG000 is the ONLY finding
here."""

import threading


class S:
    def __init__(self):
        self._lock = threading.Lock()

    def justified_inline(self, y):
        with self._lock:
            return y.cpu()  # pegasus-lint: disable=PG001 a CPU tensor by construction, no GPU wait

    def justified_standalone(self, y):
        with self._lock:
            # pegasus-lint: disable=PG001 shutdown path, no waiters by design
            return y.item()

    def justified_block(self, y):
        # pegasus-lint: disable-block=PG001 teardown: single-threaded, nothing contends
        with self._lock:
            a = y.cpu()
            return a.numpy()

    def bare_reason_missing(self, y):
        with self._lock:
            return y.tolist()  # pegasus-lint: disable=PG001
