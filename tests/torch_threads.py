"""This test process's share of the host's cores for torch's intra-op threads.

Every ``tests/test_torch_*.py`` imports this module. Under pytest-xdist
each worker imports every test module before it runs any test, so the share
holds for the worker's whole run, the JAX package's tests included: the
host's cores over ``PYTEST_XDIST_WORKER_COUNT`` workers, at least one.
Without xdist the share is every core, and torch keeps its default. Torch's
default is one thread per core in every worker, so six workers on eight
cores would run 48 threads that spend their time waiting for each other.
"""

import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
SHARE = max(1, (os.cpu_count() or 1) // WORKERS)

if torch.get_num_threads() > SHARE:
    torch.set_num_threads(SHARE)
