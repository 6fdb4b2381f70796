"""Each pytest-xdist worker runs torch on its share of the host's cores
(``tests/torch_threads.py``), and a process outside xdist keeps torch's
default."""

import torch_threads  # noqa: F401  (this worker's share of the cores)

import os
import pathlib
import subprocess
import sys

import pytest
import torch

TESTS = pathlib.Path(__file__).resolve().parent


def test_this_worker_runs_torch_on_at_most_its_share_of_the_cores():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    assert torch.get_num_threads() <= max(1, os.cpu_count() // workers)


@pytest.mark.parametrize("workers", [None, 6])
def test_the_share_is_set_at_import_and_only_lowers_the_default(workers):
    """In a fresh process: torch's default before the import, and the
    threads after it."""
    env = {k: v for k, v in os.environ.items() if k != "PYTEST_XDIST_WORKER_COUNT"}
    if workers is not None:
        env["PYTEST_XDIST_WORKER_COUNT"] = str(workers)
    code = ("import torch; d = torch.get_num_threads(); import torch_threads; "
            "print(d, torch.get_num_threads())")
    out = subprocess.run([sys.executable, "-c", code], cwd=TESTS, env=env, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    default, threads = map(int, out.split())
    share = max(1, os.cpu_count() // (workers or 1))
    assert threads == min(default, share)
