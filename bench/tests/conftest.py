"""Shared fixtures of the benchmark's tests (run them with
``python -m pytest bench/tests``; the repository's own test run does not
collect them)."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# small sizes for the CPU: fewer flows drawn, a smaller pool, fewer checked
SMALL = {"flows_per_class": 120, "pool_flows": 2048}


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def root() -> Path:
    return ROOT
