"""The traffic generator and the flow pool repeat per seed and change
across seeds."""

from __future__ import annotations

import json

import numpy as np
import pytest

from bench import traffic
from bench.ref.synthetic_traffic import make_dataset

SEEDS = (2**31 + 3, 2**31 + 4)


def test_flows_repeat_per_seed_and_change_across_seeds():
    a, b, c = (make_dataset("peerrush", 50, seed=s) for s in (SEEDS[0], SEEDS[0], SEEDS[1]))
    for key in ("stats", "seq", "bytes"):
        assert np.array_equal(a.train[key], b.train[key])
        assert not np.array_equal(a.train[key], c.train[key])


@pytest.mark.parametrize("mix", ["bulk", "stream", "burst"])
def test_request_draws_repeat_per_seed(root, mix):
    m = json.loads((root / "bench" / "mixes" / f"{mix}.json").read_text())
    a = traffic.request_draws(m, np.random.default_rng([SEEDS[0], 1]), 500, 10_000)
    b = traffic.request_draws(m, np.random.default_rng([SEEDS[0], 1]), 500, 10_000)
    c = traffic.request_draws(m, np.random.default_rng([SEEDS[1], 1]), 500, 10_000)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[1], c[1])
    assert set(np.unique(a[0])) <= set(m["sizes"])
    assert a[1].max() + max(m["sizes"]) <= 10_000


@pytest.mark.parametrize("mix", ["stream", "burst"])
def test_open_schedule(root, mix):
    """Due times repeat per seed, keep the mean rate, and (bursts) fall only
    inside the on-phases. The mixes leave the rate to the cell's change."""
    m = {**json.loads((root / "bench" / "mixes" / f"{mix}.json").read_text()), "rate": 3600}
    a = traffic.open_schedule(m, np.random.default_rng(SEEDS[0]), 10.0)
    b = traffic.open_schedule(m, np.random.default_rng(SEEDS[0]), 10.0)
    c = traffic.open_schedule(m, np.random.default_rng(SEEDS[1]), 10.0)
    assert np.array_equal(a, b) and not np.array_equal(a[:100], c[:100])
    assert np.all(np.diff(a) >= 0) and a[0] >= 0 and a[-1] < 10.0
    assert abs(len(a) / (10.0 * m["rate"]) - 1) < 0.05
    if m["arrivals"] == "onoff":
        period = m["on_s"] + m["off_s"]
        assert np.all(np.mod(a, period) < m["on_s"] + 1e-9)


def test_log_grows_in_chunks():
    log = traffic.Log()
    for i in range(40_000):
        assert log.new(i % 7, i, float(i), float(i), i % 2 == 0) == i
    log.set("done", 39_999, 1.0)
    assert log.view("size").shape == (40_000,)
    assert np.isnan(log.view("done")[:-1]).all() and log.view("done")[-1] == 1.0
    assert log.view("keep").sum() == 20_000
