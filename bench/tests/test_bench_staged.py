"""The reader of the pinned stage's share of the bytes copied to the
device, on hand-made counters and on runs of the harness: a CPU plan stages
nothing, and an older program without the counter reads nothing."""

from __future__ import annotations

import importlib.util
import types

import pytest

from bench.harness import run_cell
from conftest import ROOT, SMALL

KW = dict(t_start=0.0, device="cpu", overrides=SMALL, check_flows=20_000, warm_s=0.3)


def _read(s0, s1):
    spec = importlib.util.spec_from_file_location(
        "m_h2d_staged_share", ROOT / "bench" / "metrics" / "h2d_staged_share.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(types.SimpleNamespace(serving=(s0, s1)))


@pytest.mark.parametrize("s0, s1, want", [
    ({"h2d_staged_bytes": 100, "h2d_pageable_bytes": 7},
     {"h2d_staged_bytes": 64_100, "h2d_pageable_bytes": 7}, 1.0),
    ({"h2d_staged_bytes": 0, "h2d_pageable_bytes": 0},
     {"h2d_staged_bytes": 300, "h2d_pageable_bytes": 100}, 0.75),
    # staged nothing: a CPU plan, or nothing served
    ({"h2d_staged_bytes": 0, "h2d_pageable_bytes": 0},
     {"h2d_staged_bytes": 0, "h2d_pageable_bytes": 16_000}, None),
    ({"h2d_staged_bytes": 5, "h2d_pageable_bytes": 5},
     {"h2d_staged_bytes": 5, "h2d_pageable_bytes": 5}, None),
    # an older program keeps neither counter, or only the pageable one
    ({"flows_served": 0}, {"flows_served": 10}, None),
    ({"h2d_pageable_bytes": 0}, {"h2d_pageable_bytes": 160}, None),
])
def test_share_of_hand_made_counters(s0, s1, want):
    assert _read(s0, s1) == want


def test_a_cpu_plan_stages_nothing_and_reports_no_share():
    r = run_cell("cnn-l.bulk", 2**31 + 21, 1.0, True, **KW)
    assert r["correct"]
    assert "h2d_staged_share" not in r["metrics"]
    assert r["metrics"]["h2d_pageable_bytes_per_flow"]["value"] == 496.0


def test_a_program_without_the_staged_counter_reads_as_before(monkeypatch):
    from repro_torch.launch.serve import MultiModelServer

    stats = MultiModelServer.stats

    def older(self):
        st = stats(self)
        del st["serving"]["h2d_staged_bytes"]
        return st

    monkeypatch.setattr(MultiModelServer, "stats", older)
    r = run_cell("mlp-b.bulk", 2**31 + 22, 1.0, True, **KW)
    assert r["correct"]
    assert set(r["metrics"]) == {"flows_per_batch.bulk", "launches_per_kflow",
                                 "h2d_pageable_bytes_per_flow"}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["mlp-b.bulk", "cnn-l.bulk"])
def test_on_the_card_every_byte_goes_through_the_stage(card, workload):
    r = run_cell(workload, 2**31 + 23, 3.0, True, t_start=0.0, device="cuda", warm_s=0.5)
    assert r["correct"]
    assert r["metrics"]["h2d_staged_share"]["value"] == 1.0
    assert r["metrics"]["h2d_pageable_bytes_per_flow"]["value"] == 0.0
