"""The reader of the share of dispatched chunks that crossed the plan
boundary once each way, on hand-made counters and on runs of the harness:
a CPU run and an older program without the counter read nothing, and a
traced run on the card reads a share of at least 0.99 in every cell."""

from __future__ import annotations

import importlib.util
import types

import pytest

from bench.harness import run_cell
from conftest import ROOT, SMALL

KW = dict(t_start=0.0, device="cpu", overrides=SMALL, check_flows=20_000, warm_s=0.3)


def _read(s0, s1, trace=True):
    spec = importlib.util.spec_from_file_location(
        "m_direct_chunk_share", ROOT / "bench" / "metrics" / "direct_chunk_share.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(types.SimpleNamespace(serving=(s0, s1), trace={} if trace else None))


@pytest.mark.parametrize("s0, s1, want", [
    ({"batches_dispatched": 10, "chunks_direct": 4},
     {"batches_dispatched": 1010, "chunks_direct": 1004}, 1.0),
    ({"batches_dispatched": 0, "chunks_direct": 0},
     {"batches_dispatched": 400, "chunks_direct": 300}, 0.75),
    ({"batches_dispatched": 0, "chunks_direct": 0},
     {"batches_dispatched": 8, "chunks_direct": 0}, 0.0),
    # dispatched no batch
    ({"batches_dispatched": 5, "chunks_direct": 5},
     {"batches_dispatched": 5, "chunks_direct": 5}, None),
    # an older program keeps no such counter
    ({"batches_dispatched": 0}, {"batches_dispatched": 10}, None),
])
def test_share_of_hand_made_counters(s0, s1, want):
    assert _read(s0, s1) == want


def test_no_device_trace_reads_nothing():
    assert _read({"batches_dispatched": 0, "chunks_direct": 0},
                 {"batches_dispatched": 10, "chunks_direct": 10}, trace=False) is None


def test_a_cpu_run_and_an_older_program_report_no_share(monkeypatch):
    r = run_cell("mlp-b.bulk", 2**31 + 51, 1.0, True, **KW)
    assert r["correct"]
    assert "direct_chunk_share" not in r["metrics"]
    from repro_torch.launch.serve import MultiModelServer

    stats = MultiModelServer.stats

    def older(self):
        st = stats(self)
        del st["serving"]["chunks_direct"]
        return st

    monkeypatch.setattr(MultiModelServer, "stats", older)
    r = run_cell("mlp-b.bulk", 2**31 + 52, 1.0, True, **KW)
    assert r["correct"]
    assert "direct_chunk_share" not in r["metrics"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["mlp-b.bulk", "cnn-l.bulk", "rnn-b.bulk"])
def test_on_the_card_a_traced_run_reads_the_share(card, workload):
    r = run_cell(workload, 2**31 + 53, 3.0, True, t_start=0.0, device="cuda", warm_s=0.5)
    assert r["correct"]
    assert r["metrics"]["direct_chunk_share"]["value"] >= 0.99
