"""The reader of the share of the drain loop's rounds finished after the
next round had been begun, on hand-made counters and on runs of the
harness: a CPU run and an older program without the counters read
nothing, and a traced run on the card reads a share: above 0 where each
round leaves the device work to hide (CNN-L, RNN-B), and 0 in MLP-B,
whose rounds have landed by the next pull."""

from __future__ import annotations

import importlib.util
import types

import pytest

from bench.harness import run_cell
from conftest import ROOT, SMALL

KW = dict(t_start=0.0, device="cpu", overrides=SMALL, check_flows=20_000, warm_s=0.3)


def _read(s0, s1, trace=True):
    spec = importlib.util.spec_from_file_location(
        "m_overlapped_round_share", ROOT / "bench" / "metrics" / "overlapped_round_share.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(types.SimpleNamespace(serving=(s0, s1), trace={} if trace else None))


@pytest.mark.parametrize("s0, s1, want", [
    ({"rounds": 10, "rounds_overlapped": 9}, {"rounds": 1010, "rounds_overlapped": 1009}, 1.0),
    ({"rounds": 0, "rounds_overlapped": 0}, {"rounds": 400, "rounds_overlapped": 300}, 0.75),
    ({"rounds": 0, "rounds_overlapped": 0}, {"rounds": 8, "rounds_overlapped": 0}, 0.0),
    # finished no round
    ({"rounds": 5, "rounds_overlapped": 4}, {"rounds": 5, "rounds_overlapped": 4}, None),
    # an older program keeps neither counter, or only one
    ({"flows_served": 0}, {"flows_served": 10}, None),
    ({"rounds": 0}, {"rounds": 10}, None),
])
def test_share_of_hand_made_counters(s0, s1, want):
    assert _read(s0, s1) == want


def test_no_device_trace_reads_nothing():
    assert _read({"rounds": 0, "rounds_overlapped": 0},
                 {"rounds": 10, "rounds_overlapped": 9}, trace=False) is None


def test_a_cpu_run_and_an_older_program_report_no_share(monkeypatch):
    r = run_cell("mlp-b.bulk", 2**31 + 41, 1.0, True, **KW)
    assert r["correct"]
    assert "overlapped_round_share" not in r["metrics"]
    from repro_torch.launch.serve import MultiModelServer

    stats = MultiModelServer.stats

    def older(self):
        st = stats(self)
        del st["serving"]["rounds"], st["serving"]["rounds_overlapped"]
        return st

    monkeypatch.setattr(MultiModelServer, "stats", older)
    r = run_cell("mlp-b.bulk", 2**31 + 42, 1.0, True, **KW)
    assert r["correct"]
    assert "overlapped_round_share" not in r["metrics"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["mlp-b.bulk", "cnn-l.bulk", "rnn-b.bulk"])
def test_on_the_card_a_traced_run_reads_the_share(card, workload):
    r = run_cell(workload, 2**31 + 43, 3.0, True, t_start=0.0, device="cuda", warm_s=0.5)
    assert r["correct"]
    # the reader reports a share only where the loop finished rounds
    share = r["metrics"]["overlapped_round_share"]["value"]
    if workload == "mlp-b.bulk":
        assert share == 0.0
    else:
        assert 0.0 < share <= 1.0
