"""A run end to end on the CPU: the check decides ``correct``, a fault
planted under the timed path makes it false, the control is far outside
the limit, and the command refuses to run without a card or without the
program."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from bench.harness import Cell, forbidden_modules, run_cell
from conftest import ROOT, SMALL

KW = dict(t_start=0.0, device="cpu", overrides=SMALL, check_flows=20_000, warm_s=0.3)


@pytest.mark.parametrize("workload", ["mlp-b.bulk", "cnn-l.bulk", "mlp-b.stream",
                                      "mlp-b.burst"])
def test_a_sound_run_is_correct_and_the_control_is_not(workload):
    """Both cells, and the open-loop mixes (not cells yet) on the same path."""
    config, traffic = workload.split(".")
    mix = None if traffic == "bulk" else {"rate": 150}
    cell = Cell.of(config, traffic, overrides=SMALL, mix_overrides=mix)
    r = run_cell(cell, 2**31 + 5, 1.0, False, control=True, **KW)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r["check"]) == ["logit_gap", "unanswered"]
    chk = r["detail"]["check"]
    assert chk["logit_gap"] == 0.0 and chk["requests"] > 0
    assert chk["control_gap"] > 10 * r["check"]["logit_gap"]["limit"]
    assert "setup_s" in r["metrics"]


@pytest.mark.parametrize("workload", ["mlp-b.bulk", "cnn-l.bulk"])
def test_an_answer_altered_where_it_is_produced_fails(workload, monkeypatch):
    """The first row of every plan call's output is altered: ``correct``
    comes out false."""
    from repro_torch.engine.plan import ExecutionPlan

    orig = ExecutionPlan.__call__

    def altered(self, *a, **k):
        y = orig(self, *a, **k).clone()
        y[0] += 0.5
        return y

    monkeypatch.setattr(ExecutionPlan, "__call__", altered)
    r = run_cell(workload, 2**31 + 6, 1.0, False, **KW)
    assert not r["correct"]
    assert r["check"]["logit_gap"]["value"] > r["check"]["logit_gap"]["limit"]


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert "repro" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert {"repro", "jax"} <= set(forbidden_modules())


def test_a_run_loads_no_jax_nor_the_jax_package():
    """Every module a run imports, in a process of its own."""
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/src']\n"
            "from bench.harness import run_cell, forbidden_modules\n"
            "r = run_cell('mlp-b.bulk', 3, 0.5, True, t_start=0.0, device='cpu',\n"
            "             overrides={'flows_per_class': 60, 'pool_flows': 1024},\n"
            "             check_flows=5000, warm_s=0.2)\n"
            "assert r['correct']\n"
            "assert 'repro_torch' in sys.modules\n"
            "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _run_py(cwd, timeout=300):
    return subprocess.run([sys.executable, "bench/run.py", "--workload", "mlp-b.bulk",
                           "--seed", str(2**31 + 1), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=timeout)


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run_py(ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_no_result_with_only_the_benchmark(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run_py(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    out = _run_py(ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert set(r["metrics"]) == {"flows_per_s", "setup_s"}
    assert list(r)[-1] == "check"
