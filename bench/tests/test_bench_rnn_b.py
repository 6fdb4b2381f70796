"""RNN-B on the benchmark: the plain reference against the port's own paths
on the banks the benchmark draws, the bfloat16 control, a run of
``rnn-b.bulk`` through the harness, and the reader of the graphs' kernel
count."""

from __future__ import annotations

import importlib.util
import types

import pytest
import torch

from bench.harness import Cell, run_cell
from conftest import ROOT, SMALL

KW = dict(t_start=0.0, overrides=SMALL, check_flows=20_000, warm_s=0.3)
SEED = 2**31 + 31


def _drawn(seed: int = SEED):
    cell = Cell("rnn-b.bulk", overrides=SMALL)
    cfg, model = cell.config, cell.model
    inputs = tuple(torch.as_tensor(a) for a in model.flows(cfg, seed))
    return cell, model.draw(cfg, inputs, seed), inputs


def _read(s0, s1):
    spec = importlib.util.spec_from_file_location(
        "m_graph_kernels_per_kflow", ROOT / "bench" / "metrics" / "graph_kernels_per_kflow.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(types.SimpleNamespace(serving=(s0, s1)))


def test_the_drawn_window_has_the_published_banks():
    """Eight x-banks (2, 1, 256, 24), seven h-banks (24, 1, 256, 24) and an
    out-bank (24, 1, 256, 3); biases on x-bank 0, the h-banks and the
    out-bank only."""
    _, drawn, inputs = _drawn()
    assert inputs[0].dtype == torch.uint8 and inputs[0].shape[1:] == (8, 2)
    geom = lambda b: (b.k, b.v, b.lut.shape[1], b.lut.shape[2])
    assert [geom(b) for b in drawn["x"]] == [(2, 1, 256, 24)] * 8
    assert [geom(b) for b in drawn["h"]] == [(24, 1, 256, 24)] * 7
    assert geom(drawn["out"]) == (24, 1, 256, 3)
    assert [b.bias is not None for b in drawn["x"]] == [True] + [False] * 7
    assert all(b.bias is not None for b in drawn["h"]) and drawn["out"].bias is not None
    assert len(drawn["leaves"]) == 16


@pytest.mark.parametrize("backend", ["gather", "kernel", "kernel_q8"])
def test_reference_equals_the_port(backend):
    """The port's plan (its gather path, and the kernels' plain versions)
    gives the reference's logits to the bit; ``kernel_q8`` against the
    reference with its tables as int8 codes."""
    from repro_torch.engine import build_plan

    cell, drawn, inputs = _drawn()
    plan = build_plan(cell.model.program_model(cell.config, drawn), backend=backend,
                      device="cpu", audit="off")
    assert plan.family == "rnn" and len(plan.banks) == 16
    got = plan(*inputs)
    want = cell.model.reference(cell.config, drawn, inputs, int8=backend == "kernel_q8")
    assert got.shape == want.shape == (inputs[0].shape[0], cell.config["classes"])
    assert torch.equal(got, want)


def test_bfloat16_control_is_far_from_the_reference():
    cell, drawn, inputs = _drawn()
    want = cell.model.reference(cell.config, drawn, inputs)
    low = cell.model.reference(cell.config, drawn, inputs, dtype=torch.bfloat16)
    assert float((low - want).abs().max()) / float(want.std()) > (
        10 * cell.config["check"]["logit_gap"])


def test_work_counts_sixteen_banks_and_the_chain_adds():
    """The bound grows by the 16 banks' per-flow bytes and operations and
    the 7 × 24 chain adds a flow; the tables are counted once."""
    cell, drawn, _ = _drawn()
    (b1, o1), (b2, o2) = (cell.model.work(cell.config, drawn, f) for f in (1000, 2000))
    per_flow_bytes = 8 * (4 * 2 + 4 * 24) + 7 * (4 * 24 + 4 * 24) + (4 * 24 + 4 * 3)
    per_flow_ops = 8 * (2 * 8 + 2 * 24) + 7 * (24 * 8 + 24 * 24) + (24 * 8 + 24 * 3) + 7 * 24
    assert (b2 - b1, o2 - o1) == (1000 * per_flow_bytes, 1000 * per_flow_ops)


def test_a_cpu_run_of_the_cell_is_correct():
    """``rnn-b.bulk`` through ``run_cell`` on the CPU: correct, the control
    far outside the limit; traced, its per-layer metrics read what the CPU
    has (the kernels' plain versions launch nothing, and nothing replays a
    graph)."""
    r = run_cell("rnn-b.bulk", SEED, 1.0, False, device="cpu", control=True, **KW)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    chk = r["detail"]["check"]
    assert chk["logit_gap"] == 0.0 and chk["requests"] > 0
    assert chk["control_gap"] > 10 * r["check"]["logit_gap"]["limit"]
    assert {"flows_per_s", "setup_s"} <= set(r["metrics"])
    r = run_cell("rnn-b.bulk", SEED + 1, 1.0, True, device="cpu", **KW)
    assert r["correct"]
    assert set(r["metrics"]) == {"flows_per_batch.bulk", "launches_per_kflow",
                                 "h2d_pageable_bytes_per_flow"}
    assert r["metrics"]["launches_per_kflow"]["value"] == 0.0     # plain versions
    assert r["metrics"]["h2d_pageable_bytes_per_flow"]["value"] == 16.0


@pytest.mark.parametrize("s0, s1, want", [
    ({"graph_kernels": 100, "flows_served": 0},
     {"graph_kernels": 100 + 41 * 10, "flows_served": 20_000}, 20.5),
    # counted none: the CPU, or no replay in the window
    ({"graph_kernels": 0, "flows_served": 0}, {"graph_kernels": 0, "flows_served": 500}, None),
    # an older program keeps no such counter
    ({"flows_served": 0}, {"flows_served": 10}, None),
])
def test_reader_of_hand_made_counters(s0, s1, want):
    assert _read(s0, s1) == want


@pytest.mark.cuda
def test_a_traced_run_on_the_card_counts_the_chain(card):
    """On the card every batch replays one RNN-B graph: 16 launches of the
    port's kernel, and the kernels of the chain around them."""
    r = run_cell("rnn-b.bulk", SEED + 2, 3.0, True, t_start=0.0, device="cuda", warm_s=0.5)
    assert r["correct"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    per_batch = m["flows_per_batch.bulk"] / 1000.0
    assert m["launches_per_kflow"] * per_batch == pytest.approx(16, rel=0.01)
    assert m["graph_kernels_per_kflow"] * per_batch > 16
