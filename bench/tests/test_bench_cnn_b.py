"""CNN-B on the benchmark: the drawn banks' geometry, the plain reference
against the port's own paths, the bfloat16 control, the work count, a run
of ``cnn-b.bulk`` through the harness, and the readers of the window bank's
roofline share and of the per-bank kernels' rows a flow."""

from __future__ import annotations

import importlib.util
import types

import pytest
import torch

from bench.harness import Cell, run_cell
from bench.ref.bounds import HBM_BYTES_PER_S
from conftest import ROOT, SMALL

CELL = "cnn-b.bulk"
KW = dict(t_start=0.0, overrides=SMALL, check_flows=20_000, warm_s=0.3)
SEED = 2**31 + 61
BANK = "void fuzzy_lut_f32_bank_kernel<false, true>(float const*, int const*, float const*)"
STACK = "void fuzzy_lut_f32_stack_kernel<false, true>(float const*, int const*, float const*)"


def _drawn(seed: int = SEED):
    cell = Cell(CELL, overrides=SMALL)
    cfg, model = cell.config, cell.model
    inputs = tuple(torch.as_tensor(a) for a in model.flows(cfg, seed))
    return cell, model.draw(cfg, inputs, seed), inputs


def _reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"m_{name}", ROOT / "bench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_drawn_banks_have_the_published_geometry():
    """A window bank (1, 6, 4096, 16) without bias and its table clamped at
    0 (the conv's ReLU folded in); head banks (16, 1, 256, 24) and (24, 1,
    256, 3), each with a bias; the flows are ``seq [F, 8, 2]`` uint8."""
    cell, drawn, inputs = _drawn()
    assert inputs[0].dtype == torch.uint8 and inputs[0].shape[1:] == (8, 2)
    geom = lambda b: (b.k, b.v, b.lut.shape[1], b.lut.shape[2])
    assert geom(drawn["window"]) == tuple(cell.config["banks"]["window"]) == (1, 6, 4096, 16)
    assert geom(drawn["h"]) == tuple(cell.config["banks"]["h"]) == (16, 1, 256, 24)
    assert geom(drawn["out"]) == tuple(cell.config["banks"]["out"]) == (24, 1, 256, 3)
    assert drawn["window"].bias is None and bool((drawn["window"].lut >= 0).all())
    assert drawn["h"].bias is not None and drawn["out"].bias is not None
    rows = inputs[0].shape[0]
    assert [tuple(lv.shape) for lv in drawn["leaves"]] == [(6 * rows, 1), (rows, 16), (rows, 24)]
    assert cell.config["reduced"] == [] and cell.config["backend"] == "kernel"


@pytest.mark.parametrize("seed", [SEED, 2**33 + 5])
@pytest.mark.parametrize("backend", ["gather", "kernel"])
def test_reference_equals_the_port(backend, seed):
    """The port's plan (its gather path, and the kernels' plain versions,
    the head pair fused) gives the reference's logits to the bit."""
    from repro_torch.engine import build_plan

    cell, drawn, inputs = _drawn(seed)
    plan = build_plan(cell.model.program_model(cell.config, drawn), backend=backend,
                      device="cpu", audit="off")
    assert plan.family == "cnn" and len(plan.banks) == 3 and plan.fused_groups == 1
    assert plan.step_rows_per_flow(plan.banks[0]) == 6
    got = plan(*inputs)
    want = cell.model.reference(cell.config, drawn, inputs)
    assert got.shape == want.shape == (inputs[0].shape[0], cell.config["classes"])
    assert torch.equal(got, want)


def test_bfloat16_control_misses_the_limit():
    cell, drawn, inputs = _drawn()
    want = cell.model.reference(cell.config, drawn, inputs)
    low = cell.model.reference(cell.config, drawn, inputs, dtype=torch.bfloat16)
    assert float((low - want).abs().max()) / float(want.std()) > (
        10 * cell.config["check"]["logit_gap"])


def test_work_counts_the_window_bank_at_six_rows_and_the_fused_head_pair():
    """A flow adds the window bank's 6 rows (6 B in as float32, 16 out),
    the fused head pair's row (16 in, 3 out) and the pool's 6 × 16 adds;
    the tables and trees are counted once. ``window_bank_work`` is the
    window bank alone, its whole table counted."""
    cell, drawn, _ = _drawn()
    cfg = cell.config
    (b1, o1), (b2, o2) = (cell.model.work(cfg, drawn, f) for f in (1000, 2000))
    per_flow_bytes = 6 * (4 * 6 + 4 * 16) + (4 * 16 + 4 * 3)
    per_flow_ops = (6 * (12 + 16) + (16 * 8 + 16 * 24 + 24) + (24 * 8 + 24 * 3 + 3)
                    + 6 * 16)
    assert (b2 - b1, o2 - o1) == (1000 * per_flow_bytes, 1000 * per_flow_ops)
    nb, ops = cell.model.window_bank_work(cfg, 1000)
    assert (nb, ops) == (1000 * 6 * (4 * 6 + 4 * 16) + 8 * 4095 + 4096 * 16 * 4,
                         1000 * 6 * (12 + 16))


def test_a_cpu_run_of_the_cell_is_correct():
    """``cnn-b.bulk`` through ``run_cell`` on the CPU: correct, the control
    far outside the limit; traced, its per-layer metrics read what the CPU
    has (the kernels' plain versions launch nothing, and nothing replays a
    graph, so neither roofline nor the rows a flow read)."""
    r = run_cell(CELL, SEED, 1.0, False, device="cpu", control=True, **KW)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    chk = r["detail"]["check"]
    assert chk["logit_gap"] == 0.0 and chk["requests"] > 0
    assert chk["control_gap"] > 10 * r["check"]["logit_gap"]["limit"]
    assert {"flows_per_s", "setup_s"} <= set(r["metrics"])
    r = run_cell(CELL, SEED + 1, 1.0, True, device="cpu", **KW)
    assert r["correct"]
    assert set(r["metrics"]) == {"flows_per_batch.bulk", "launches_per_kflow",
                                 "h2d_pageable_bytes_per_flow"}
    assert r["metrics"]["launches_per_kflow"]["value"] == 0.0     # plain versions
    assert r["metrics"]["h2d_pageable_bytes_per_flow"]["value"] == 16.0


def _roofline_ctx(by_name, flows=1_000_000, model=None):
    cell = Cell(CELL, overrides=SMALL)
    return types.SimpleNamespace(
        cell=types.SimpleNamespace(model=cell.model if model is None else model),
        config=cell.config,
        trace=None if by_name is None else {"flows": flows, "by_name": by_name})


def test_window_bank_roofline_of_hand_made_traces():
    """The window bank's least time over the per-bank f32 entry's device
    time alone: the stacked entry, copies and torch's kernels do not count;
    None without a trace, flows, a kernel of that name (the parent's one
    name for both entries) or the configuration's helper."""
    read = _reader("window_bank_roofline").read
    least_s = (1_000_000 * 6 * (4 * 6 + 4 * 16) + 8 * 4095 + 4096 * 16 * 4) / HBM_BYTES_PER_S
    by_name = {BANK: 0.5, STACK: 0.25, "Memcpy HtoD (Pinned -> Device)": 0.1,
               "void at::native::index_elementwise_kernel<128, 4>": 0.2}
    assert read(_roofline_ctx(by_name)) == pytest.approx(100.0 * least_s / 0.5, rel=1e-12)
    two = {BANK: 0.3, BANK.replace("<false, true>", "<true, true>"): 0.2}
    assert read(_roofline_ctx(two)) == pytest.approx(100.0 * least_s / 0.5, rel=1e-12)
    assert read(_roofline_ctx(None)) is None
    assert read(_roofline_ctx(by_name, flows=0)) is None
    assert read(_roofline_ctx({STACK: 0.25, "void fuzzy_lut_f32_kernel<false, true>()": 0.5})) \
        is None
    assert read(_roofline_ctx(by_name, model=types.SimpleNamespace())) is None


@pytest.mark.parametrize("s0, s1, want", [
    ({"bank_rows": 600, "flows_served": 0}, {"bank_rows": 600 + 6 * 4096, "flows_served": 3000},
     6 * 4096 / 3000),
    # counted none: the CPU, or no replay in the window
    ({"bank_rows": 0, "flows_served": 0}, {"bank_rows": 0, "flows_served": 500}, None),
    # no flow served
    ({"bank_rows": 10, "flows_served": 7}, {"bank_rows": 10, "flows_served": 7}, None),
    # an older program keeps no such counter
    ({"flows_served": 0}, {"flows_served": 10}, None),
])
def test_bank_rows_per_flow_of_hand_made_counters(s0, s1, want):
    assert _reader("bank_rows_per_flow").read(types.SimpleNamespace(serving=(s0, s1))) == want


@pytest.mark.cuda
def test_a_traced_run_on_the_card_reads_the_window_bank(card):
    """On the card each batch replays one CNN-B graph: one per-bank launch
    at 6 rows a flow and one stacked launch, named apart in the trace."""
    r = run_cell(CELL, SEED + 2, 3.0, True, t_start=0.0, device="cuda", warm_s=0.5)
    assert r["correct"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    per_batch = m["flows_per_batch.bulk"] / 1000.0
    assert m["launches_per_kflow"] * per_batch == pytest.approx(2, rel=0.01)
    assert m["bank_rows_per_flow"] >= 6.0
    assert 0.0 < m["window_bank_roofline"] < 100.0
    assert m["direct_chunk_share"] == 1.0
    names = [n for n, _ in r["breakdown"]["device_ops"]]
    assert any("fuzzy_lut_f32_bank_kernel" in n for n in names)
    assert any("fuzzy_lut_f32_stack_kernel" in n for n in names)
