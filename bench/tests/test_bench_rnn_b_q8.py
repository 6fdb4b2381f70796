"""RNN-B on the int8 backend: the configuration ``rnn-b-q8`` (the same model
module as ``rnn-b``, served on ``kernel_q8``), its int8 reference against
the port, the three controls the limit is held against (int4 tables,
float32 tables, bfloat16), a run of ``rnn-b-q8.bulk`` through the harness,
and the reader of the int8 bank kernel's roofline share."""

from __future__ import annotations

import importlib.util
import types

import pytest
import torch

from bench.harness import Cell, run_cell
from conftest import ROOT, SMALL
from q8_controls import control_gaps, quantize_int4

CELL = "rnn-b-q8.bulk"
KW = dict(t_start=0.0, overrides=SMALL, check_flows=20_000, warm_s=0.3)
SEED = 2**31 + 47
# each control misses the int8 reference by at least this many limits
MARGIN = 100


def _drawn(seed: int = SEED):
    cell = Cell(CELL, overrides=SMALL)
    cfg, model = cell.config, cell.model
    inputs = tuple(torch.as_tensor(a) for a in model.flows(cfg, seed))
    return cell, model.draw(cfg, inputs, seed), inputs


def _reader():
    spec = importlib.util.spec_from_file_location(
        "m_q8_bank_roofline", ROOT / "bench" / "metrics" / "q8_bank_roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_configuration_is_rnn_b_on_int8_tables():
    """``rnn-b-q8`` shares ``rnn-b``'s module and published banks and asks
    for int8 tables: the harness hands ``int8=True`` to its reference and
    its work."""
    cell, drawn, _ = _drawn()
    plain = Cell("rnn-b.bulk", overrides=SMALL)
    assert cell.int8 and not plain.int8
    assert cell.model.__name__ == plain.model.__name__
    assert cell.config["backend"] == "kernel_q8" and cell.config["reduced"] == []
    assert {k: v for k, v in cell.config.items() if k not in ("name", "backend", "precision",
                                                              "assumed", "defined_at")} == {
        k: v for k, v in plain.config.items() if k not in ("name", "backend", "precision",
                                                           "assumed", "defined_at")}
    geom = lambda b: (b.k, b.v, b.lut.shape[1], b.lut.shape[2])
    assert [geom(b) for b in drawn["x"]] == [(2, 1, 256, 24)] * 8
    assert [geom(b) for b in drawn["h"]] == [(24, 1, 256, 24)] * 7
    assert geom(drawn["out"]) == (24, 1, 256, 3)


def test_kernel_q8_equals_the_int8_reference_at_the_published_widths():
    """The port's ``kernel_q8`` plan (the int8 kernel's plain version on the
    CPU) gives the int8 reference's logits to the bit, and those differ from
    the float32 tables' logits."""
    from repro_torch.engine import build_plan

    cell, drawn, inputs = _drawn()
    plan = build_plan(cell.model.program_model(cell.config, drawn), backend="kernel_q8",
                      device="cpu", audit="off")
    got = plan(*inputs)
    assert torch.equal(got, cell.model.reference(cell.config, drawn, inputs, int8=True))
    assert not torch.equal(got, cell.model.reference(cell.config, drawn, inputs))


def test_int4_codes_keep_fifteen_levels_a_group():
    """At most 15 distinct values a group, the largest magnitude kept."""
    lut = torch.randn((3, 256, 24), generator=torch.Generator().manual_seed(0))
    q = quantize_int4(lut)
    for k in range(3):
        assert torch.unique(q[k]).numel() <= 15
        assert torch.isclose(q[k].abs().max(), lut[k].abs().max())


def test_a_cpu_run_of_the_cell_is_correct_and_every_control_is_not():
    """``rnn-b-q8.bulk`` through ``run_cell`` on the CPU reads 0.0; the
    int4 tables, the float32 tables and the bfloat16 reference each miss
    the int8 reference by at least ``MARGIN`` times the limit. Traced, the
    roofline readers find no device trace on the CPU and stay silent."""
    r = run_cell(CELL, SEED, 1.0, False, device="cpu", control=True, **KW)
    limit = r["check"]["logit_gap"]["limit"]
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    chk = r["detail"]["check"]
    assert chk["logit_gap"] == 0.0 and chk["requests"] > 0
    assert chk["control_gap"] > MARGIN * limit
    cell, drawn, inputs = _drawn()
    gaps = control_gaps(cell, drawn, inputs)
    assert set(gaps) == {"int4", "f32_tables", "bfloat16"}
    assert all(g > MARGIN * limit for g in gaps.values()), gaps
    r = run_cell(CELL, SEED + 1, 1.0, True, device="cpu", **KW)
    assert r["correct"]
    assert "q8_bank_roofline" not in r["metrics"]
    assert r["metrics"]["launches_per_kflow"]["value"] == 0.0     # plain versions


def test_reader_of_hand_made_traces():
    """The bound over the ``fuzzy_lut_q8`` kernels' time alone; None
    without a trace, without flows, or without an int8 kernel."""
    from bench.metrics_util import bound_s

    cell, drawn, _ = _drawn()

    def ctx(by_name, flows=1_000_000):
        return types.SimpleNamespace(
            trace=None if by_name is None else {"flows": flows, "by_name": by_name},
            work=lambda f: cell.model.work(cell.config, drawn, f, True))

    read = _reader().read
    names = {"void fuzzy_lut_q8_kernel<true>(float const*, int const*)": 0.3,
             "void fuzzy_lut_q8_kernel<false>(float const*, int const*)": 0.1,
             "void at::native::elementwise_kernel<128, 2>": 0.2,
             "Memcpy HtoD (Pinned -> Device)": 0.05}
    want = 100.0 * bound_s(ctx(names), 1_000_000) / 0.4
    assert read(ctx(names)) == pytest.approx(want) and 0.0 < want < 100.0
    assert read(ctx({k: v for k, v in names.items() if "q8" not in k})) is None
    assert read(ctx(names, flows=0)) is None
    assert read(ctx(None)) is None


@pytest.mark.cuda
def test_a_traced_run_on_the_card_runs_the_int8_kernel(card):
    """On the card every batch replays one graph of 16 ``fuzzy_lut_q8``
    launches; the trace shows the int8 kernel and no float32 one, and the
    roofline share lies in (0, 100]."""
    r = run_cell(CELL, SEED + 2, 3.0, True, t_start=0.0, device="cuda", warm_s=0.5)
    assert r["correct"], r["check"]
    assert r["check"]["logit_gap"]["value"] == 0.0
    names = [n for n, _ in r["breakdown"]["device_ops"]]
    assert any("fuzzy_lut_q8" in n for n in names)
    assert not any("fuzzy_lut_f32" in n for n in names)
    m = {k: v["value"] for k, v in r["metrics"].items()}
    per_batch = m["flows_per_batch.bulk"] / 1000.0
    assert m["launches_per_kflow"] * per_batch == pytest.approx(16, rel=0.01)
    assert 0.0 < m["q8_bank_roofline"] <= 100.0
