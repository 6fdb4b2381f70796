"""The port's plan audit (``repro_torch.analysis.planaudit``) against the
JAX package's, and its Hopper rules against the kernels' own planners.

* PGA101/102/105/106: the zoo's five families, built by the JAX package at
  fixture scale and carried over, give the reference's (rule, severity,
  site) list, with numeric metrics within rtol 1e-6.
* PGA103/104 price CUDA launches: they are held to ``plan_f32`` /
  ``plan_q8`` and their launch-shape helpers directly, at the zoo's
  geometries and at the published widths of rnn-h, the CNN-B heads, the
  AE stack and MLP-B (built with ``init_pegasus_bank``).
* ``build_plan(audit=...)``'s modes, the registry's lazy report and the
  memo key.
"""

from __future__ import annotations

import torch_threads  # noqa: F401  (this worker's share of the cores)

import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

from repro.analysis import planaudit as jaudit
from repro.analysis.zoo import build_family as jax_build_family
from repro.engine import build_plan as jax_build_plan
from repro_torch import interop
from repro_torch.analysis import rules as R
from repro_torch.analysis.planaudit import (AuditConfig, PlanAuditError, audit_plan,
                                            launch_prices)
from repro_torch.core.amm import init_pegasus_bank
from repro_torch.engine import PlanRegistry, build_plan, plan_for
from repro_torch.engine.plan import STATS
from repro_torch.kernels.fuzzy_lut import _lib, ops
from repro_torch.kernels.fuzzy_lut import quantized as Q
from repro_torch.kernels.fuzzy_lut.kernel import (SMEM_PER_BLOCK, f32_launch_shape,
                                                  plan_f32)
from test_torch_rnn_b import _rnn

FAMILIES = ("mlp", "rnn", "cnn", "cnn_l", "ae")
CARRIED_RULES = ("PGA101", "PGA102", "PGA105", "PGA106")


def _arrays(b) -> dict:
    return dict(features=np.asarray(b.trees.features),
                thresholds=np.asarray(b.trees.thresholds),
                centroids=np.asarray(b.trees.centroids), lut=np.asarray(b.lut),
                bias=None if b.bias is None else np.asarray(b.bias),
                group_size=b.group_size)


def _carry(family, peg):
    """The reference's pegasusified model in the port, on the CPU."""
    if family == "mlp":
        return interop.banks_from_arrays([_arrays(b) for b in peg], device="cpu")
    if family == "rnn":
        return interop.rnn_from_arrays([_arrays(b) for b in peg.x_banks],
                                       [_arrays(b) for b in peg.h_banks],
                                       _arrays(peg.out_bank), peg.window, device="cpu")
    if family == "cnn":
        return interop.cnn_from_arrays(
            _arrays(peg.window_bank), [_arrays(b) for b in peg.head_banks],
            None if peg.out_bias is None else np.asarray(peg.out_bias), peg.nam,
            peg.pool_windows, device="cpu")
    if family == "cnn_l":
        t = peg.emb_tree
        return interop.cnn_l_from_arrays(
            _arrays(peg.bank1), _arrays(peg.bank2),
            dict(features=np.asarray(t.features), thresholds=np.asarray(t.thresholds),
                 centroids=np.asarray(t.centroids)),
            np.asarray(peg.logit_lut), np.asarray(peg.bias), peg.index_bits, device="cpu")
    return interop.ae_banks_from_arrays([_arrays(b) for b in peg], peg.feat_mu,
                                        peg.feat_sigma, device="cpu")


@pytest.fixture(scope="module")
def zoo():
    """Each family built once by the JAX package (the reference zoo's
    fixture scale), planned on kernel_q8 by both packages."""
    out = {}
    for fam in FAMILIES:
        ref = jax_build_family(fam)
        out[fam] = {
            "ref": jax_build_plan(ref, backend="kernel_q8", audit="off"),
            "port": build_plan(_carry(fam, ref), backend="kernel_q8", device="cpu",
                               audit="off"),
        }
    return out


def _close(got, want, where):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _close(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (bool, str)) or want is None:
        assert got == want, where
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=where)


@pytest.mark.parametrize("family", FAMILIES)
def test_carried_rules_equal_reference(zoo, family):
    plans = zoo[family]
    got = audit_plan(plans["port"], AuditConfig(target="tofino2"))
    want = jaudit.audit_plan(plans["ref"], jaudit.AuditConfig(target="tofino2"))
    g = [f for f in got.findings if f.rule in CARRIED_RULES]
    w = [f for f in want.findings if f.rule in CARRIED_RULES]
    assert [(f.rule, f.severity, f.site) for f in g] == \
        [(f.rule, f.severity, f.site) for f in w]
    assert any(f.rule == "PGA106" for f in g)         # the target was priced
    for a, b in zip(g, w):
        _close(a.metrics, b.metrics, f"{a.rule} {a.site}")
        if a.rule in ("PGA105", "PGA106"):
            assert a.message == b.message
    assert got.summary["family"] == want.summary["family"]
    assert got.summary["num_banks"] == want.summary["num_banks"]
    assert got.summary["fused_groups"] == want.summary["fused_groups"]


@pytest.mark.parametrize("family", FAMILIES)
def test_hopper_rules_call_the_kernels_planners(zoo, family):
    """PGA103's rows per block and shared bytes are ``f32_launch_shape`` /
    ``launch_shape`` of the plan's own operands, at the rows the largest
    bucket gives, on 132 SMs for a CPU plan."""
    plan = zoo[family]["port"]
    rep = audit_plan(plan)
    notes = {f.site: f for f in rep.findings if f.rule == "PGA103"}
    steps = [*plan.fused_stacks,
             *(b for b in plan.banks
               if not any(b in s.banks for s in plan.fused_stacks))]
    assert len(notes) == len(steps)
    for f in notes.values():
        assert f.severity == "info" and f.metrics["n_sm"] == R.H100_SXM_SMS
        assert "H100 SXM" in f.metrics["sm_count_of"]
    for step in steps:
        fused = hasattr(step, "ks")
        site = next(s for s in notes if (s.startswith("stack") if fused else
                                         s == f"bank[{plan.banks.index(step)}]"))
        m = notes[site].metrics
        t = max(plan.buckets) * plan.step_rows_per_flow(step)
        assert m["rows"] == t
        if fused:
            ks, v, kmax, c, nmax = step.ks, step.v, *step.lut.shape[1:2], *step.lut.shape[2:]
            operands = (step.features, step.thr, step.lut_q8, step.scales, step.bias)
            n_out = step.n_out
        else:
            lay = step.layer
            ks, v, kmax, c, nmax = (lay.num_groups,), lay.group_size, lay.num_groups, \
                lay.num_centroids, lay.out_features
            operands, n_out = (step.features, step.thr, step.lut_q8, step.scales, None), nmax
        depth = int(np.log2(c))
        rows, grid, _, smem = f32_launch_shape(plan_f32(tuple(ks), v, depth, kmax), t, 132)
        assert (m["f32"]["rows_per_block"], m["f32"]["grid"], m["f32"]["smem_bytes"]) == \
            (rows, grid, smem)
        qp = Q.launch_plan(v, *operands, ks, n_out)
        rows, _, grid, _, smem = Q.launch_shape(qp, t, 132)
        assert (m["q8"]["rows_per_block"], m["q8"]["grid"], m["q8"]["smem_bytes"]) == \
            (rows, grid, smem)
        assert (m["q8"]["slot_bytes"], m["q8"]["stages"], m["q8"]["fills"]) == \
            (qp.slot_bytes, len(qp.stages), len(qp.fills))
        assert smem <= SMEM_PER_BLOCK


# ---------------------------------------------------------------------------
# PGA104 at the published widths (PERF.md §6's slow int8 launches)
# ---------------------------------------------------------------------------


def _bank(k, v, depth, n, seed, bias=True):
    rng = np.random.default_rng(seed)
    calib = rng.integers(0, 256, size=(1024, k * v)).astype(np.float32)
    w = torch.as_tensor(rng.normal(size=(k, v, n)).astype(np.float32))
    b = rng.normal(size=n).astype(np.float32) if bias else None
    return init_pegasus_bank(lambda c: torch.einsum("kcv,kvn->kcn", c / 255.0, w), calib,
                             group_size=v, depth=depth, bias=b, device="cpu")


@pytest.fixture(scope="module")
def published():
    """Banks at published widths: (K, v, depth, N) as PERF.md §4 lists."""
    return {
        "rnn-h": [_bank(24, 1, 8, 24, 1)],
        "cnn-b heads": [_bank(16, 1, 8, 24, 2), _bank(24, 1, 8, 3, 3)],
        "ae": [_bank(24, 1, 8, 12, 4), _bank(12, 1, 8, 3, 5), _bank(3, 1, 8, 12, 6),
               _bank(12, 1, 8, 24, 7)],
        "mlp-b": [_bank(8, 2, 6, 32, 8), _bank(16, 2, 6, 32, 9), _bank(16, 2, 6, 32, 10),
                  _bank(16, 2, 6, 3, 11)],
    }


def _bytewise_tiles(qp: Q.Q8Plan) -> list:
    return [s for s in qp.stages
            if s.flags & Q.LUT and not s.flags & Q.FULLROW and not s.bulk & Q.B_LUT]


@pytest.mark.parametrize("name,fuse,flagged,tiles", [
    ("rnn-h", True, False, 0), ("cnn-b heads", True, False, 0), ("ae", True, False, 0),
    ("mlp-b", True, False, 0), ("mlp-b", False, False, 0),
])
def test_pga104_flags_the_slow_int8_launches(published, name, fuse, flagged, tiles):
    """No int8 plan copies a LUT tile byte by byte: rnn-h, the CNN-B heads'
    K = 24 layer and the AE's read theirs through L1, so none is flagged."""
    plan = build_plan(published[name], backend="kernel_q8", fuse=fuse, device="cpu",
                      audit="off")
    rep = audit_plan(plan)
    warn = [f for f in rep.findings if f.rule == "PGA104" and f.severity == "warning"]
    assert bool(warn) == flagged
    steps = [*plan.fused_stacks,
             *(b for b in plan.banks if not any(b in st.banks for st in plan.fused_stacks))]
    found = sum(len(_bytewise_tiles(launch_prices(plan, st, R.H100_SXM_SMS)["q8"]["plan"]))
                for st in steps)
    assert found == tiles
    if flagged:
        assert sum(len(f.metrics["tiles"]) for f in warn) == tiles
        for t in (t for f in warn for t in f.metrics["tiles"]):
            assert t["segment_bytes"] % R.PGA104_BULK_ALIGN or \
                t["row_pitch_bytes"] % R.PGA104_BULK_ALIGN
    for f in rep.findings:
        if f.rule == "PGA103":
            assert f.severity == "info"
            assert f.metrics["q8"]["smem_bytes"] <= SMEM_PER_BLOCK


def test_pga103_lists_the_rnn_h_lut_through_l1():
    """RNN-B on ``kernel_q8`` at its published widths (depth 8, hidden 24):
    PGA103 lists the 7 h-banks' LUT route as "L1" and the x- and out-banks'
    as whole rows, trees in shared memory everywhere; PGA104 warns of none."""
    plan = build_plan(_rnn(depth=8), backend="kernel_q8", device="cpu", audit="off")
    rep = audit_plan(plan)
    routes = {f.site: f.metrics["q8"]["layers"] for f in rep.findings if f.rule == "PGA103"}
    assert len(routes) == len(plan.banks) == 16
    for i, bank in enumerate(plan.banks):
        h_bank = (bank.layer.num_groups, bank.layer.out_features) == (24, 24)
        assert routes[f"bank[{i}]"] == [{"trees": "shared", "lut": "L1" if h_bank else "rows"}]
    assert sum(r == [{"trees": "shared", "lut": "L1"}] for r in routes.values()) == 7
    assert not [f for f in rep.findings if f.rule == "PGA104" and f.severity == "warning"]


def test_pga104_cooperative_parts_are_an_info_note(published):
    """MLP-B's last layer has a 12-byte bias (N = 3): copied cooperatively,
    listed with its bytes in an info note, not a warning."""
    plan = build_plan(published["mlp-b"], backend="kernel_q8", device="cpu", audit="off")
    notes = [f for f in audit_plan(plan).findings if f.rule == "PGA104"]
    assert [f.severity for f in notes] == ["info"]
    parts = notes[0].metrics["parts"]
    assert {"stage": parts[0]["stage"], "layer": 3, "part": "bias", "bytes": 12} in parts


def test_pga103_error_over_the_budget_and_where_a_planner_refuses():
    rng = np.random.default_rng(0)
    banks = [_bank(8, 2, 3, 8, 20), _bank(4, 2, 3, 5, 21)]
    plan = build_plan(banks, device="cpu", audit="off")
    errs = [f for f in audit_plan(plan, AuditConfig(smem_budget_bytes=1024)).findings
            if f.rule == "PGA103"]
    assert errs and all(f.severity == "error" for f in errs)
    assert "over the budget of 1024 B" in errs[0].message
    # one row of an int8 launch this wide cannot fit: plan_q8 refuses it
    k, c, n = 1, 2, 30000
    wide = interop.pegasus_linear_from_arrays(
        np.zeros((k, c - 1), np.int32), rng.normal(size=(k, c - 1)),
        rng.normal(size=(k, c, 1)), rng.normal(size=(k, c, n)), None, 1, device="cpu")
    with pytest.raises(PlanAuditError, match="PGA103"):
        build_plan(wide, device="cpu", audit="error")
    with pytest.warns(UserWarning, match="plan audit"):
        rep = build_plan(wide, device="cpu").audit_report
    f = next(f for f in rep.findings if f.rule == "PGA103")
    assert f.severity == "error" and "int8" in f.message and "error" in f.metrics["q8"]


# ---------------------------------------------------------------------------
# PGA105: the splits fuse_banks makes
# ---------------------------------------------------------------------------


def _tiny(n, seed):
    rng = np.random.default_rng(seed)
    return [interop.pegasus_linear_from_arrays(
        np.zeros((1, 1), np.int32), rng.normal(size=(1, 1)), np.zeros((1, 2, 2)),
        rng.normal(size=(1, 2, 2)), None, 2, device="cpu") for _ in range(n)]


def test_pga105_names_the_fusion_splits(published):
    off = build_plan(published["mlp-b"], fuse=False, device="cpu", audit="off")
    found = [f for f in audit_plan(off).findings if f.rule == "PGA105"]
    assert len(found) == 3 and all("fuse=False" in f.message for f in found)
    capped = build_plan(published["mlp-b"], fuse_nmax_cap=16, device="cpu", audit="off")
    found = [f for f in audit_plan(capped).findings if f.rule == "PGA105"]
    assert [f.site for f in found] == ["bank[2]→bank[3]"]
    assert "fuse_nmax_cap=16" in found[0].message
    long = build_plan(_tiny(_lib.MAX_L + 1, 1), device="cpu", audit="off")
    found = [f for f in audit_plan(long).findings if f.rule == "PGA105"]
    assert [f.site for f in found] == [f"bank[{_lib.MAX_L - 1}]→bank[{_lib.MAX_L}]"]
    assert f"MAX_L={_lib.MAX_L}" in found[0].message
    # two equal-width banks whose joined row exceeds STACK_ROW_BYTES
    rng = np.random.default_rng(2)
    v, n = 4100, 12300
    wide = [interop.pegasus_linear_from_arrays(
        np.zeros((k, 1), np.int32), rng.normal(size=(k, 1)), np.zeros((k, 2, v)),
        rng.normal(size=(k, 2, n)), None, v, device="cpu") for k in (1, n // v)]
    plan = build_plan(wide, device="cpu", audit="off")
    assert plan.fused_groups == 0
    found = [f for f in audit_plan(plan).findings if f.rule == "PGA105"]
    assert len(found) == 1 and f"STACK_ROW_BYTES={R.PGA105_STACK_ROW_BYTES}" in found[0].message


# ---------------------------------------------------------------------------
# lifecycle: build_plan's modes, the registry, stats
# ---------------------------------------------------------------------------


def test_build_plan_audit_modes_on_a_tampered_q8_table(monkeypatch):
    banks = [_bank(8, 2, 3, 8, 30), _bank(4, 2, 3, 5, 31)]
    clean = build_plan(banks, device="cpu")
    assert clean.audit_report.ok and clean.compile_stats()["audit"]["error"] == 0
    # a stale quantizer: the plan's banks take int8 tables of zeros
    real = ops.quantize_lut_int8

    def stale(lut):
        q8, scales = real(lut)
        return torch.zeros_like(q8), scales

    monkeypatch.setattr(ops, "quantize_lut_int8", stale)
    with pytest.raises(PlanAuditError, match="PGA102"):
        build_plan(banks, device="cpu", audit="error")
    with pytest.warns(UserWarning, match="plan audit"):
        plan = build_plan(banks, device="cpu")
    bad = [f for f in plan.audit_report.findings if f.severity == "error"]
    assert [(f.rule, f.site) for f in bad] == [("PGA102", "bank[0]"), ("PGA102", "bank[1]")]
    assert bad[0].metrics["rel_err"] > 0.5
    assert plan.compile_stats()["audit"] == plan.audit_report.counts
    off = build_plan(banks, device="cpu", audit="off")
    assert off.audit_report is None and off.compile_stats()["audit"] is None
    with pytest.raises(ValueError, match="audit must be"):
        build_plan(banks, device="cpu", audit="loud")


def test_clean_build_warns_nothing_and_launches_nothing(published):
    launches, calls = dict(_lib.LAUNCHES), STATS.jit_calls
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        plan = build_plan(published["mlp-b"], backend="kernel_q8", device="cpu")
    assert plan.audit_report.ok
    assert dict(_lib.LAUNCHES) == launches and STATS.jit_calls == calls
    assert plan.compile_stats()["traces"] == 0
    doc = plan.audit_report.to_dict()
    assert json.dumps(doc, default=str) and doc["summary"]["device"] == "cpu"
    assert "PGA103" in str(plan.audit_report)


def test_registry_audit_kwarg_and_lazy_report():
    banks = [_bank(8, 2, 3, 8, 40), _bank(4, 2, 3, 5, 41)]
    # the audit mode does not fork the memo key
    assert plan_for(banks, device="cpu", audit="off") is plan_for(banks, device="cpu")
    reg = PlanRegistry()
    reg.register("m", [_bank(8, 2, 3, 8, 42)], backend="gather", device="cpu",
                 audit="off")
    assert reg.get("m").audit_report is None
    assert reg.stats()["m"]["audit"] is None
    rep = reg.audit_report("m")                       # lazy, then cached
    assert rep.ok and reg.get("m").audit_report is rep
    assert reg.stats()["m"]["audit"] == rep.counts


def test_suppress_and_report_shape(published):
    plan = build_plan(published["rnn-h"], device="cpu", audit="off")
    loud = AuditConfig(overflow_margin=1e12)          # PGA101 warns on the bank
    rep = audit_plan(plan, dataclasses.replace(loud, suppress=("PGA101",)))
    assert rep.ok and not [f for f in rep.findings if f.rule == "PGA101"]
    rep = audit_plan(plan, loud)
    doc = rep.to_dict()
    assert doc["counts"]["warning"] == 1 and doc["ok"] is False
    assert doc["summary"]["family"] == "sequential"
