"""Plan auditor: static numerics, shared-memory and dataplane analysis of
compiled plans (port of the JAX package's ``analysis/planaudit.py``).

:func:`audit_plan` walks a built ``ExecutionPlan`` — banks, fused stacks,
bucket ladder, q8 tables — on the host, launches no kernel and touches no
CUDA graph, and proves (or refutes) the invariants below:

* **PGA101** — fixed-point overflow: worst-case int32 accumulator bound of
  each bank's q8 tables, all groups rescaled to the finest group scale (the
  common fixed-point grid an integer dataplane would accumulate in). The
  bound is exact: per output column, each group independently contributes
  its most extreme row, so ``Σ_k max_c`` / ``Σ_k min_c`` IS the reachable
  worst case.
* **PGA102** — quantization fidelity: worst-case per-group dequantization
  error of the q8 table vs the f32 LUT it claims to quantize. Symmetric
  round-to-nearest guarantees ``err ≤ scale/2`` (~0.4% of the group amax);
  a violation means the q8 table is stale or tampered.
* **PGA103** — shared memory per launch, on both kernel designs, since one
  plan serves either backend per call: each step is planned by
  ``kernel.py::plan_f32`` → ``f32_launch_shape`` and by
  ``quantized.py::plan_q8`` (keyed on the alignment of the plan's own
  operands, as a launch keys it) → ``launch_shape``, at the rows per block
  the largest ladder bucket gives on the plan device's SM count, and
  priced against ``SMEM_PER_BLOCK``. A planner that refuses the geometry,
  or bytes over the budget, is an error; otherwise the bytes, rows, ring
  slots, stages, fills and each layer's routes (trees in shared memory or
  through L1; the int8 LUT as whole rows, column tiles or through L1:
  ``plan_q8`` stages a LUT only where bulk copies bring all of it, so
  rnn-h, the CNN-B heads' and the AE's K = 24 layers read theirs through
  L1) are an info note. There is no margin warning: ``plan_q8`` sizes its
  two ring slots to fill the block, so every int8 launch sits within 1% of
  it.
* **PGA104** — the bulk-copy rule: an int8 column tile whose LUT row
  segments are no multiple of 16 bytes (or not 16-byte aligned) cannot go
  by bulk async copy, and one warp would copy it a byte at a time — a
  warning with the byte counts. ``plan_q8`` emits no such tile (it reads
  that LUT through L1), so the warning guards the planner. Smaller parts
  outside a stage's bulk mask (a 12-byte bias, a 12-byte scale row, trees
  of 2,040 B) are copied cooperatively: an info note. The TPU's batch-tile and MXU-lane checks have no counterpart: on
  CUDA one warp takes one row and there is no matrix unit in the path.
* **PGA105** — fusion-rejection explanations: why each adjacent chained
  bank pair is NOT inside one :class:`FusedBankStack` (v/C mismatch,
  chaining break, the ``nmax_cap`` balloon guard, the stacked kernel's
  ``MAX_L`` layers or ``STACK_ROW_BYTES`` row cap, ``fuse=False``, or a
  family builder that never runs the fusion pass). Info severity.
* **PGA106** — dataplane resource fit: the plan's banks lowered through
  :mod:`repro_torch.dataplane.compile` to a MAT pipeline, charged against
  a declared :class:`SwitchBudget` (``AuditConfig.target``). Off unless a
  target is declared.

Lifecycle wiring: ``build_plan(..., audit="warn"|"error"|"off")`` runs this
at build, ``plan.audit_report`` / ``compile_stats()["audit"]`` carry the
result into every server ``stats()`` surface, and
``python -m repro_torch.analysis plan [--json]`` audits the in-tree zoo.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any

import numpy as np

from repro_torch.kernels.fuzzy_lut import quantized as Q
from repro_torch.kernels.fuzzy_lut.kernel import (_depth, _sm_count, f32_launch_shape,
                                                  plan_f32, stack_fits)

from . import rules as R

__all__ = [
    "AuditConfig", "AuditFinding", "AuditReport", "PlanAuditError",
    "audit_plan", "launch_prices", "main",
]


class PlanAuditError(ValueError):
    """Raised by ``build_plan(..., audit="error")`` on error-severity
    findings; carries the full report as ``.report``."""

    def __init__(self, report: "AuditReport"):
        self.report = report
        bad = [f for f in report.findings if f.severity == "error"]
        super().__init__(
            f"plan audit failed with {len(bad)} error finding"
            f"{'s' if len(bad) != 1 else ''}:\n"
            + "\n".join(f"  {f}" for f in bad))


@dataclasses.dataclass(frozen=True)
class AuditFinding:
    """One typed finding: ``rule`` is a PGA1xx id, ``severity`` one of
    error/warning/info, ``site`` names the plan element (bank[i], stack[g],
    plan), ``metrics`` the numbers behind the verdict."""

    rule: str
    severity: str
    site: str
    message: str
    metrics: dict = dataclasses.field(default_factory=dict)

    def __str__(self) -> str:
        return f"{self.severity.upper():7s} {self.rule} {self.site}: {self.message}"

    def to_dict(self) -> dict:
        return {"rule": self.rule, "severity": self.severity,
                "site": self.site, "message": self.message,
                "metrics": self.metrics}


@dataclasses.dataclass(frozen=True)
class AuditConfig:
    """Audit policy knobs. Defaults come from :mod:`repro_torch.analysis.rules`.
    ``smem_budget_bytes`` is the counterpart of the reference's
    ``vmem_budget_bytes``: the shared memory per block a launch may use."""

    q8_rel_tol: float = R.PGA102_REL_TOL
    smem_budget_bytes: int = R.PGA103_SMEM_BUDGET
    overflow_margin: float = R.PGA101_MARGIN
    # dataplane target for PGA106: None (off), "tofino2", or a SwitchBudget
    target: Any = None
    # PGA rule ids to drop entirely (CLI --suppress)
    suppress: tuple = ()


class AuditReport:
    """Findings + plan summary; the object ``plan.audit_report`` caches."""

    def __init__(self, findings: list[AuditFinding], summary: dict):
        self.findings = list(findings)
        self.summary = dict(summary)

    @property
    def counts(self) -> dict:
        c = {"error": 0, "warning": 0, "info": 0}
        for f in self.findings:
            c[f.severity] += 1
        return c

    @property
    def ok(self) -> bool:
        """No error- or warning-severity findings (info is explanatory)."""
        c = self.counts
        return c["error"] == 0 and c["warning"] == 0

    def to_dict(self) -> dict:
        return {"summary": self.summary, "counts": self.counts,
                "ok": self.ok,
                "findings": [f.to_dict() for f in self.findings]}

    def __str__(self) -> str:
        c = self.counts
        head = (f"plan audit [{self.summary.get('family')}] "
                f"{c['error']} error(s), {c['warning']} warning(s), "
                f"{c['info']} note(s)")
        return "\n".join([head] + [f"  {f}" for f in self.findings])


# ---------------------------------------------------------------------------
# Per-rule checks. Each takes the plan (duck-typed; the engine is imported
# lazily, it imports this package) and a config, and yields AuditFinding
# objects.
# ---------------------------------------------------------------------------


def _host(t, dtype) -> np.ndarray:
    return t.detach().cpu().numpy().astype(dtype)


def _true_tables(bank) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(f32 LUT, q8 LUT, scales) of one bank on the host, float64/int64."""
    return (_host(bank.lut, np.float64), _host(bank.lut_q8, np.int64),
            _host(bank.scales, np.float64))


def accumulation_grid(scales: np.ndarray) -> float:
    """The coarsest fixed-point grid step that loses no representable
    signal: the finest scale among SIGNIFICANT groups. A group whose whole
    amplitude (``amax ≈ 127·scale``) sits below half a step of a coarser
    grid rounds to zero in that grid anyway, so it cannot force the grid
    finer (a dead group's scale is floored at ``1e-8/127``).

    Formally: the largest candidate ``s ∈ scales`` such that every group
    is either representable (``scale_g ≥ s``) or flushable
    (``127·scale_g ≤ s/2``)."""
    if scales.size == 0:
        return 1.0
    ss = np.sort(scales.astype(np.float64))
    prefix = np.maximum.accumulate(ss)                  # coarsest so far
    for i in range(ss.size - 1, -1, -1):
        if i == 0 or prefix[i - 1] * 254.0 <= ss[i]:
            return max(float(ss[i]), 1e-30)
    return max(float(ss[0]), 1e-30)


def overflow_bound(q8: np.ndarray, scales: np.ndarray,
                   bias: np.ndarray | None = None) -> float:
    """Worst-case |int32 accumulator| for one bank's SumReduce, in units of
    the bank's accumulation grid (:func:`accumulation_grid`; groups finer
    than the grid flush to zero under ``rint``, as rescale hardware would).

    Exact, not just an upper bound: per output column the K groups choose
    leaves independently, so the extreme sum is separable —
    ``Σ_k max_c`` (and ``Σ_k min_c`` for the negative side).
    """
    smin = accumulation_grid(scales)
    contrib = np.rint(q8 * (scales[:, None, None] / smin))      # [K, C, N]
    pos = contrib.max(axis=1).sum(axis=0)                       # [N]
    neg = contrib.min(axis=1).sum(axis=0)
    if bias is not None:
        b = np.rint(np.asarray(bias, np.float64) / smin)
        pos = pos + b
        neg = neg + b
    if pos.size == 0:
        return 0.0
    return float(max(pos.max(), -neg.min(), 0.0))


def _check_overflow(plan, cfg: AuditConfig, tables: dict):
    for i, bank in enumerate(plan.banks):
        _, q8, scales = tables[id(bank)]
        bias = None if bank.layer.bias is None else _host(bank.layer.bias, np.float32)
        bound = overflow_bound(q8, scales, bias)
        grid = accumulation_grid(scales)
        metrics = {"bound": bound, "int32_max": R.INT32_MAX,
                   "k": bank.layer.num_groups, "grid": grid,
                   "scale_spread": float(scales.max() / grid)
                   if scales.size else 1.0}
        site = f"bank[{i}]"
        if bound > R.INT32_MAX:
            yield AuditFinding(
                "PGA101", "error", site,
                f"worst-case accumulator {bound:.3e} exceeds int32 "
                f"({R.INT32_MAX}) in the finest-scale fixed-point grid "
                f"(group scale spread {metrics['scale_spread']:.1e})",
                metrics)
        elif bound * cfg.overflow_margin > R.INT32_MAX:
            yield AuditFinding(
                "PGA101", "warning", site,
                f"worst-case accumulator {bound:.3e} is within "
                f"{cfg.overflow_margin:g}x of int32", metrics)


def _check_fidelity(plan, cfg: AuditConfig, tables: dict):
    for i, bank in enumerate(plan.banks):
        lut, q8, scales = tables[id(bank)]
        if lut.size == 0:
            continue
        dq = q8 * scales[:, None, None]
        amax = np.abs(lut).max(axis=(1, 2))                     # [K]
        rel = np.abs(lut - dq).max(axis=(1, 2)) / np.maximum(amax, 1e-8)
        worst = float(rel.max())
        if worst > cfg.q8_rel_tol:
            g = int(rel.argmax())
            yield AuditFinding(
                "PGA102", "error", f"bank[{i}]",
                f"q8 dequant error {worst:.4f} of group {g}'s amax exceeds "
                f"tol {cfg.q8_rel_tol:g} — the int8 table does not match "
                "the f32 LUT (stale or tampered quantization)",
                {"rel_err": worst, "group": g, "tol": cfg.q8_rel_tol})


def _iter_steps(plan):
    """(site, step) over the plan's forward steps: fused stacks once each,
    banks not inside any stack individually."""
    fused_members = {id(b) for s in plan.fused_stacks for b in s.banks}
    for g, s in enumerate(plan.fused_stacks):
        lo = plan.banks.index(s.banks[0])
        yield f"stack[{g}]=banks[{lo}:{lo + len(s.banks)}]", s
    for i, b in enumerate(plan.banks):
        if id(b) not in fused_members:
            yield f"bank[{i}]", b


def _step_geometry(step) -> dict:
    """A step's launch arguments: the per-layer group counts, the operand
    stacks' shape and the int8 operands a launch plans over."""
    if hasattr(step, "ks"):                                      # FusedBankStack
        _, kmax, c, nmax = step.lut.shape
        return dict(ks=step.ks, v=step.v, depth=_depth(c), kmax=kmax, nmax=nmax,
                    n_out=step.n_out, q8=(step.features, step.thr, step.lut_q8,
                                          step.scales, step.bias))
    layer = step.layer
    k, n = layer.num_groups, layer.out_features
    return dict(ks=(k,), v=layer.group_size, depth=_depth(layer.num_centroids),
                kmax=k, nmax=n, n_out=n,
                q8=(step.features, step.thr, step.lut_q8, step.scales, None))


def _sm_source(plan) -> tuple[int, str]:
    dev = plan.device
    if dev.type == "cuda":
        return _sm_count(dev), f"{dev}"
    return R.H100_SXM_SMS, f"H100 SXM ({R.H100_SXM_SMS} SMs): the plan lies on {dev}"


def _q8_routes(qplan: Q.Q8Plan, nl: int) -> list[dict]:
    """Per layer of an int8 launch: where its trees and its LUT are read."""
    out = [{"trees": "L1", "lut": "L1"} for _ in range(nl)]
    for st in qplan.stages:
        if st.flags & Q.TREES:
            out[st.layer]["trees"] = "shared"
        if st.flags & Q.LUT:
            out[st.layer]["lut"] = "rows" if st.flags & Q.FULLROW else "tiles"
    return out


def launch_prices(plan, step, n_sm: int) -> dict:
    """What one step's launches at the largest bucket take, on both kernel
    designs: ``{"rows": T, "f32": {...} | {"error": msg}, "q8": {...} |
    {"error": msg}}`` — rows per block, shared bytes and routes, from the
    kernels' own planners and launch-shape helpers. ``T`` is the rows the
    step sees for the largest bucket (a flow is several rows for the CNN
    window bank and the CNN-L banks)."""
    geo = _step_geometry(step)
    t = max(plan.buckets) * plan.step_rows_per_flow(step)
    ks, v, depth, kmax = geo["ks"], geo["v"], geo["depth"], geo["kmax"]
    out: dict = {"rows": t}
    try:
        fp = plan_f32(tuple(ks), v, depth, kmax)
        rows, grid, _, smem = f32_launch_shape(fp, t, n_sm)
        out["f32"] = {"rows_per_block": rows, "grid": grid, "smem_bytes": smem,
                      "row": ("registers" if fp.regs
                              else "shared" if fp.width else "global"),
                      "trees": "shared" if fp.kpad else "L1", "lut": "L1"}
    except ValueError as exc:
        out["f32"] = {"error": str(exc)}
    feats, thr, lut_q8, scales, bias = geo["q8"]
    try:
        qp = Q.launch_plan(v, feats, thr, lut_q8, scales, bias, ks, geo["n_out"])
        rows, _, grid, _, smem = Q.launch_shape(qp, t, n_sm)
        out["q8"] = {"rows_per_block": rows, "grid": grid, "smem_bytes": smem,
                     "slot_bytes": qp.slot_bytes, "stages": len(qp.stages),
                     "fills": len(qp.fills), "layers": _q8_routes(qp, len(ks)),
                     "plan": qp}
    except ValueError as exc:
        out["q8"] = {"error": str(exc)}
    return out


def _prices(plan) -> list[tuple[str, Any, dict]]:
    n_sm, _ = _sm_source(plan)
    return [(site, step, launch_prices(plan, step, n_sm))
            for site, step in _iter_steps(plan)]


def _public(price: dict) -> dict:
    return {k: v for k, v in price.items() if k != "plan"}


def _check_smem(plan, cfg: AuditConfig, prices):
    budget = cfg.smem_budget_bytes
    n_sm, src = _sm_source(plan)
    for site, _, price in prices:
        f32, q8 = price["f32"], price["q8"]
        metrics = {"rows": price["rows"], "n_sm": n_sm, "sm_count_of": src,
                   "budget": budget, "f32": f32, "q8": _public(q8)}
        bad = [f"{name}: {p['error']}" for name, p in (("f32", f32), ("int8", q8))
               if "error" in p]
        bad += [f"{name} launch needs {p['smem_bytes']} B of shared memory per "
                f"block, over the budget of {budget} B"
                for name, p in (("f32", f32), ("int8", q8))
                if "error" not in p and p["smem_bytes"] > budget]
        if bad:
            yield AuditFinding("PGA103", "error", site, "; ".join(bad), metrics)
            continue
        yield AuditFinding(
            "PGA103", "info", site,
            f"{price['rows']} rows at the largest bucket on {n_sm} SMs: f32 "
            f"{f32['rows_per_block']} rows/block, {f32['smem_bytes']} B shared "
            f"(trees {f32['trees']}); int8 {q8['rows_per_block']} rows/block, "
            f"{q8['smem_bytes']} B shared ({q8['stages']} stages in "
            f"{q8['fills']} fills, ring slot {q8['slot_bytes']} B); budget "
            f"{budget} B", metrics)


_PARTS = ((Q.TREES, Q.B_FEAT, "features"), (Q.TREES, Q.B_THR, "thresholds"),
          (Q.GATHER, Q.B_SCALE, "scales"), (Q.GATHER, Q.B_BIAS, "bias"))


def _part_bytes(st: Q.Q8Stage, bit: int, c: int, nmax: int, has_bias: bool) -> int:
    i = c - 1
    if bit in (Q.B_FEAT, Q.B_THR):
        return 4 * st.groups * i
    if bit == Q.B_SCALE:
        return 4 * st.groups
    if bit == Q.B_BIAS:
        return 4 * st.nt if has_bias else 0
    return st.groups * c * nmax                                # a whole-row LUT


def _check_bulk(plan, cfg: AuditConfig, prices):
    for site, step, price in prices:
        qp = price["q8"].get("plan")
        if qp is None:
            continue                                # PGA103 reports the error
        geo = _step_geometry(step)
        c, nmax = 2 ** geo["depth"], geo["nmax"]
        has_bias = geo["q8"][4] is not None
        tiles, parts = [], []
        for idx, st in enumerate(qp.stages):
            if st.flags & Q.LUT and not st.flags & Q.FULLROW:
                if not st.bulk & Q.B_LUT:
                    tiles.append({"stage": idx, "layer": st.layer, "n0": st.n0,
                                  "segment_bytes": st.nt, "segments": st.groups * c,
                                  "row_pitch_bytes": nmax,
                                  "tile_bytes": st.groups * c * st.nt})
                continue
            for flag, bit, name in _PARTS + ((Q.LUT, Q.B_LUT, "lut"),):
                nbytes = _part_bytes(st, bit, c, nmax, has_bias)
                if st.flags & flag and nbytes and not st.bulk & bit:
                    parts.append({"stage": idx, "layer": st.layer, "part": name,
                                  "bytes": nbytes})
        if tiles:
            total = sum(t["tile_bytes"] for t in tiles)
            yield AuditFinding(
                "PGA104", "warning", site,
                f"{len(tiles)} int8 column-tile stage(s) copy {total} B of LUT "
                f"as {tiles[0]['segments']} row segments of "
                f"{tiles[0]['segment_bytes']} B at a {nmax}-byte pitch, a byte "
                f"at a time by one warp: a bulk async copy needs segments and "
                f"pitch in multiples of {R.PGA104_BULK_ALIGN} B",
                {"tiles": tiles, "tile_bytes": total, "row_pitch_bytes": nmax,
                 "bulk_align": R.PGA104_BULK_ALIGN})
        if parts:
            yield AuditFinding(
                "PGA104", "info", site,
                "copied cooperatively, outside the bulk mask: "
                + ", ".join(f"layer {p['layer']} {p['part']} {p['bytes']} B"
                            for p in parts),
                {"parts": parts, "bulk_align": R.PGA104_BULK_ALIGN})


def _unfused_reasons(a, b) -> list[str]:
    """Why the port's ``_fusable(a, b)`` says no — one string per failed
    conjunct."""
    la, lb = a.layer, b.layer
    r = []
    if la.group_size != lb.group_size:
        r.append(f"partition width v {la.group_size} != {lb.group_size}")
    if la.num_centroids != lb.num_centroids:
        r.append(f"centroid count C {la.num_centroids} != {lb.num_centroids}")
    if la.out_features != lb.in_features:
        r.append(f"chaining break: out {la.out_features} != in {lb.in_features}")
    return r


def _chain_boundaries(plan):
    """Adjacent chained (previous step, head bank, structural note) triples
    the forward executes back to back, by family."""
    st = plan._state
    fam = plan.family
    chains: list[tuple[list, str | None]] = []
    if fam == "sequential":
        chains.append((list(st["steps"]), None))
    elif fam == "cnn":
        heads = list(st["heads"])
        if heads:
            # window → first head crosses the per-window SumReduce/mean —
            # a structural break no fusion pass can cross
            chains.append(([st["window"], heads[0]],
                           "structural: the per-window SumReduce/mean "
                           "separates the pair"))
            chains.append((heads, None))
    elif fam == "cnn_l":
        chains.append(([st["b1"], st["b2"]],
                       "the cnn_l builder compiles banks individually "
                       "(no fusion pass over the b1→b2 chain)"))
    # rnn: recurrent structure — no two banks chain unconditionally
    for steps, note in chains:
        for prev, nxt in zip(steps, steps[1:]):
            if prev is nxt:
                continue
            head = nxt.banks[0] if hasattr(nxt, "ks") else nxt
            yield prev, head, note


def _split_reason(run: list, head, cap) -> str:
    """Why ``fuse_banks`` closed ``run`` before the shape-compatible
    ``head``: the balloon guard, or the stacked kernel's limits."""
    members = [*run, head]
    ns = [b.layer.out_features for b in members]
    if cap is not None and max(ns) > cap and min(ns) < max(ns):
        return (f"pair is shape-compatible but split by the fuse_nmax_cap={cap} "
                f"balloon guard (member widths {tuple(ns[-2:])} would pad a "
                "narrow stack to the run's Nmax)")
    if len(members) > R.PGA105_MAX_L:
        return (f"pair is shape-compatible but the run already holds "
                f"{len(run)} banks, the stacked kernel's MAX_L={R.PGA105_MAX_L}")
    kmax = max(b.layer.num_groups for b in members)
    if not stack_fits(members[0].layer.num_groups, head.layer.group_size, kmax,
                      max(ns), len(members)):
        return (f"pair is shape-compatible but one row of the joined stack "
                f"(Kmax={kmax}, Nmax={max(ns)}) exceeds the stacked kernel's "
                f"STACK_ROW_BYTES={R.PGA105_STACK_ROW_BYTES}")
    return "pair is shape-compatible but fuse_banks split it"


def _check_fusion(plan, cfg: AuditConfig):
    cap = plan.fuse_cfg.get("nmax_cap")
    fuse_on = plan.fuse_cfg.get("fuse", True)
    for prev, head, note in _chain_boundaries(plan):
        run = list(prev.banks) if hasattr(prev, "ks") else [prev]
        tail = run[-1]
        ti = plan.banks.index(tail)
        hi = plan.banks.index(head)
        site = f"bank[{ti}]→bank[{hi}]"
        reasons = _unfused_reasons(tail, head)
        if note is not None and "structural" in note:
            reasons = [note] + reasons
        elif not reasons:
            if not fuse_on:
                reasons = ["pair is shape-compatible but fusion is disabled "
                           "(fuse=False)"]
            elif note is not None:
                reasons = [note + " — pair is shape-compatible (fusion "
                           "ratchet candidate, see ROADMAP)"]
            else:
                reasons = [_split_reason(run, head, cap)]
        yield AuditFinding(
            "PGA105", "info", site,
            "unfused adjacent pair: " + "; ".join(reasons),
            {"tail": ti, "head": hi})


def _resolve_target(target):
    from repro_torch.dataplane.resources import TOFINO2, SwitchBudget
    if target is None:
        return None, None
    if isinstance(target, SwitchBudget):
        return target, "custom"
    name = str(target).lower()
    if name in ("", "none", "off"):
        return None, None
    if name == "tofino2":
        return TOFINO2, "tofino2"
    raise ValueError(f"unknown dataplane target {target!r} (know: tofino2)")


def _check_dataplane(plan, cfg: AuditConfig):
    budget, name = _resolve_target(cfg.target)
    if budget is None:
        return
    from repro_torch.dataplane.compile import compile_model
    pipe = compile_model([b.layer for b in plan.banks], budget=budget)
    rep = pipe.report()
    metrics = {"target": name, "stages_used": rep.stages_used,
               "sram_pct": round(rep.sram_pct, 2),
               "tcam_pct": round(rep.tcam_pct, 2),
               "bus_pct": round(rep.bus_pct, 2),
               "phv_bits_peak": rep.phv_bits_peak,
               "recirculations": rep.recirculations}
    for err in rep.validate():
        yield AuditFinding(
            "PGA106", "error", "plan",
            f"dataplane target '{name}' exceeded: {err}", metrics)
    if rep.recirculations:
        yield AuditFinding(
            "PGA106", "warning", "plan",
            f"{rep.stages_used} physical stages need "
            f"{rep.recirculations} recirculation pass(es) on '{name}' "
            f"({budget.stages} stages/pipeline) — line rate divides "
            "accordingly", metrics)
    yield AuditFinding(
        "PGA106", "info", "plan",
        f"dataplane fit on '{name}': {rep.stages_used} stages, "
        f"SRAM {rep.sram_pct:.2f}%, TCAM {rep.tcam_pct:.2f}%, "
        f"bus {rep.bus_pct:.2f}%", metrics)


def audit_plan(plan, config: AuditConfig | None = None) -> AuditReport:
    """Statically audit a built ExecutionPlan (PGA101–PGA106).

    Host-side analysis: reads the plan's tables to the host once, calls the
    kernels' planners, and never launches a kernel or touches a CUDA graph.
    Returns an :class:`AuditReport` (its ``summary["seconds"]`` is the
    audit's own host time); attach it yourself or let
    ``build_plan(..., audit=...)`` do both.
    """
    t0 = time.perf_counter()
    cfg = config or AuditConfig()
    suppress = set(cfg.suppress)
    tables = {id(b): _true_tables(b) for b in plan.banks}
    prices = _prices(plan)
    checks = (_check_overflow(plan, cfg, tables), _check_fidelity(plan, cfg, tables),
              _check_smem(plan, cfg, prices), _check_bulk(plan, cfg, prices),
              _check_fusion(plan, cfg), _check_dataplane(plan, cfg))
    findings = [f for check in checks for f in check if f.rule not in suppress]
    order = {"error": 0, "warning": 1, "info": 2}
    findings.sort(key=lambda f: (order[f.severity], f.rule, f.site))
    summary = {
        "family": plan.family,
        "backend": plan.backend,
        "num_banks": len(plan.banks),
        "fused_groups": len(plan.fused_stacks),
        "buckets": list(plan.buckets),
        "devices": 1 if plan.devices is None else len(plan.devices),
        "device": str(plan.device),
        "table_bytes": plan.table_bytes(),
        "seconds": time.perf_counter() - t0,      # host time of this audit
    }
    return AuditReport(findings, summary)


# ---------------------------------------------------------------------------
# CLI: python -m repro_torch.analysis plan [--json] — audits the in-tree zoo.
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis plan",
        description="Static plan audit (PGA101-PGA106) over the in-tree "
                    "model families; exit 1 on any unsuppressed "
                    "error/warning finding")
    ap.add_argument("--families", default="mlp,rnn,cnn,cnn_l,ae",
                    help="comma-separated families to build and audit")
    ap.add_argument("--backends", default="gather,kernel_q8",
                    help="comma-separated default backends to build per family")
    ap.add_argument("--json", action="store_true",
                    help="print the full report as JSON instead of text")
    ap.add_argument("--out", default=None,
                    help="also write the JSON report to this path")
    ap.add_argument("--target", default=None,
                    help="dataplane target for PGA106 (e.g. tofino2); "
                         "default: no target declared")
    ap.add_argument("--smem-budget", type=int, default=None,
                    help="override the PGA103 shared-memory budget per block "
                         "(bytes; the reference's --vmem-budget)")
    ap.add_argument("--suppress", default="",
                    help="comma-separated PGA rule ids to suppress")
    ap.add_argument("--flows", type=int, default=48,
                    help="synthetic dataset flows per class (zoo size)")
    ap.add_argument("--steps", type=int, default=5,
                    help="training steps per zoo model")
    ap.add_argument("--device", default="cuda",
                    help="device the zoo is trained on and the plans built "
                         "for (default: the GPU; 'cpu' prices an H100 SXM)")
    args = ap.parse_args(argv)

    cfg = AuditConfig(
        target=args.target,
        smem_budget_bytes=args.smem_budget or R.PGA103_SMEM_BUDGET,
        suppress=tuple(s for s in args.suppress.split(",") if s))

    from repro_torch.engine import build_plan

    from .zoo import build_family

    reports: dict[str, AuditReport] = {}
    families = [f for f in args.families.split(",") if f]
    backends = [b for b in args.backends.split(",") if b]
    for fam in families:
        model = build_family(fam, flows=args.flows, steps=args.steps,
                             device=args.device)
        for be in backends:
            plan = build_plan(model, backend=be, audit="off", device=args.device)
            reports[f"{fam}:{be}"] = audit_plan(plan, cfg)

    totals = {"error": 0, "warning": 0, "info": 0}
    for rep in reports.values():
        for sev, n in rep.counts.items():
            totals[sev] += n
    doc = {
        "config": {"target": args.target, "suppress": cfg.suppress,
                   "smem_budget_bytes": cfg.smem_budget_bytes,
                   "families": families, "backends": backends,
                   "device": args.device},
        "totals": totals,
        "plans": {name: rep.to_dict() for name, rep in reports.items()},
        "rules": R.PGA_RULES,
    }
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(doc, fh, indent=2, default=str)
    if args.json:
        print(json.dumps(doc, indent=2, default=str))
    else:
        for name, rep in reports.items():
            print(f"== {name} ==")
            print(rep)
        print(f"plan-audit: {totals['error']} error(s), "
              f"{totals['warning']} warning(s), {totals['info']} note(s) "
              f"over {len(reports)} plan(s)")
    return 1 if (totals["error"] or totals["warning"]) else 0
