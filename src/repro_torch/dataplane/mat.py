"""MAT pipeline emulator: execute a compiled Pegasus program stage by stage
(port of the JAX package's ``dataplane/mat.py``).

The emulator models what the switch does per packet:
  * extract fields from the PHV (Partition),
  * match them against a table (exact SRAM or ternary TCAM range rules)
    to fetch a precomputed result row (Map, via fuzzy index),
  * apply integer actions — adds only — to accumulate results (SumReduce).

Everything is integer fixed-point (the dataplane has no floats). The
tables live on the host as numpy arrays: :meth:`MapTable.lookup` and
:meth:`MatPipeline.run_packet` run one packet in Python and are the
semantics everything is held to; the resource accounting is per table, as
Table 6 counts it. :meth:`MatPipeline.run_batch` computes the same thing
for a whole batch on a device: per stage, every table's descent as one
gather per tree level, then the int32 result rows summed over the stage's
tables in their order.

Two details keep the batched path equal to the per-packet one, bit for
bit. NumPy compares a field with a float32 threshold in float64 when the
field is int32 (every stage after the first); torch would compare in
float32, so both paths compare in float64 (exact for float32 and int32
values alike). The sums are int32 and wrap as numpy's do.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device

from .crc import leaf_tcam_rules, tree_leaf_boxes
from .resources import ResourceReport, SwitchBudget, TOFINO2

__all__ = ["MapTable", "MatStage", "MatPipeline"]


@dataclasses.dataclass
class MapTable:
    """One fuzzy-matching Map table: tree → fuzzy index → SRAM result row.

    Attributes:
      features/thresholds: arrays of the (quantized) clustering tree.
      results: ``[C, out_width_words]`` int32 — fixed-point action data.
      in_bits: bit width of each input field (8 in the paper's models).
      out_bits: bit width of each output word.
      key_dims: which PHV fields this table matches on.
    """

    features: np.ndarray
    thresholds: np.ndarray
    results: np.ndarray
    in_bits: int
    out_bits: int
    key_dims: Sequence[int]
    name: str = ""

    @property
    def depth(self) -> int:
        return int(np.log2(self.results.shape[0]) + 0.5)

    def lookup(self, fields: np.ndarray) -> np.ndarray:
        """Per-packet fuzzy index + result fetch. fields: [n_key_dims] ints."""
        node = 0
        n_internal = len(self.features)
        for _ in range(self.depth):
            f, t = self.features[node], self.thresholds[node]
            node = 2 * node + 1 + int(fields[f] > t)
        return self.results[node - n_internal]

    # -- resource accounting -------------------------------------------------
    def tcam_rule_count(self) -> int:
        """One-shot CRC encoding: cross-product of per-dim prefix rules."""
        boxes = tree_leaf_boxes(
            self.features, self.thresholds, self.depth, len(self.key_dims), self.in_bits
        )
        return sum(leaf_tcam_rules(b, self.in_bits) for b in boxes)

    def staged_tcam_bits(self) -> int:
        """Staged encoding: one narrow range-match per tree LEVEL.

        Each level's table is keyed by (current node id, one feature value):
        2 range rules per internal node, key = node-id bits + in_bits. No
        cross-product — this is how deep/multi-dim trees actually compile
        (one comparison per MAT stage), at the cost of ``depth`` extra
        pipeline stages.
        """
        n_internal = len(self.features)
        node_bits = max(1, (n_internal).bit_length())
        key_bits = node_bits + self.in_bits
        return n_internal * 2 * key_bits * 2  # 2 rules/node, value+mask

    def tcam_bits(self) -> int:
        """Compiler picks the cheaper encoding (one-shot vs staged)."""
        key_bits = len(self.key_dims) * self.in_bits
        one_shot = self.tcam_rule_count() * key_bits * 2
        return min(one_shot, self.staged_tcam_bits())

    def sram_bits(self) -> int:
        return int(self.results.shape[0] * self.results.shape[1] * self.out_bits)

    def action_bus_bits(self) -> int:
        return int(self.results.shape[1] * self.out_bits)


@dataclasses.dataclass
class MatStage:
    """Tables co-resident in one physical stage (must share its budgets)."""

    tables: list[MapTable] = dataclasses.field(default_factory=list)


class _StageOperands:
    """One stage's tables stacked on a device for :meth:`MatPipeline.run_batch`:
    key field ids ``[K, v]``, split features ``[K, I]`` (int64),
    thresholds ``[K, I]`` (float64) and result rows ``[K, C, N]`` (int32)."""

    __slots__ = ("keys", "features", "thresholds", "results", "depth", "groups")

    def __init__(self, tables: Sequence[MapTable], device: torch.device):
        shapes = {(len(t.key_dims), len(t.features), *t.results.shape) for t in tables}
        if len(shapes) != 1:
            raise ValueError(f"run_batch stacks a stage's tables: their key widths, "
                             f"trees and result rows differ ({sorted(shapes)})")
        self.depth = tables[0].depth
        self.groups = torch.arange(len(tables), device=device)[None, :]
        self.keys = torch.as_tensor(np.array([list(t.key_dims) for t in tables]),
                                    dtype=torch.int64, device=device)
        self.features = torch.as_tensor(np.stack([t.features for t in tables]),
                                        dtype=torch.int64, device=device)
        self.thresholds = torch.as_tensor(
            np.stack([np.asarray(t.thresholds, np.float64) for t in tables]),
            dtype=torch.float64, device=device)
        self.results = torch.as_tensor(np.stack([t.results for t in tables]),
                                       dtype=torch.int32, device=device)

    def run(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, F]`` fields → ``[B, N]`` int32: every table's descent as one
        gather per level, then the rows summed in table order."""
        fields = x[:, self.keys].to(torch.float64)               # [B, K, v]
        node = torch.zeros(fields.shape[:2], dtype=torch.int64, device=x.device)
        for _ in range(self.depth):
            f = self.features[self.groups, node]                 # [B, K]
            t = self.thresholds[self.groups, node]
            val = fields.gather(2, f.unsqueeze(-1)).squeeze(-1)
            node = 2 * node + 1 + (val > t).to(torch.int64)
        rows = self.results[self.groups, node - self.features.shape[1]]  # [B, K, N]
        acc = rows[:, 0]
        for k in range(1, rows.shape[1]):
            acc = acc + rows[:, k]                               # int32, wraps
        return acc


@dataclasses.dataclass
class MatPipeline:
    """A sequence of MAT stages implementing one Pegasus model."""

    stages: list[MatStage] = dataclasses.field(default_factory=list)
    stateful_bits_per_flow: int = 0
    budget: SwitchBudget = dataclasses.field(default_factory=lambda: TOFINO2)
    # per device: the stages' tables stacked for run_batch, built at its
    # first call there and rebuilt when the stages change
    _operands: dict = dataclasses.field(default_factory=dict, repr=False,
                                        compare=False)

    def run_packet(self, fields: np.ndarray) -> np.ndarray:
        """Execute the pipeline on one packet's PHV fields.

        Per stage: all tables look up in parallel; their result rows are
        summed (the SumReduce action) to form the next stage's fields.
        """
        x = np.asarray(fields)
        for stage in self.stages:
            if not stage.tables:
                continue
            acc = None
            for tbl in stage.tables:
                row = tbl.lookup(x[list(tbl.key_dims)])
                acc = row if acc is None else acc + row
            x = acc
        return x

    def _stage_operands(self, device: torch.device) -> list[_StageOperands]:
        token = tuple(id(t) for s in self.stages for t in s.tables)
        cached = self._operands.get(device)
        if cached is None or cached[0] != token:
            ops = [_StageOperands(s.tables, device) for s in self.stages if s.tables]
            cached = self._operands[device] = (token, ops)
        return cached[1]

    def run_batch(self, batch, *, device: str | torch.device | None = None) -> torch.Tensor:
        """:meth:`run_packet` over every row of ``batch`` ``[B, F]`` at once,
        on ``device``: the tensor's own device by default, the GPU for host
        arrays (``device="cpu"`` runs it on the CPU). Returns the outputs
        on that device: int32 ``[B, N]`` once a stage has run, else the
        fields unchanged."""
        if device is None:
            device = batch.device if isinstance(batch, torch.Tensor) else "cuda"
        dev = resolve_device(device)
        x = torch.as_tensor(batch, device=dev)
        for stage in self._stage_operands(dev):
            x = stage.run(x)
        return x

    def report(self) -> ResourceReport:
        """Resource accounting AFTER physical placement.

        Tables of one logical stage spread across physical stages (partial
        sums carried in the PHV), so the action-bus peak is the max over
        PHYSICAL stages — placement packs to the 1024-bit budget, and a
        single table wider than the bus is the only way to exceed it.
        """
        from .compile import place_physical

        rep = ResourceReport(budget=self.budget)
        rep.stages_used = place_physical(self)
        b = self.budget
        for stage in self.stages:
            sram = tcam = bus = 0
            for tbl in stage.tables:
                ts, tt, tb = tbl.sram_bits(), tbl.tcam_bits(), tbl.action_bus_bits()
                rep.sram_bits += ts
                rep.tcam_bits += tt
                if (
                    sram + ts > b.sram_bits_per_stage
                    or tcam + tt > b.tcam_bits_per_stage
                    or bus + tb > b.action_bus_bits
                ):
                    rep.action_bus_bits_peak = max(rep.action_bus_bits_peak, bus)
                    sram = tcam = bus = 0
                sram += ts
                tcam += tt
                bus += tb
            rep.action_bus_bits_peak = max(rep.action_bus_bits_peak, bus)
        rep.stateful_bits_per_flow = self.stateful_bits_per_flow
        # PHV peak: widest inter-stage accumulator vector (one layer's output)
        widths = [
            max((t.results.shape[1] * t.out_bits for t in s.tables), default=0)
            for s in self.stages
        ]
        rep.phv_bits_peak = max(widths, default=0)
        return rep
