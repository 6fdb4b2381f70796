"""Tofino-2-like switch resource model (paper §2, Table 6); a copy of the
JAX package's ``dataplane/resources.py`` kept inside the port.

Budget constants from the paper's description of Barefoot Tofino 2:
20 MAT stages/pipeline, 10 Mb SRAM + 0.5 Mb TCAM per stage, 1024-bit Action
Data Bus, 4096-bit PHV. The emulator charges each compiled table against
these budgets and reports the same utilization columns as Table 6.
"""

from __future__ import annotations

import dataclasses

__all__ = ["SwitchBudget", "ResourceReport", "TOFINO2"]


@dataclasses.dataclass(frozen=True)
class SwitchBudget:
    stages: int = 20
    sram_bits_per_stage: int = 10 * 1024 * 1024       # 10 Mb
    tcam_bits_per_stage: int = 512 * 1024             # 0.5 Mb
    action_bus_bits: int = 1024                       # per stage
    phv_bits: int = 4096
    stateful_sram_bits: int = 20 * 1024 * 1024 * 10   # shared pool for per-flow regs


TOFINO2 = SwitchBudget()


@dataclasses.dataclass
class ResourceReport:
    """Accumulated usage for one compiled model."""

    budget: SwitchBudget = dataclasses.field(default_factory=lambda: TOFINO2)
    stages_used: int = 0
    sram_bits: int = 0
    tcam_bits: int = 0
    action_bus_bits_peak: int = 0
    phv_bits_peak: int = 0
    stateful_bits_per_flow: int = 0

    # -- percentages as reported in Table 6 ---------------------------------
    @property
    def sram_pct(self) -> float:
        return 100.0 * self.sram_bits / (self.budget.stages * self.budget.sram_bits_per_stage)

    @property
    def tcam_pct(self) -> float:
        return 100.0 * self.tcam_bits / (self.budget.stages * self.budget.tcam_bits_per_stage)

    @property
    def bus_pct(self) -> float:
        return 100.0 * self.action_bus_bits_peak / self.budget.action_bus_bits

    def validate(self) -> list[str]:
        """Return a list of violated constraints (empty = deployable)."""
        errs = []
        # >20 stages ⇒ recirculation passes (throughput/pass tradeoff), not a
        # correctness violation; reported via ``recirculations``.
        if self.sram_pct > 100:
            errs.append(f"SRAM {self.sram_pct:.1f}% > 100%")
        if self.tcam_pct > 100:
            errs.append(f"TCAM {self.tcam_pct:.1f}% > 100%")
        if self.action_bus_bits_peak > self.budget.action_bus_bits:
            errs.append(
                f"action bus {self.action_bus_bits_peak} > {self.budget.action_bus_bits}"
            )
        if self.phv_bits_peak > self.budget.phv_bits:
            errs.append(f"PHV {self.phv_bits_peak} > {self.budget.phv_bits}")
        return errs

    @property
    def recirculations(self) -> int:
        import math
        return max(0, math.ceil(self.stages_used / self.budget.stages) - 1)

    def table6_row(self, name: str) -> str:
        return (
            f"{name:<14} {self.stateful_bits_per_flow:>6} "
            f"{self.sram_pct:>6.2f}% {self.tcam_pct:>7.2f}% {self.bus_pct:>7.2f}%"
        )
