"""Lower fused Pegasus layers to the MAT pipeline (paper §6; port of the
JAX package's ``dataplane/compile.py``).

One fused PegasusLinear ⇒ one *logical* stage of K parallel MapTables
(fuzzy TCAM match → SRAM result row), summed by the action ALUs. Physical
stage placement (the 20-stage / per-stage SRAM / 1024-bit-bus bin packing)
happens in :func:`place_physical` and feeds the Table-6-style report.

Numerics: the dataplane is integer-only. Each layer's result rows are
fixed-point quantized with an adaptive binary point (core.quantization);
the next layer's thresholds are rescaled into that integer domain, so the
whole pipeline runs end-to-end in int32 exactly like the switch would.
The banks' tensors may lie on any device: each is read to the host once,
and the tables are numpy arrays (a switch program is host data).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.amm import PegasusLinear
from repro_torch.core.quantization import FixedPointSpec, choose_qspec

from .mat import MapTable, MatPipeline, MatStage
from .resources import SwitchBudget, TOFINO2

__all__ = ["compile_layer", "compile_model", "place_physical"]


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def compile_layer(
    layer: PegasusLinear,
    *,
    in_scale: float = 1.0,
    out_bits: int = 16,
    in_bits: int = 8,
    name: str = "",
) -> tuple[list[MapTable], FixedPointSpec]:
    """Lower one fused PegasusLinear to K MapTables.

    ``in_scale`` is the fixed-point scale of this layer's INPUT domain
    (1.0 for raw 8-bit packet fields); learned float thresholds are mapped
    into the integer domain by multiplying with it.
    """
    k, v = layer.num_groups, layer.group_size
    lut = _host(layer.lut).astype(np.float32)                # [K, C, N]
    bias = None if layer.bias is None else _host(layer.bias).astype(np.float32)
    spec = choose_qspec(lut if bias is None else np.concatenate([lut.ravel(), bias]),
                        bits=out_bits)

    feats = _host(layer.trees.features)
    thrs = _host(layer.trees.thresholds) * in_scale

    tables = []
    for g in range(k):
        rows = np.round(lut[g] * spec.scale).astype(np.int64)
        if bias is not None and g == 0:
            rows = rows + np.round(bias * spec.scale).astype(np.int64)
        rows = np.clip(rows, spec.qmin, spec.qmax).astype(np.int32)
        tables.append(
            MapTable(
                features=feats[g],
                thresholds=thrs[g],
                results=rows,
                in_bits=in_bits,
                out_bits=out_bits,
                key_dims=list(range(g * v, (g + 1) * v)),
                name=f"{name}/g{g}",
            )
        )
    return tables, spec


def compile_model(
    layers: list[PegasusLinear],
    *,
    stateful_bits_per_flow: int = 0,
    out_bits: int = 16,
    in_bits: int = 8,
    budget: SwitchBudget = TOFINO2,
    names: list[str] | None = None,
) -> MatPipeline:
    """Lower a stack of fused Pegasus layers to one logical-stage pipeline.

    Layer i+1's thresholds are rescaled into layer i's output integer
    domain; its ``in_bits`` widens to the accumulated word width.
    """
    pipe = MatPipeline(stages=[], stateful_bits_per_flow=stateful_bits_per_flow, budget=budget)
    scale = 1.0
    bits = in_bits
    for i, layer in enumerate(layers):
        nm = names[i] if names else f"L{i}"
        tables, spec = compile_layer(
            layer, in_scale=scale, out_bits=out_bits, in_bits=bits, name=nm
        )
        pipe.stages.append(MatStage(tables=tables))
        scale = spec.scale
        bits = out_bits
    return pipe


def place_physical(pipe: MatPipeline) -> int:
    """Bin-pack logical stages onto physical MAT stages.

    Within one logical stage, tables may spread over several physical stages
    (partial sums carry in the PHV); consecutive logical stages are
    dependent, so they never share a physical stage. Constraints per
    physical stage: SRAM, TCAM, action-bus width.
    """
    b = pipe.budget
    total = 0
    for stage in pipe.stages:
        sram = tcam = bus = 0
        phys = 1
        for t in stage.tables:
            ts, tt, tb = t.sram_bits(), t.tcam_bits(), t.action_bus_bits()
            if (
                sram + ts > b.sram_bits_per_stage
                or tcam + tt > b.tcam_bits_per_stage
                or bus + tb > b.action_bus_bits
            ):
                phys += 1
                sram = tcam = bus = 0
            sram += ts
            tcam += tt
            bus += tb
        total += phys
    return total
