"""The plain reference against the port's own paths, on the banks the
benchmark draws, at a small size on the CPU."""

from __future__ import annotations

import pytest
import torch

from bench.harness import Cell
from conftest import SMALL


def _drawn(name: str, seed: int = 2**31 + 17):
    cell = Cell(name, overrides=SMALL)
    cfg, model = cell.config, cell.model
    flows = model.flows(cfg, seed)
    inputs = tuple(torch.as_tensor(a) for a in flows)
    return cell, model.draw(cfg, inputs, seed), inputs


@pytest.mark.parametrize("workload", ["mlp-b.bulk", "cnn-l.bulk"])
@pytest.mark.parametrize("backend", ["gather", "kernel"])
def test_reference_equals_the_port(workload, backend):
    """The port's plan (its gather path, and its kernel path's plain
    version) gives the reference's logits to the bit."""
    from repro_torch.engine import build_plan

    cell, drawn, inputs = _drawn(workload)
    plan = build_plan(cell.model.program_model(cell.config, drawn), backend=backend,
                      device="cpu", audit="off")
    got = plan(*inputs)
    want = cell.model.reference(cell.config, drawn, inputs)
    assert got.shape == want.shape == (inputs[0].shape[0], cell.config["classes"])
    assert torch.equal(got, want)


@pytest.mark.parametrize("workload", ["mlp-b.bulk", "cnn-l.bulk"])
def test_int8_reference_equals_the_ports_kernel_q8(workload):
    """With the table as int8 codes (a ``kernel_q8`` configuration), the
    reference gives the port's ``kernel_q8`` logits to the bit."""
    from repro_torch.engine import build_plan

    cell, drawn, inputs = _drawn(workload)
    plan = build_plan(cell.model.program_model(cell.config, drawn), backend="kernel_q8",
                      device="cpu", audit="off")
    assert torch.equal(plan(*inputs), cell.model.reference(cell.config, drawn, inputs,
                                                           int8=True))


@pytest.mark.parametrize("workload", ["mlp-b.bulk", "cnn-l.bulk"])
def test_bfloat16_control_is_far_from_the_reference(workload):
    """The control (the reference in bfloat16) misses the float32 reference
    by far more than the configuration's limit, relative to the logits'
    spread; the reference itself matches."""
    cell, drawn, inputs = _drawn(workload)
    want = cell.model.reference(cell.config, drawn, inputs)
    low = cell.model.reference(cell.config, drawn, inputs, dtype=torch.bfloat16)
    spread = float(want.std())
    assert float((low - want).abs().max()) / spread > 10 * cell.config["check"]["logit_gap"]


def test_reference_imports_nothing_of_the_program(root):
    """The configuration modules and the bank arithmetic import neither the
    port nor JAX at module level."""
    import ast

    for path in [root / "bench" / "banks.py", *(root / "bench" / "configs").glob("*.py")]:
        tree = ast.parse(path.read_text())
        for node in tree.body:
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in {"repro_torch", "repro", "jax", "jaxlib", "flax"}, (
                    path, n)
