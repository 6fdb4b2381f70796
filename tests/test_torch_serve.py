"""The port's slice as a whole against the JAX reference, on the CPU:
JAX-pegasusified MLP-B banks go through ``repro_torch.interop`` into the
port's plans (fused and unfused) and its server, and ``chip_smoke.py``'s
main path is rehearsed at tiny size.

Sizes follow tests/test_engine.py (48 flows per class, 5 training steps,
depth 3, batch 16). Tolerances are the reference's own: every backend
within rtol = atol = 1e-4 of the reference ``gather``; the port's
``kernel_q8`` within 1e-4 of the reference ``kernel_q8`` (same int8 codes).
"""

import torch_threads  # noqa: F401  (this worker's share of the cores)

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.fuzzy_tree import hard_index_stacked as jax_hard_index_stacked
from repro.data.synthetic_traffic import make_dataset
from repro.engine import build_plan as jax_build_plan
from repro.engine import bucket_batch as jax_bucket_batch
from repro.engine import bucket_chunks as jax_bucket_chunks
from repro_torch import interop
from repro_torch.engine import (
    BACKENDS, STATS, CompiledBank, FusedBankStack, bucket_batch, bucket_chunks,
    build_plan, fuse_banks,
)
from repro_torch.kernels.fuzzy_lut import _lib
from repro_torch.kernels.fuzzy_lut.kernel import fuzzy_lut
from repro_torch.launch import serve as tserve
from repro_torch.launch.request import InferRequest, InferResult

TOL = 1e-4
CPU = torch.device("cpu")
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ref():
    """Reference MLP-B banks, a batch, and the reference plan's outputs."""
    from repro.nets.mlp import pegasusify_mlp, train_mlp

    ds = make_dataset("peerrush", flows_per_class=48)
    m = train_mlp(ds.train["stats"], ds.train["label"], ds.num_classes, steps=5)
    banks = pegasusify_mlp(m, ds.train["stats"].astype(np.float32), depth=3,
                           refine_steps=0)
    x = ds.test["stats"][:16].astype(np.float32)
    plan = jax_build_plan(banks, audit="off")
    outs = {be: np.asarray(plan(jnp.asarray(x), backend=be))
            for be in ("gather", "kernel_q8")}
    port_banks = interop.banks_from_arrays(
        [dict(features=np.asarray(b.trees.features),
              thresholds=np.asarray(b.trees.thresholds),
              centroids=np.asarray(b.trees.centroids), lut=np.asarray(b.lut),
              bias=None if b.bias is None else np.asarray(b.bias),
              group_size=b.group_size) for b in banks], device="cpu")
    return dict(banks=banks, plan=plan, x=x, outs=outs, port_banks=port_banks)


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_slice_matches_reference(ref, fuse):
    plan = build_plan(ref["port_banks"], fuse=fuse, device="cpu")
    assert plan.fused_groups == (1 if fuse else 0)
    assert plan.fused_banks == (4 if fuse else 0)
    for be in BACKENDS:
        out = plan(ref["x"], backend=be)
        assert out.shape == (16, 3) and out.dtype == torch.float32
        if be == "kernel_q8":
            np.testing.assert_allclose(out.numpy(), ref["outs"]["kernel_q8"],
                                       rtol=TOL, atol=TOL, err_msg="q8 vs reference q8")
        else:
            np.testing.assert_allclose(out.numpy(), ref["outs"]["gather"],
                                       rtol=TOL, atol=TOL, err_msg=be)


def test_bank_leaves_on_reference_activations(ref):
    """Per bank, on the activations the REFERENCE plan feeds it: the port's
    kernel leaves equal the reference descent exactly, so a flipped row
    downstream could only come from a bank input, never from a descent."""
    port_plan = build_plan(ref["port_banks"], device="cpu")
    for jbank, xb, bank in zip(ref["banks"], ref["plan"].bank_inputs(jnp.asarray(ref["x"])),
                               port_plan.banks):
        xg = np.asarray(xb).reshape(-1, jbank.num_groups, jbank.group_size)
        want = np.asarray(jax_hard_index_stacked(jbank.trees, jnp.asarray(xg)))
        _, leaves = fuzzy_lut(torch.tensor(xg), bank.features, bank.thr, bank.lut,
                              return_leaves=True)
        np.testing.assert_array_equal(leaves.numpy(), want)


def test_bucketing_matches_reference():
    for b in list(range(1, 70)) + [255, 256, 257, 4095, 4096, 4097, 9000]:
        assert bucket_batch(b) == jax_bucket_batch(b)
    for total in (1, 9, 100, 1500, 4096, 5000, 12345):
        for cap in (None, 64, 1000):
            assert bucket_chunks(total, max_batch=cap) == jax_bucket_chunks(total, max_batch=cap)


def test_compile_stats_schema_and_first_uses(ref):
    jplan = jax_build_plan(ref["banks"])
    plan = build_plan(ref["port_banks"], device="cpu")
    calls = [(ref["x"][:5], "gather"), (ref["x"][:7], "gather"), (ref["x"], "kernel"),
             (ref["x"][:3], "kernel")]
    for x, be in calls:
        plan(x, backend=be)
        jplan(jnp.asarray(x), backend=be)
    st, jst = plan.compile_stats(), jplan.compile_stats()
    assert st["traces"] == 3 and st["jit_calls"] == 4 and st["bucket_hits"] == 1
    assert st["buckets"] == [("gather", 8), ("kernel", 8), ("kernel", 16)]
    for key in ("traces", "jit_calls", "bucket_hits", "buckets", "pad_waste",
                "pad_waste_fused", "fused_groups", "fused_banks", "devices"):
        assert st[key] == jst[key], key
    # both packages audit by default: finding counts, the same keys, no error
    assert st["audit"] == plan.audit_report.counts
    assert set(st["audit"]) == set(jst["audit"]) == {"error", "warning", "info"}
    assert st["audit"]["error"] == 0


def test_fused_stack_checks_geometry_once_and_never_falls_back(ref):
    banks = [CompiledBank(b, device=CPU) for b in ref["port_banks"]]
    with pytest.raises(ValueError, match="not shape-compatible"):
        FusedBankStack([banks[3], banks[0]])
    # a chain longer than the stacked kernel's MAX_L layers splits in fuse_banks
    rng = np.random.default_rng(0)
    tiny = [CompiledBank(interop.pegasus_linear_from_arrays(
        np.zeros((1, 1), np.int32), rng.normal(size=(1, 1)),
        np.zeros((1, 2, 2)), rng.normal(size=(1, 2, 2)), None, 2, device="cpu"),
        device=CPU) for _ in range(_lib.MAX_L + 1)]
    with pytest.raises(ValueError, match="exceeds"):
        FusedBankStack(tiny)
    steps = fuse_banks(tiny)
    assert [len(s.banks) if isinstance(s, FusedBankStack) else 1 for s in steps] == [_lib.MAX_L, 1]
    assert not hasattr(FusedBankStack, "_per_bank")


def test_server_serves_typed_requests(ref):
    server = tserve.PegasusServer(ref["port_banks"], backend="kernel", device="cpu")
    x = ref["x"]
    reqs = [InferRequest("mlp", x[:3]), InferRequest("mlp", x[3:4]),
            InferRequest("mlp", x[4:16], priority="high")]
    before = STATS.jit_calls
    out = server.serve(reqs)
    assert STATS.jit_calls - before == 1            # 16 flows: one bucket
    assert [type(r) for r in out] == [InferResult] * 3
    assert [r.flows for r in out] == [3, 1, 12]
    np.testing.assert_allclose(np.concatenate([r.output for r in out]),
                               server.plan(x).numpy(), rtol=TOL, atol=TOL)
    st = server.stats()
    assert st["serving"] == {"requests_served": 3, "batches_run": 1,
                             "flows_served": 16, "batches_dispatched": 1}
    assert st["engine"]["num_banks"] == 4 and st["engine"]["fused_groups"] == 1
    with pytest.warns(DeprecationWarning):
        legacy = server.serve([x[:2], x[2:5]])
    assert [o.shape for o in legacy] == [(2, 3), (3, 3)]
    with pytest.raises(TypeError, match="mix"):
        server.serve([reqs[0], x[:2]])
    assert server.stats()["serving"]["requests_served"] == 5


def test_serve_cli(capsys):
    """``python -m repro_torch.launch.serve --pegasus`` end to end on the
    CPU; without --pegasus the CLI refuses."""
    tserve.main(["--pegasus", "--backend", "kernel_q8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "1 fused groups covering 4 banks" in out and "flows/s" in out
    with pytest.raises(SystemExit):
        tserve.main(["--device", "cpu"])
    assert "--pegasus" in capsys.readouterr().err


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_rehearsal(capsys):
    """chip_smoke.py's kernel checks and main path, in process at tiny size
    on the CPU (plain versions), so its paths and arguments are right before
    any chip time is spent; without CUDA its entry point fails and prints no
    result line."""
    smoke = _chip_smoke()
    checks = smoke.check_kernels(CPU, t=32, time_it=False)
    assert sorted(checks) == sorted(name for name, _, _ in smoke.KERNELS)
    assert all(rec["max_abs_err"] == 0.0 and rec["nbytes"] > 0 for rec in checks.values())
    res = smoke.main_path(CPU, flows_per_class=48, steps=5, depth=3, n_serve=200)
    assert set(res["runs"]) == {("gather", True), ("kernel", True), ("kernel_q8", True),
                                ("kernel", False), ("kernel_q8", False)}
    assert res["runs"][("kernel", True)]["max_abs_err"] <= TOL
    assert res["requests"] == 4 and res["flows"] == 200   # sizes 1, 7, 64, 128
    if not torch.cuda.is_available():
        capsys.readouterr()
        assert smoke.main([]) == 1
        assert '"ok"' not in capsys.readouterr().out
