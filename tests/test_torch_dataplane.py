"""The port's dataplane (``repro_torch.dataplane``) against the JAX
package's: the same banks, built by the JAX package and carried over,
compile to the same MAT tables, the same Table-6 report and the same int32
outputs. The port's batched ``run_batch`` is held exactly to its own
per-packet ``run_packet`` and to the reference's ``run_batch``. CRC tests
are ported from ``tests/test_dataplane.py``."""

import torch_threads  # noqa: F401  (this worker's share of the cores)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import init_pegasus_linear
from repro.core.amm import apply_gather
from repro.dataplane import compile as jcompile
from repro.dataplane import crc as jcrc
from repro_torch import interop
from repro_torch.core.fuzzy_tree import fit_tree
from repro_torch.core.quantization import choose_qspec
from repro_torch.dataplane.compile import compile_model, place_physical
from repro_torch.dataplane.crc import leaf_tcam_rules, range_to_ternary, tree_leaf_boxes
from repro_torch.dataplane.mat import MapTable, MatPipeline, MatStage
from repro_torch.dataplane.resources import TOFINO2

try:
    from hypothesis import given, settings, strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover
    HAVE_HYPOTHESIS = False

CPU = torch.device("cpu")


def test_range_to_ternary_exact_cover():
    rules = range_to_ternary(3, 12, 4)
    for x in range(16):
        matched = sum(r.matches(x) for r in rules)
        assert matched == (1 if 3 <= x <= 12 else 0)


def test_range_to_ternary_full_and_single():
    assert len(range_to_ternary(0, 255, 8)) == 1       # one wildcard rule
    rules = range_to_ternary(77, 77, 8)
    assert len(rules) == 1 and rules[0].mask == 255


@pytest.mark.parametrize("lo,hi,bits", [(0, 0, 4), (3, 12, 4), (1, 254, 8), (77, 200, 8),
                                        (128, 255, 8), (5, 5, 8)])
def test_range_to_ternary_equals_reference(lo, hi, bits):
    got = [(r.value, r.mask, r.bits) for r in range_to_ternary(lo, hi, bits)]
    want = [(r.value, r.mask, r.bits) for r in jcrc.range_to_ternary(lo, hi, bits)]
    assert got == want
    assert [repr(r) for r in range_to_ternary(lo, hi, bits)] == \
        [repr(r) for r in jcrc.range_to_ternary(lo, hi, bits)]


if HAVE_HYPOTHESIS:

    @settings(max_examples=50, deadline=None)
    @given(data=st.data(), bits=st.sampled_from([4, 8]))
    def test_property_crc_partition(data, bits):
        """CRC rules cover [lo,hi] exactly once and nothing else."""
        hi = data.draw(st.integers(0, 2**bits - 1))
        lo = data.draw(st.integers(0, hi))
        rules = range_to_ternary(lo, hi, bits)
        for x in range(2**bits):
            assert sum(r.matches(x) for r in rules) == (1 if lo <= x <= hi else 0)


def test_tree_leaf_boxes_partition_input_space():
    """Leaf boxes tile the quantized input space (disjoint + complete), and
    equal the reference's boxes on the same tree."""
    rng = np.random.default_rng(3)
    X = rng.integers(0, 16, size=(512, 2)).astype(np.float32)
    tree = fit_tree(X, depth=3)
    feats, thrs = tree.features.numpy(), tree.thresholds.numpy()
    boxes = tree_leaf_boxes(feats, thrs, 3, 2, bits=4)
    assert boxes == jcrc.tree_leaf_boxes(feats, thrs, 3, 2, bits=4)
    count = np.zeros((16, 16), dtype=int)
    for box in boxes:
        (l0, h0), (l1, h1) = box
        if l0 > h0 or l1 > h1:
            continue
        count[l0 : h0 + 1, l1 : h1 + 1] += 1
    np.testing.assert_array_equal(count, 1)
    assert [leaf_tcam_rules(b, 4) for b in boxes] == [jcrc.leaf_tcam_rules(b, 4) for b in boxes]


def _arrays(b) -> dict:
    return dict(features=np.asarray(b.trees.features),
                thresholds=np.asarray(b.trees.thresholds),
                centroids=np.asarray(b.trees.centroids), lut=np.asarray(b.lut),
                bias=None if b.bias is None else np.asarray(b.bias),
                group_size=b.group_size)


def _carry(layers):
    return [interop.pegasus_linear_from_arrays(**_arrays(l), device="cpu") for l in layers]


def _two_layer(rng, depth=4):
    """``tests/test_dataplane.py::_two_layer``: two banks built by the JAX
    package on 8-bit fields."""
    d, h, o, s = 8, 8, 4, 4096
    X = rng.integers(0, 256, size=(s, d)).astype(np.float32)
    w1 = rng.normal(size=(d, h)).astype(np.float32) * 0.05
    b1 = rng.normal(size=(h,)).astype(np.float32)
    w2 = rng.normal(size=(h, o)).astype(np.float32) * 0.3
    l1 = init_pegasus_linear(w1, b1, X, group_size=2, depth=depth, lut_bits=None)
    h_pre = np.asarray(apply_gather(l1, jnp.asarray(X)))
    l2 = init_pegasus_linear(
        w2, None, h_pre, group_size=2, depth=depth, lut_bits=None,
        act_fn=lambda c: jnp.maximum(c, 0),
    )
    y = np.asarray(apply_gather(l2, jnp.asarray(h_pre)))
    return X, [l1, l2], y


@pytest.fixture(scope="module", params=[3, 4])
def two_layer(request):
    rng = np.random.default_rng(request.param)
    X, layers, y = _two_layer(rng, depth=request.param)
    return {"X": X, "ref": layers, "port": _carry(layers), "y": y}


def test_compiled_tables_equal_reference(two_layer):
    pipe = compile_model(two_layer["port"], stateful_bits_per_flow=80)
    ref = jcompile.compile_model(two_layer["ref"], stateful_bits_per_flow=80)
    assert len(pipe.stages) == len(ref.stages) == 2
    for stage, rstage in zip(pipe.stages, ref.stages):
        assert len(stage.tables) == len(rstage.tables)
        for t, r in zip(stage.tables, rstage.tables):
            for name in ("features", "thresholds", "results"):
                got, want = getattr(t, name), np.asarray(getattr(r, name))
                assert got.dtype == want.dtype, name
                np.testing.assert_array_equal(got, want, err_msg=name)
            assert (list(t.key_dims), t.in_bits, t.out_bits, t.name) == \
                (list(r.key_dims), r.in_bits, r.out_bits, r.name)
            assert (t.sram_bits(), t.tcam_bits(), t.action_bus_bits()) == \
                (r.sram_bits(), r.tcam_bits(), r.action_bus_bits())


def test_report_equals_reference_field_for_field(two_layer):
    rep = compile_model(two_layer["port"], stateful_bits_per_flow=80).report()
    want = jcompile.compile_model(two_layer["ref"], stateful_bits_per_flow=80).report()
    got_d, want_d = dataclasses.asdict(rep), dataclasses.asdict(want)
    assert got_d == want_d
    assert (rep.sram_pct, rep.tcam_pct, rep.bus_pct) == (want.sram_pct, want.tcam_pct, want.bus_pct)
    assert rep.validate() == want.validate() == []
    assert rep.recirculations == want.recirculations
    assert rep.table6_row("mlp") == want.table6_row("mlp")
    assert rep.stages_used >= 2 and 0 < rep.sram_pct < 100 and 0 <= rep.tcam_pct < 100


def test_run_batch_int32_equal_to_reference_and_run_packet(two_layer):
    X = two_layer["X"][:256]
    pipe = compile_model(two_layer["port"], stateful_bits_per_flow=80)
    ref = jcompile.compile_model(two_layer["ref"], stateful_bits_per_flow=80)
    got = pipe.run_batch(torch.as_tensor(X))
    assert got.device == CPU and got.dtype == torch.int32
    want = ref.run_batch(X)
    np.testing.assert_array_equal(got.numpy(), want)
    packets = np.stack([pipe.run_packet(p) for p in X])
    assert packets.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), packets)


def test_integer_pipeline_matches_float_model(two_layer):
    """``tests/test_dataplane.py``'s check on the port: fixed-point error
    only, a few quanta of each layer."""
    pipe = compile_model(two_layer["port"], stateful_bits_per_flow=80)
    out = pipe.run_batch(two_layer["X"][:128], device="cpu").numpy()
    spec = choose_qspec(two_layer["port"][-1].lut, bits=16)
    y_float = two_layer["y"]
    assert np.abs(out / spec.scale - y_float[:128]).max() < 0.05 * np.abs(y_float).max()


def test_place_physical_splits_oversized_logical_stage():
    """A logical stage whose tables exceed one stage's bus must split; the
    count equals the reference's."""
    rng = np.random.default_rng(5)
    d, n, s = 32, 64, 2048  # 16 tables × 64×16b rows = wide bus demand
    X = rng.integers(0, 256, size=(s, d)).astype(np.float32)
    w = rng.normal(size=(d, n)).astype(np.float32) * 0.05
    layer = init_pegasus_linear(w, None, X, group_size=2, depth=4, lut_bits=None)
    pipe = compile_model(_carry([layer]))
    assert place_physical(pipe) > 1
    assert place_physical(pipe) == jcompile.place_physical(jcompile.compile_model([layer]))
    assert pipe.budget is TOFINO2


def _table(features, thresholds, results, key_dims):
    return MapTable(features=np.asarray(features, np.int32),
                    thresholds=np.asarray(thresholds, np.float32),
                    results=np.asarray(results, np.int32), in_bits=16, out_bits=32,
                    key_dims=key_dims)


def test_run_batch_compares_int_fields_in_float64():
    """An int32 field of 2**24 + 1 is above a float32 threshold of 2**24
    in numpy (compared in float64); a float32 comparison would call them
    equal. The batched path follows the per-packet one."""
    first = MatStage([_table([0], [0.5], [[2**24], [2**24 + 1]], [0])])
    second = MatStage([_table([0], [float(2**24)], [[10], [20]], [0])])
    pipe = MatPipeline(stages=[first, second])
    batch = np.array([[0.0], [1.0]], np.float32)
    want = np.stack([pipe.run_packet(p) for p in batch])
    np.testing.assert_array_equal(want, [[10], [20]])
    np.testing.assert_array_equal(pipe.run_batch(batch, device="cpu").numpy(), want)


def test_run_batch_wraps_int32_sums_like_numpy():
    big = 2**31 - 8
    tables = [_table([0], [0.5], [[big, -big], [5, 7]], [0]) for _ in range(2)]
    pipe = MatPipeline(stages=[MatStage(tables)])
    batch = np.array([[0.0], [1.0]], np.float32)
    want = np.stack([pipe.run_packet(p) for p in batch])
    assert want.dtype == np.int32 and want[0, 0] < 0       # wrapped
    got = pipe.run_batch(torch.as_tensor(batch))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_run_batch_defaults_to_the_card():
    """Host arrays go to the GPU unless ``device="cpu"``: without CUDA the
    call raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    pipe = MatPipeline(stages=[MatStage([_table([0], [0.5], [[1], [2]], [0])])])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipe.run_batch(np.zeros((2, 1), np.float32))
    assert pipe.run_batch(np.zeros((2, 1), np.float32), device="cpu").tolist() == [[1], [1]]


def test_chip_smoke_phase8_rehearsal():
    """chip_smoke.py's phase 8 in process at tiny size on the CPU: every
    plan of phases 4-7 audited at build with the planners' numbers, PGA104
    on exactly the byte-wise int8 column tiles (the CNN-B heads at this
    size), and the integer pipelines equal to run_packet."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    res = smoke.main_path(CPU, flows_per_class=48, steps=5, depth=3, n_serve=200)
    fams = smoke.families_phase(CPU, flows_per_class=48, steps=5, tiny=True, n_serve=200)
    multi = smoke.multi_model_phase(res, fams, CPU, "the CPU")
    refined = smoke.refinement_phase(res, fams, CPU, "the CPU", baseline_steps=5,
                                     cnn_m_steps=3)
    audit = smoke.audit_phase(res, fams, multi, refined, CPU, "the CPU")
    assert audit["plans"] == len(audit["seconds"]) >= 40
    assert audit["flagged"] == [("stack[0]=banks[1:3]", ("stack", 16, 24))]
    out = smoke.dataplane_phase(res, fams, refined, CPU, "the CPU")
    assert out["MLP-B (refined)"]["report"].stateful_bits_per_flow == 80
    assert out["AE"]["report"].validate() == []
    assert 0.0 <= out["agree"] <= 1.0 and out["served_f1"] == refined["runs"][("kernel", True)]["f1"]
