"""The port's soft path and backprop refinement against the JAX reference,
on the CPU: ``soft_index``/``soft_index_stacked``/``apply_soft``,
``leaf_one_hot``, ``fake_quant``'s straight-through gradient, the LUT
helpers, ``refine``'s loss gradient and Adam step, a whole ``refine``
trajectory, and the drift scenario of tests/test_core.py.

Banks are built by the JAX package from numpy data with fixed seeds and
carried into the port with ``repro_torch.interop``. A trajectory runs on
the JAX index sequence: the test replaces ``finetune._batch_indices`` with
the ``jax.random.split``/``randint`` draws of ``repro.core.finetune.refine``,
so both packages see the same minibatches.

Tolerances, stated per test: the soft path within rtol = atol = 1e-4; one
gradient and one Adam update within 1e-6 (no feedback yet); after 20 steps
LUT and bias within 1e-5 and thresholds within 1e-4 (measured by the test
and printed with ``-rP``: thresholds and bias equal, LUT 1.2e-7).
"""

import torch_threads  # noqa: F401  (this worker's share of the cores)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import amm as jamm
from repro.core import finetune as jft
from repro.core import fuzzy_tree as jtree
from repro.core import lut as jlut
from repro.core import quantization as jq
from repro_torch import interop
from repro_torch.core import amm, finetune, fuzzy_tree, lut, quantization
from repro_torch.engine import STATS, plan_for

SOFT_TOL = 1e-4


def jax_batch_indices(n, size, steps, seed, device):
    """The minibatch rows ``repro.core.finetune.refine`` draws
    (``:80-82``), as the port's ``_batch_indices`` returns them."""
    key, rows = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        rows.append(np.asarray(jax.random.randint(sub, (size,), 0, n)))
    return torch.as_tensor(np.stack(rows), dtype=torch.long, device=device)


@pytest.fixture
def jax_batches(monkeypatch):
    monkeypatch.setattr(finetune, "_batch_indices", jax_batch_indices)


def carry(b):
    """A JAX PegasusLinear in the port, on the CPU."""
    return interop.pegasus_linear_from_arrays(
        np.asarray(b.trees.features), np.asarray(b.trees.thresholds),
        np.asarray(b.trees.centroids), np.asarray(b.lut),
        None if b.bias is None else np.asarray(b.bias), b.group_size, device="cpu")


def drift_layer(s=1024):
    """tests/test_core.py's drift scenario: trees fit on a shifted
    calibration set, the teacher a linear layer on the true data."""
    rng = np.random.default_rng(17)
    d, n = 16, 8
    w = rng.normal(size=(d, n)).astype(np.float32) / np.sqrt(d)
    b = rng.normal(size=(n,)).astype(np.float32)
    stale = (rng.normal(size=(s, d)) * 2.0 + 1.5).astype(np.float32)
    true = rng.normal(size=(s, d)).astype(np.float32)
    ref = jamm.init_pegasus_linear(w, b, stale, group_size=4, depth=4, lut_bits=None)
    return ref, carry(ref), true, true @ w + b


def degenerate_layer(lut_bits=None):
    """A bank whose trees hold ``+inf`` thresholds: one group's data is
    constant and another's has too few distinct values for depth 4."""
    rng = np.random.default_rng(3)
    calib = rng.normal(size=(600, 12)).astype(np.float32)
    calib[:, 0:3] = 2.5
    calib[:, 3:6] = np.round(calib[:, 3:6])
    w = rng.normal(size=(12, 5)).astype(np.float32)
    ref = jamm.init_pegasus_linear(w, None, calib, group_size=3, depth=4, lut_bits=lut_bits)
    return ref, carry(ref), calib, calib @ w


def test_degenerate_layer_has_inf_thresholds():
    _, ours, _, _ = degenerate_layer()
    thr = ours.trees.thresholds
    assert torch.isinf(thr).sum() > 10 and torch.isfinite(thr).sum() > 10


@pytest.mark.parametrize("temperature", [1.0, 0.1, 0.05])
def test_soft_index_matches(temperature):
    ref, ours, x, _ = degenerate_layer()
    xg = x[:50].reshape(50, 4, 3)
    got = fuzzy_tree.soft_index_stacked(ours.trees, torch.as_tensor(xg), temperature)
    want = jtree.soft_index_stacked(ref.trees, jnp.asarray(xg), temperature)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SOFT_TOL, atol=SOFT_TOL)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-5)
    # one tree at a time, and the soft layer output
    one = fuzzy_tree.FuzzyTree(ours.trees.features[1], ours.trees.thresholds[1],
                               ours.trees.centroids[1])
    jone = jtree.FuzzyTree(ref.trees.features[1], ref.trees.thresholds[1],
                           ref.trees.centroids[1])
    np.testing.assert_allclose(
        fuzzy_tree.soft_index(one, torch.as_tensor(xg[:, 1]), temperature).numpy(),
        np.asarray(jtree.soft_index(jone, jnp.asarray(xg[:, 1]), temperature)),
        rtol=SOFT_TOL, atol=SOFT_TOL)
    np.testing.assert_allclose(
        amm.apply_soft(ours, torch.as_tensor(x[:50]), temperature).numpy(),
        np.asarray(jamm.apply_soft(ref, jnp.asarray(x[:50]), temperature)),
        rtol=SOFT_TOL, atol=SOFT_TOL)


def test_leaf_one_hot_exact():
    ref, ours, x, _ = degenerate_layer()
    one = fuzzy_tree.FuzzyTree(ours.trees.features[2], ours.trees.thresholds[2],
                               ours.trees.centroids[2])
    jone = jtree.FuzzyTree(ref.trees.features[2], ref.trees.thresholds[2],
                           ref.trees.centroids[2])
    got = fuzzy_tree.leaf_one_hot(one, torch.as_tensor(x[:, 6:9]))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jtree.leaf_one_hot(jone, jnp.asarray(x[:, 6:9]))))


def test_fake_quant_forward_and_ste_gradient():
    spec, jspec = quantization.FixedPointSpec(8, 4), jq.FixedPointSpec(8, 4)
    x = np.array([0.3, 7.9, 100.0, -8.0, -8.1, 0.03125, 7.96875, 8.0], np.float32)
    xt = torch.tensor(x, requires_grad=True)
    y = quantization.fake_quant_spec(xt, spec)
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.asarray(jq.fake_quant_spec(jnp.asarray(x), jspec)))
    (g,) = torch.autograd.grad((y * torch.arange(1.0, 9.0)).sum(), xt)
    jg = jax.grad(lambda v: (jq.fake_quant_spec(v, jspec) * jnp.arange(1.0, 9.0)).sum())(
        jnp.asarray(x))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(g.numpy()[:3], [1.0, 2.0, 0.0])    # clipped STE


def test_lut_helpers_exact():
    ref, ours, _, _ = degenerate_layer()
    one = fuzzy_tree.FuzzyTree(ours.trees.features[1], ours.trees.thresholds[1],
                               ours.trees.centroids[1])
    jone = jtree.FuzzyTree(ref.trees.features[1], ref.trees.thresholds[1],
                           ref.trees.centroids[1])
    np.testing.assert_array_equal(lut.build_lut(one, lambda c: c.sum(-1)).numpy(),
                                  np.asarray(jlut.build_lut(jone, lambda c: c.sum(-1))))
    np.testing.assert_array_equal(lut.build_lut(one, lambda c: 2 * c).numpy(),
                                  np.asarray(jlut.build_lut(jone, lambda c: 2 * c)))
    for bits in (8, 16):
        q, spec = lut.quantize_lut(ours.lut, bits=bits)
        jq_, jspec = jlut.quantize_lut(ref.lut, bits=bits)
        assert (spec.bits, spec.frac_bits) == (jspec.bits, jspec.frac_bits)
        assert q.dtype == torch.int32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
        np.testing.assert_array_equal(lut.dequantize_lut(q, spec).numpy(),
                                      np.asarray(jlut.dequantize_lut(jq_, jspec)))


def test_loss_gradient_and_adam_step_match():
    """One gradient of refine's loss (soft output against the teacher, mean
    squared error) and one Adam update, on the same batch: within 1e-6."""
    ref, ours, x, y = degenerate_layer()
    xb, yb, temp = x[:512], y[:512], 0.2
    params = {"thresholds": ours.trees.thresholds.clone().requires_grad_(True),
              "lut": ours.lut.clone().requires_grad_(True),
              "bias": torch.zeros(5, requires_grad=True)}
    layer = amm.PegasusLinear(
        fuzzy_tree.FuzzyTree(ours.trees.features, params["thresholds"], ours.trees.centroids),
        params["lut"], params["bias"], group_size=3)
    loss = torch.mean((amm.apply_soft(layer, torch.as_tensor(xb), temp)
                       - torch.as_tensor(yb)) ** 2)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))

    def jloss(p):
        jl = jamm.PegasusLinear(jtree.FuzzyTree(ref.trees.features, p["thresholds"],
                                                ref.trees.centroids),
                                p["lut"], p["bias"], group_size=3)
        return jnp.mean((jamm.apply_soft(jl, jnp.asarray(xb), temperature=temp) - yb) ** 2)

    jp = {"thresholds": ref.trees.thresholds, "lut": ref.lut, "bias": jnp.zeros(5)}
    jval, jgrads = jax.value_and_grad(jloss)(jp)
    np.testing.assert_allclose(float(loss.detach()), float(jval), rtol=1e-6)
    inf = torch.isinf(ours.trees.thresholds)
    assert torch.all(grads["thresholds"][inf] == 0)
    for name in params:
        np.testing.assert_allclose(grads[name].numpy(), np.asarray(jgrads[name]),
                                   rtol=1e-6, atol=1e-6, err_msg=name)

    rng = np.random.default_rng(0)
    g, m, v = (rng.normal(size=(4, 7)).astype(np.float32) for _ in range(3))
    v = np.abs(v)
    for step in (1, 2, 50):
        got = finetune._adam_update(*(torch.as_tensor(a) for a in (g, m, v)), step, 3e-3)
        want = jft._adam_update(*(jnp.asarray(a) for a in (g, m, v)), step, 3e-3)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)


@pytest.mark.usefixtures("jax_batches")
def test_refine_trajectory_matches():
    """20 steps of refine on the JAX minibatch sequence: LUT and bias within
    1e-5, thresholds within 1e-4. Adam divides by the root of each entry's
    second moment, so a threshold whose gradient is a near-cancelling mean
    could change sign between the frameworks and move by up to lr = 3e-3
    per step; on this layer they come out equal."""
    ref, ours, x, y = drift_layer()
    got = finetune.refine(ours, x, y, steps=20)
    want = jft.refine(ref, jnp.asarray(x), jnp.asarray(y), steps=20)
    print("refine port vs reference, max |diff| after 20 steps: " + ", ".join(
        f"{name} {float(np.nan_to_num(np.abs(a.numpy() - np.asarray(b))).max()):.3g}"
        for name, a, b in (("thresholds", got.trees.thresholds, want.trees.thresholds),
                           ("lut", got.lut, want.lut), ("bias", got.bias, want.bias))))
    np.testing.assert_array_equal(got.trees.features.numpy(), np.asarray(want.trees.features))
    np.testing.assert_array_equal(got.trees.centroids.numpy(), np.asarray(want.trees.centroids))
    np.testing.assert_allclose(got.trees.thresholds.numpy(), np.asarray(want.trees.thresholds),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.lut.numpy(), np.asarray(want.lut), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.bias.numpy(), np.asarray(want.bias), rtol=1e-5, atol=1e-5)
    assert got.lut.dtype == ours.lut.dtype and got.group_size == ours.group_size
    np.testing.assert_allclose(finetune.hard_mse(got, x, y),
                               jft.hard_mse(want, jnp.asarray(x), jnp.asarray(y)), rtol=1e-5)
    # one step: the temperature is already temp_end, the update Adam's first
    one, jone = finetune.refine(ours, x, y, steps=1), jft.refine(ref, jnp.asarray(x),
                                                                 jnp.asarray(y), steps=1)
    np.testing.assert_allclose(one.lut.numpy(), np.asarray(jone.lut), rtol=1e-6, atol=1e-6)


def test_refine_drift_scenario():
    """tests/test_core.py:278-300 in the port, on its own minibatches:
    refinement re-aligns stale tables (hard_mse below 0.9× unrefined)."""
    _, ours, x, y = drift_layer()
    before = finetune.hard_mse(ours, x, y)
    after = finetune.hard_mse(finetune.refine(ours, x, y, steps=150, lr=3e-3), x, y)
    assert after < 0.9 * before, (before, after)


@pytest.mark.parametrize("lut_bits", [None, 16])
def test_refine_keeps_inf_thresholds_and_stays_finite(lut_bits):
    """Degenerate nodes keep exactly +inf (zero gradient, zero Adam step);
    everything else stays finite. A LUT on the fixed-point grid leaves it
    (the reference does not re-quantize)."""
    _, ours, x, y = degenerate_layer(lut_bits)
    got = finetune.refine(ours, x, y, steps=30, batch_size=128)
    inf = torch.isinf(ours.trees.thresholds)
    assert torch.equal(torch.isinf(got.trees.thresholds), inf)
    assert torch.all(got.trees.thresholds[inf] == float("inf"))
    assert torch.isfinite(got.trees.thresholds[~inf]).all()
    assert not torch.equal(got.trees.thresholds[~inf], ours.trees.thresholds[~inf])
    assert torch.isfinite(got.lut).all() and torch.isfinite(got.bias).all()
    assert torch.isfinite(amm.apply_gather(got, torch.as_tensor(x))).all()
    if lut_bits is not None:
        spec = quantization.choose_qspec(ours.lut, bits=lut_bits)
        assert torch.equal(quantization.fake_quant_spec(ours.lut, spec), ours.lut)
        assert not torch.equal(quantization.fake_quant_spec(got.lut, spec), got.lut)


def test_pegasus_linear_apply_paths():
    """Every path of ``pegasus_linear_apply`` against the reference's (the
    kernels through their plain versions on the CPU), ``dense_reference``
    and ``PegasusLinear.compile``; refined layers get plans of their own."""
    ref, ours, x, _ = drift_layer(256)
    xt, xj = torch.as_tensor(x[:40]), jnp.asarray(x[:40])
    want = np.asarray(jamm.pegasus_linear_apply(ref, xj, path="gather"))
    for path in ("gather", "onehot", "kernel"):
        np.testing.assert_allclose(amm.pegasus_linear_apply(ours, xt, path=path).numpy(),
                                   want, rtol=1e-4, atol=1e-4, err_msg=path)
    for path in ("soft", "kernel_q8"):
        np.testing.assert_allclose(
            amm.pegasus_linear_apply(ours, xt, path=path).numpy(),
            np.asarray(jamm.pegasus_linear_apply(ref, xj, path=path)),
            rtol=1e-4, atol=1e-4, err_msg=path)
    with pytest.raises(ValueError, match="unknown path"):
        amm.pegasus_linear_apply(ours, xt, path="mxu")
    w = np.random.default_rng(1).normal(size=(16, 3)).astype(np.float32)
    np.testing.assert_allclose(
        amm.dense_reference(torch.as_tensor(w), None, xt).numpy(),
        np.asarray(jamm.dense_reference(jnp.asarray(w), None, xj)), rtol=1e-5, atol=1e-5)
    plan = ours.compile(backend="kernel")
    assert plan.device.type == "cpu"
    np.testing.assert_allclose(plan(x[:40]).numpy(), want, rtol=1e-4, atol=1e-4)

    builds = STATS.plan_builds
    refined = finetune.refine(ours, x, x[:, :8], steps=2)
    plan_for([ours], device="cpu")
    plan_for([ours], device="cpu")
    plan_for([refined], device="cpu")
    assert STATS.plan_builds == builds + 2
