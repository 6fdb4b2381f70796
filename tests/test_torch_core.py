"""The port's offline core against the JAX reference, on the CPU: data,
trees, quantization, LUTs, PegasusLinear apply paths, the optimizer, the
MLP-B forward — plus the port's import and device discipline.

Inputs come from numpy with fixed seeds and go to both packages. Trees,
datasets and quantization codes must be bit-exact; float results are held
to the stated tolerance (sum order differs between the frameworks).
"""

import torch_threads  # noqa: F401  (this worker's share of the cores)

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import amm as jamm
from repro.core import fuzzy_tree as jtree
from repro.core import lut as jlut
from repro.core import quantization as jq
from repro.data.synthetic_traffic import make_dataset as jax_make_dataset
from repro.nets import common as jcommon
from repro.nets import mlp as jmlp
from repro.train import optimizer as jopt
from repro_torch import interop, resolve_device
from repro_torch.core import amm, fuzzy_tree, lut, quantization
from repro_torch.data.synthetic_traffic import make_dataset
from repro_torch.nets import common, mlp
from repro_torch.train import optimizer


@pytest.mark.parametrize("name", ["peerrush", "iscxvpn"])
def test_make_dataset_bit_identical(name):
    ours, ref = make_dataset(name, flows_per_class=20), jax_make_dataset(name, flows_per_class=20)
    assert ours.num_classes == ref.num_classes
    for split in ("train", "val", "test"):
        for key in ("stats", "seq", "bytes", "label"):
            a, b = getattr(ours, split)[key], getattr(ref, split)[key]
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _tree_data(seed):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(200, 3)).astype(np.float32)
    data[:, 2] = np.round(data[:, 2])          # heavy ties
    data[:40, 1] = 1.5                          # a constant block
    return data


@pytest.mark.parametrize("depth", [1, 3, 5])
def test_fit_tree_bit_exact(depth):
    data = _tree_data(depth)
    ours, ref = fuzzy_tree.fit_tree(data, depth), jtree.fit_tree(data, depth)
    np.testing.assert_array_equal(ours.features.numpy(), np.asarray(ref.features))
    np.testing.assert_array_equal(ours.thresholds.numpy(), np.asarray(ref.thresholds))
    np.testing.assert_array_equal(ours.centroids.numpy(), np.asarray(ref.centroids))
    x = np.random.default_rng(9).normal(size=(64, 3)).astype(np.float32)
    np.testing.assert_array_equal(fuzzy_tree.hard_index(ours, torch.as_tensor(x)).numpy(),
                                  np.asarray(jtree.hard_index(ref, jnp.asarray(x))))


def test_hard_index_stacked_matches():
    trees_np = [_tree_data(s) for s in range(4)]
    ours = fuzzy_tree.stack_trees([fuzzy_tree.fit_tree(d, 3) for d in trees_np])
    ref = jtree.stack_trees([jtree.fit_tree(d, 3) for d in trees_np])
    x = np.random.default_rng(1).normal(size=(5, 7, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        fuzzy_tree.hard_index_stacked(ours, torch.as_tensor(x)).numpy(),
        np.asarray(jtree.hard_index_stacked(ref, jnp.asarray(x))))


@pytest.mark.parametrize("bits", [8, 16])
def test_quantization_matches(bits):
    x = (np.random.default_rng(bits).normal(size=(50,)) * 37.0).astype(np.float32)
    x[0] = 0.5 / 2.0**10                        # a rounding tie on some grids
    spec, jspec = quantization.choose_qspec(x, bits), jq.choose_qspec(x, bits)
    assert (spec.bits, spec.frac_bits) == (jspec.bits, jspec.frac_bits)
    q = quantization.quantize(torch.as_tensor(x), spec)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq.quantize(jnp.asarray(x), jspec)))
    np.testing.assert_array_equal(quantization.dequantize(q, spec).numpy(),
                                  np.asarray(jq.dequantize(jnp.asarray(q.numpy()), jspec)))
    np.testing.assert_array_equal(
        quantization.fake_quant_spec(torch.as_tensor(x), spec).numpy(),
        np.asarray(jq.fake_quant_spec(jnp.asarray(x), jspec)))


def test_build_matmul_lut_matches():
    rng = np.random.default_rng(4)
    cents = rng.normal(size=(5, 8, 3)).astype(np.float32)
    w = rng.normal(size=(15, 7)).astype(np.float32)
    np.testing.assert_allclose(
        lut.build_matmul_lut(torch.as_tensor(cents), torch.as_tensor(w), 3).numpy(),
        np.asarray(jlut.build_matmul_lut(jnp.asarray(cents), jnp.asarray(w), 3)),
        rtol=1e-6, atol=1e-6)


def _dense_layer(seed, d=12, n=6, s=300):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(d, n)).astype(np.float32),
            rng.normal(size=(n,)).astype(np.float32),
            (rng.normal(size=(s, d)) * 4.0).astype(np.float32))


@pytest.mark.parametrize("lut_bits", [None, 16])
def test_init_pegasus_linear_matches(lut_bits):
    w, b, calib = _dense_layer(5)
    ours = amm.init_pegasus_linear(w, b, calib, group_size=3, depth=3,
                                   lut_bits=lut_bits, device="cpu",
                                   act_fn=lambda c: torch.clamp(c, min=0.0))
    ref = jamm.init_pegasus_linear(w, b, calib, group_size=3, depth=3,
                                   lut_bits=lut_bits,
                                   act_fn=lambda c: jnp.maximum(c, 0.0))
    for a, r in ((ours.trees.features, ref.trees.features),
                 (ours.trees.thresholds, ref.trees.thresholds),
                 (ours.trees.centroids, ref.trees.centroids)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))
    np.testing.assert_allclose(ours.lut.numpy(), np.asarray(ref.lut), rtol=1e-6, atol=1e-6)
    assert (ours.num_groups, ours.num_centroids, ours.out_features, ours.in_features) == \
        (ref.num_groups, ref.num_centroids, ref.out_features, ref.in_features)

    x = calib[:40]
    for ours_fn, ref_fn in ((amm.apply_gather, jamm.apply_gather),
                            (amm.apply_onehot, jamm.apply_onehot)):
        np.testing.assert_allclose(ours_fn(ours, torch.as_tensor(x)).numpy(),
                                   np.asarray(ref_fn(ref, jnp.asarray(x))),
                                   rtol=1e-5, atol=1e-5)


def test_adamw_and_schedule_match():
    rng = np.random.default_rng(6)
    params = {"w": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(3,)).astype(np.float32)}
    sched, jsched = (optimizer.cosine_schedule(3e-3, 5, 40),
                     jopt.cosine_schedule(3e-3, 5, 40))
    steps = np.arange(0, 50, dtype=np.int32)
    np.testing.assert_allclose(sched(torch.as_tensor(steps)).numpy(),
                               np.asarray(jsched(jnp.asarray(steps))), rtol=1e-6, atol=1e-9)

    p = {k: torch.as_tensor(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st, jst = optimizer.adamw_init(p), jopt.adamw_init(jp)
    for i in range(4):
        # step 2 has a large gradient, so the global-norm clip engages
        g = {k: (rng.normal(size=v.shape) * (50.0 if i == 2 else 0.3)).astype(np.float32)
             for k, v in params.items()}
        p, st, gn = optimizer.adamw_update(
            p, {k: torch.as_tensor(v) for k, v in g.items()}, st,
            lr=sched(st.step), weight_decay=1e-4)
        jp, jst, jgn = jopt.adamw_update(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, jst,
            lr=jsched(jst.step), weight_decay=1e-4)
        np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-6)
        for k in params:
            np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(st.v[k].numpy(), np.asarray(jst.v[k]), rtol=1e-6, atol=1e-9)
    assert int(st.step) == int(jst.step) == 4


def test_losses_and_metrics_match():
    rng = np.random.default_rng(8)
    logits = rng.normal(size=(30, 4)).astype(np.float32) * 3
    labels = rng.integers(0, 4, size=30).astype(np.int32)
    np.testing.assert_allclose(
        float(common.xent(torch.as_tensor(logits), torch.as_tensor(labels))),
        float(jcommon.xent(jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6)
    pred = logits.argmax(-1)
    assert common.macro_f1(pred, labels, 4) == jcommon.macro_f1(pred, labels, 4)
    assert common.precision_recall(pred, labels, 4) == jcommon.precision_recall(pred, labels, 4)


def test_mlp_forward_matches_reference_teacher():
    """A JAX-initialised teacher carried over through interop runs the same
    forward in the port."""
    params = {k: np.asarray(v) for k, v in jmlp.init_mlp(16, 3, seed=2).items()}
    rng = np.random.default_rng(2)
    x = rng.integers(0, 256, size=(25, 16)).astype(np.float32)
    mu, sigma = x.mean(0), x.std(0) + 1e-3
    bundle = interop.mlp_from_arrays(params, mu, sigma, 3, device="cpu")
    ref = jmlp.MLPB(params={k: jnp.asarray(v) for k, v in params.items()},
                    mu=mu, sigma=sigma, num_classes=3)
    np.testing.assert_allclose(mlp.mlp_apply(bundle, torch.as_tensor(x)).numpy(),
                               np.asarray(jmlp.mlp_apply(ref, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    # the port trains on its own: a few steps lower the loss
    y = rng.integers(0, 3, size=25)
    trained = common.train_classifier(
        {k: v.clone() for k, v in bundle.params.items()},
        lambda p, xb: mlp.mlp_apply(p, xb, bundle.mu, bundle.sigma), x, y,
        steps=30, batch_size=25, lr=1e-2)
    before = common.xent(mlp.mlp_apply(bundle, torch.as_tensor(x)), torch.as_tensor(y))
    after = common.xent(mlp.mlp_apply(trained, torch.as_tensor(x), bundle.mu, bundle.sigma),
                        torch.as_tensor(y))
    assert float(after) < float(before)


def test_pegasusify_refine_waits_for_later_slice():
    """``refine_steps > 0`` refines the banks (it raised before refinement
    was ported): same trees' structure, new thresholds, LUT and bias."""
    params = mlp.init_mlp(16, 3, device="cpu")
    bundle = mlp.MLPB(params, torch.zeros(16), torch.ones(16), 3)
    x = np.random.default_rng(0).normal(size=(64, 16)).astype(np.float32)
    plain = mlp.pegasusify_mlp(bundle, x, depth=2, refine_steps=0)
    refined = mlp.pegasusify_mlp(bundle, x, depth=2, refine_steps=5)
    for a, b in zip(plain, refined):
        assert torch.equal(a.trees.features, b.trees.features)
        assert not torch.equal(a.lut, b.lut) and torch.isfinite(b.lut).all()
        assert b.lut.dtype == a.lut.dtype and b.bias is not None


def test_port_imports_no_jax():
    """Importing every module of the port, and chip_smoke.py, pulls in
    neither jax nor repro."""
    code = (
        "import importlib, importlib.util, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n.startswith('jaxlib') or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "for n in ('engine.registry', 'nets.rnn', 'nets.cnn', 'nets.autoencoder',\n"
        "          'analysis.sanitizer', 'launch.health', 'launch.scheduler',\n"
        "          'launch.chaos', 'launch.devices', 'launch.serve', 'core.finetune',\n"
        "          'core.primitives', 'core.syntax', 'core.fusion',\n"
        "          'nets.baselines.n3ic', 'nets.baselines.bos', 'nets.baselines.leo',\n"
        "          'models.transformer', 'models.pegasus_layer', 'configs.registry',\n"
        "          'configs.qwen2_vl_2b', 'launch.train', 'train.checkpoint'):\n"
        "    assert 'repro_torch.' + n in sys.modules, n\n"
        "serve = sys.modules['repro_torch.launch.serve']\n"
        "assert serve.MultiModelServer and serve.AsyncMultiModelServer and serve.Server\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 32


def test_no_silent_cpu():
    """Entry points default to the GPU and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.engine import build_plan, plan_for
    from repro_torch.nets import autoencoder, cnn, rnn

    layer = amm.init_pegasus_linear(*_dense_layer(1), group_size=3, depth=2, device="cpu")
    for call in (lambda: resolve_device(), lambda: resolve_device(None),
                 lambda: build_plan([layer]), lambda: plan_for([layer]),
                 lambda: mlp.init_mlp(16, 3), lambda: rnn.init_rnn(3),
                 lambda: cnn.init_cnn(3, 16, 24), lambda: cnn.init_cnn_l(3),
                 lambda: autoencoder.init_ae(24),
                 lambda: mlp.pegasus_mlp_apply([layer], np.zeros((2, 3), np.float32)),
                 lambda: amm.init_pegasus_linear(*_dense_layer(1), group_size=3, depth=2),
                 lambda: interop.pegasus_linear_from_arrays(
                     layer.trees.features.numpy(), layer.trees.thresholds.numpy(),
                     layer.trees.centroids.numpy(), layer.lut.numpy(), None, 3)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
