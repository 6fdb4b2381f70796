"""The port's refinement hooks of the net families, its baselines (N3IC,
BoS, Leo) and its Partition/Map/SumReduce IR against the JAX reference, on
the CPU.

Families (48 flows per class, 5 teacher steps, small depths, 10 refinement
steps): the reference's teacher is carried into the port, both packages
pegasusify it with ``refine_steps`` on the JAX minibatch sequence
(``finetune._batch_indices`` replaced as in tests/test_torch_refine.py),
and the refined banks must agree — thresholds, LUT and bias within 1e-4
(measured at most, printed with ``-rP``: thresholds 1.4e-6, LUT 1.4e-5
on an RNN h-bank, bias 3.3e-7) — as must the served outputs, the port's on ``kernel`` (the plain
versions here) against the reference's ``gather``, within rtol = atol =
1e-4.

Baselines: ``binarize`` exact with an equal straight-through gradient;
``n3ic_apply``/``bos_apply`` on carried parameters within 1e-4;
``leo_predict`` exact on a carried tree. The IR: the same op lists and
evaluated outputs within rtol = 1e-4, atol = 1e-5 (the reference's own).
"""

import torch_threads  # noqa: F401  (this worker's share of the cores)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fusion as jfusion
from repro.core import primitives as jprim
from repro.core import syntax as jsyntax
from repro.data.synthetic_traffic import make_dataset
from repro.engine import build_plan as jax_build_plan
from repro.nets import cnn as jcnn
from repro.nets import mlp as jmlp
from repro.nets import rnn as jrnn
from repro.nets.baselines import bos as jbos
from repro.nets.baselines import leo as jleo
from repro.nets.baselines import n3ic as jn3ic
from repro_torch import interop
from repro_torch.core import finetune, fusion, primitives, syntax
from repro_torch.engine import build_plan
from repro_torch.nets import cnn, common, mlp, rnn
from repro_torch.nets.baselines import bos, leo, n3ic

from test_torch_refine import jax_batch_indices

TOL = 1e-4
FLOWS, STEPS, REFINE = 48, 5, 10


@pytest.fixture(scope="module")
def ds():
    return make_dataset("peerrush", flows_per_class=FLOWS)


def _np(params: dict) -> dict:
    return {k: np.asarray(v) for k, v in params.items()}


def _close_banks(got, want):
    """A refined port bank against the reference's: trees' structure
    exact, thresholds (with their +inf) and LUT and bias within TOL."""
    np.testing.assert_array_equal(got.trees.features.numpy(), np.asarray(want.trees.features))
    np.testing.assert_array_equal(got.trees.centroids.numpy(),
                                  np.asarray(want.trees.centroids))
    for a, b in ((got.trees.thresholds, want.trees.thresholds), (got.lut, want.lut),
                 (got.bias, want.bias)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL, atol=TOL)


def _refined(ds, family, monkeypatch):
    """(reference refined model, port refined model, served inputs)."""
    monkeypatch.setattr(finetune, "_batch_indices", jax_batch_indices)
    tr = ds.train
    if family == "mlp":
        m = jmlp.train_mlp(tr["stats"], tr["label"], ds.num_classes, steps=STEPS)
        x = tr["stats"].astype(np.float32)
        want = jmlp.pegasusify_mlp(m, x, depth=3, refine_steps=REFINE)
        # The hidden banks are fit on the teacher's pre-activations, which the
        # two frameworks compute a few ulps apart: fit_tree's SSE search can
        # then pick another split among near-equal candidates, and centroids
        # move by an ulp. Feeding the port the reference's activations holds
        # the refinement wiring alone.
        acts = [np.array(a) for a in jmlp._activations(m, x)]
        monkeypatch.setattr(mlp, "_activations", lambda bundle, xc: acts)
        teacher = interop.mlp_from_arrays(_np(m.params), m.mu, m.sigma, ds.num_classes, "cpu")
        got = mlp.pegasusify_mlp(teacher, x, depth=3, refine_steps=REFINE)
        return want, got, (ds.test["stats"][:16].astype(np.float32),)
    if family == "rnn":
        m = jrnn.train_rnn(tr["seq"], tr["label"], ds.num_classes, steps=STEPS)
        want = jrnn.pegasusify_rnn(m, tr["seq"], depth=4, refine_steps=REFINE)
        # the h-banks are fit on pre-activations too (see the MLP above)
        pres = [torch.tensor(np.array(a)) for a in jrnn._pre_activations(m, tr["seq"])]
        monkeypatch.setattr(rnn, "_pres", lambda p, xc: pres)
        teacher = interop.rnn_teacher_from_arrays(_np(m.params), ds.num_classes, m.window,
                                                  "cpu")
        got = rnn.pegasusify_rnn(teacher, tr["seq"], depth=4, refine_steps=REFINE)
        return want, got, (ds.test["seq"][:16],)
    m = jcnn.train_cnn(tr["seq"], tr["label"], ds.num_classes, size="M", steps=STEPS)
    want = jcnn.pegasusify_cnn(m, tr["seq"], depth=5, refine_steps=REFINE)
    teacher = interop.cnn_teacher_from_arrays(_np(m.params), ds.num_classes, "M", "cpu")
    got = cnn.pegasusify_cnn(teacher, tr["seq"], depth=5, refine_steps=REFINE)
    return want, got, (ds.test["seq"][:16],)


@pytest.mark.parametrize("family", ["mlp", "rnn", "cnn_m"])
def test_family_refinement_matches_reference(ds, family, monkeypatch):
    want, got, inputs = _refined(ds, family, monkeypatch)
    if family == "mlp":
        pairs = list(zip(got, want))
    elif family == "rnn":
        pairs = list(zip(got.h_banks, want.h_banks))
        for a, b in zip(got.x_banks, want.x_banks):      # not refined
            np.testing.assert_allclose(a.lut.numpy(), np.asarray(b.lut), rtol=1e-5, atol=1e-5)
    else:
        pairs = [(got.window_bank, want.window_bank)]
    assert len(pairs) == {"mlp": 4, "rnn": 7, "cnn_m": 1}[family]
    diffs = {name: max(float(np.nan_to_num(np.abs(get(a).numpy() - np.asarray(get(b)))).max())
                       for a, b in pairs)
             for name, get in (("thresholds", lambda l: l.trees.thresholds),
                               ("lut", lambda l: l.lut), ("bias", lambda l: l.bias))}
    print(f"{family} refined banks, max |diff| port vs reference: "
          + ", ".join(f"{name} {d:.3g}" for name, d in diffs.items()))
    for a, b in pairs:
        _close_banks(a, b)
    ref_out = np.asarray(jax_build_plan(want, audit="off")(
        *(jnp.asarray(x) for x in inputs), backend="gather"))
    out = build_plan(got, device="cpu")(*inputs, backend="kernel")
    np.testing.assert_allclose(out.numpy(), ref_out, rtol=TOL, atol=TOL)


def test_refinement_moves_only_the_refined_banks(ds):
    """In the port alone: refinement leaves the features, centroids and the
    unrefined banks as they were, and lowers each refined bank's hard
    error on its calibration data."""
    tr = ds.train
    teacher = mlp.train_mlp(tr["stats"], tr["label"], 3, steps=STEPS, device="cpu")
    x = tr["stats"].astype(np.float32)
    plain = mlp.pegasusify_mlp(teacher, x, depth=3, refine_steps=0)
    refined = mlp.pegasusify_mlp(teacher, x, depth=3)            # the default: 100 steps
    acts = mlp._activations(teacher, x)
    with torch.no_grad():
        logits = mlp.mlp_apply(teacher, torch.as_tensor(x))
    targets = acts[1:] + [logits]
    for i, (a, b) in enumerate(zip(plain, refined)):
        assert torch.equal(a.trees.features, b.trees.features)
        assert torch.equal(a.trees.centroids, b.trees.centroids)
        assert not torch.equal(a.lut, b.lut)
        assert finetune.hard_mse(b, acts[i], targets[i]) < finetune.hard_mse(a, acts[i],
                                                                              targets[i])


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------


def test_binarize_forward_and_ste():
    x = np.array([-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 1.5], np.float32)
    xt = torch.tensor(x, requires_grad=True)
    y = n3ic.binarize(xt)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jn3ic.binarize(jnp.asarray(x))))
    np.testing.assert_array_equal(y.detach().numpy(), [-1, -1, -1, 1, 1, 1, 1])
    w = torch.arange(1.0, 8.0)
    (g,) = torch.autograd.grad((y * w).sum(), xt)
    jg = jax.grad(lambda v: (jn3ic.binarize(v) * jnp.arange(1.0, 8.0)).sum())(jnp.asarray(x))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(g.numpy(), [0, 2, 3, 4, 5, 6, 0])


def test_n3ic_and_bos_forward_match(ds):
    tr, te = ds.train, ds.test
    jm = jn3ic.train_n3ic(tr["stats"], tr["label"], 3, steps=STEPS)
    ours = interop.n3ic_from_arrays(_np(jm.params), jm.mu, jm.sigma, 3, device="cpu")
    np.testing.assert_allclose(
        n3ic.n3ic_apply(ours, te["stats"]).numpy(),
        np.asarray(jn3ic.n3ic_apply(jm, jnp.asarray(te["stats"]))), rtol=TOL, atol=TOL)
    assert n3ic.n3ic_model_bits(ours) == jn3ic.n3ic_model_bits(jm)

    jb = jbos.train_bos(tr["seq"], tr["label"], 3, steps=STEPS)
    ours_b = interop.bos_from_arrays(_np(jb.params), 3, device="cpu")
    np.testing.assert_allclose(
        bos._bucketize(torch.as_tensor(te["seq"])).numpy(),
        np.asarray(jbos._bucketize(jnp.asarray(te["seq"]))))
    np.testing.assert_allclose(bos.bos_apply(ours_b, te["seq"]).numpy(),
                               np.asarray(jbos.bos_apply(jb, jnp.asarray(te["seq"]))),
                               rtol=TOL, atol=TOL)
    assert bos.bos_table_entries() == jbos.bos_table_entries()


def test_leo_predicts_exactly(ds):
    tr, te = ds.train, ds.test
    jt = jleo.train_leo(tr["stats"], tr["label"], 3, max_nodes=64)
    carried = interop.leo_from_arrays(*(np.array([getattr(n, f) for n in jt.nodes])
                                        for f in ("feature", "threshold", "left", "right",
                                                  "label")), 3)
    np.testing.assert_array_equal(leo.leo_predict(carried, te["stats"]),
                                  jleo.leo_predict(jt, te["stats"]))
    own = leo.train_leo(tr["stats"], tr["label"], 3, max_nodes=64)
    assert own.node_count == jt.node_count
    np.testing.assert_array_equal(leo.leo_predict(own, te["stats"]),
                                  jleo.leo_predict(jt, te["stats"]))


def test_port_trains_baselines(ds):
    """N3IC and BoS train in the port on its own generators: finite logits
    and a training loss below the untrained one."""
    tr = ds.train
    y = torch.as_tensor(tr["label"])
    m = n3ic.train_n3ic(tr["stats"], tr["label"], 3, steps=40, device="cpu")
    init = n3ic.init_n3ic(16, 3, device="cpu")
    xs = tr["stats"]
    assert common.xent(n3ic.n3ic_apply(m, xs), y) < common.xent(
        n3ic.n3ic_apply(init, torch.as_tensor(xs), m.mu, m.sigma), y)
    b = bos.train_bos(tr["seq"], tr["label"], 3, steps=40, device="cpu")
    logits = bos.bos_apply(b, tr["seq"])
    assert logits.shape == (len(y), 3) and torch.isfinite(logits).all()
    assert common.xent(logits, y) < common.xent(
        bos.bos_apply(bos.init_bos(3, device="cpu"), tr["seq"]), y)


# ---------------------------------------------------------------------------
# The primitive IR: tests/test_core.py:117-212 and tests/test_syntax.py
# ---------------------------------------------------------------------------


def _mlp_graphs(seed, gamma, beta):
    """tests/test_core.py's BN → FC → ReLU → FC chain in both packages."""
    rng = np.random.default_rng(seed)
    w1 = rng.normal(size=(4, 8)).astype(np.float32)
    b1 = rng.normal(size=(8,)).astype(np.float32)
    w2 = rng.normal(size=(8, 3)).astype(np.float32)
    beta = rng.normal(size=(2, 2)).astype(np.float32) if beta is None else beta
    x = rng.normal(size=(16, 4)).astype(np.float32)

    def build(P, fus, xp, relu, t):
        w1_, b1_, w2_, beta_ = (t(a) for a in (w1, b1, w2, beta))
        return P.PrimitiveGraph([
            P.PartitionOp(dim=2, name="part"),
            P.MapOp(fn=lambda xg: gamma * xg, linear=True, in_dim=2, out_dim=2,
                    table_entries=16, bias=beta_, name="bn"),
            P.MapOp(fn=lambda xg: xp.einsum("...kv,kvn->...kn", xg, w1_.reshape(2, 2, -1)),
                    linear=True, in_dim=2, out_dim=8, table_entries=16, name="fc1"),
            P.SumReduceOp(),
            P.MapOp(fn=fus.identity, linear=True, in_dim=8, out_dim=8, table_entries=0,
                    bias=b1_, name="bias1"),
            P.MapOp(fn=relu, linear=False, in_dim=8, out_dim=8, table_entries=16, name="relu"),
            P.MapOp(fn=lambda h: h @ w2_, linear=True, in_dim=8, out_dim=3, table_entries=16,
                    name="fc2"),
        ])

    ours = build(primitives, fusion, torch, torch.relu, torch.as_tensor)
    ref = build(jprim, jfusion, jnp, jax.nn.relu, jnp.asarray)
    return ours, ref, x


def _same(ours, ref, x, rtol=1e-4, atol=1e-5):
    assert ours.describe() == ref.describe()
    assert (ours.num_lookups(), ours.table_entries()) == (ref.num_lookups(), ref.table_entries())
    for a, b in zip(ours.ops, ref.ops):
        assert type(a).__name__ == type(b).__name__
        if isinstance(a, primitives.MapOp):
            assert (a.linear, a.in_dim, a.out_dim, a.table_entries, a.name) == \
                (b.linear, b.in_dim, b.out_dim, b.table_entries, b.name)
    np.testing.assert_allclose(ours.evaluate(torch.as_tensor(x)).numpy(),
                               np.asarray(ref.evaluate(jnp.asarray(x))), rtol=rtol, atol=atol)


@pytest.mark.parametrize("fuse", ["none", "basic", "remove_nonlinear", "nam"])
def test_fusion_passes_match(fuse):
    gamma, beta = (1.3, None) if fuse in ("none", "basic") else (1.0, np.zeros((2, 2),
                                                                               np.float32))
    ours, ref, x = _mlp_graphs(4, gamma, beta)
    if fuse == "basic":
        ours, ref = fusion.fuse_basic(ours), jfusion.fuse_basic(ref)
        assert ours.num_lookups() < 5
    elif fuse == "remove_nonlinear":
        ours, ref = fusion.advanced_remove_nonlinear(ours), jfusion.advanced_remove_nonlinear(ref)
    elif fuse == "nam":
        ours, ref = fusion.advanced_nam(ours), jfusion.advanced_nam(ref)
        assert ours.num_lookups() == 1
    _same(ours, ref, x)
    assert [type(op).__name__ for op in fusion.merge_consecutive_maps(
        fusion.linear_reorder(_mlp_graphs(4, gamma, beta)[0])).ops] == \
        [type(op).__name__ for op in jfusion.merge_consecutive_maps(
            jfusion.linear_reorder(_mlp_graphs(4, gamma, beta)[1])).ops]


def test_functional_primitives_match():
    x = np.arange(24.0, dtype=np.float32).reshape(2, 12)
    for dim, stride in ((4, None), (4, 2), (3, 3)):
        got = primitives.partition(torch.as_tensor(x), dim, stride)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jprim.partition(jnp.asarray(x),
                                                                              dim, stride)))
    xg = primitives.partition(torch.as_tensor(x), 4)
    np.testing.assert_array_equal(primitives.unpartition(xg).numpy(), x)
    np.testing.assert_array_equal(primitives.sum_reduce(xg).numpy(),
                                  np.asarray(jprim.sum_reduce(jnp.asarray(xg.numpy()))))
    fns = [lambda g, i=i: g * (i + 1) for i in range(3)]
    np.testing.assert_array_equal(
        primitives.map_apply(fns, xg).numpy(),
        np.asarray(jprim.map_apply(fns, jnp.asarray(xg.numpy()))))
    np.testing.assert_array_equal(primitives.map_apply(lambda g: g + 1, xg).numpy(),
                                  xg.numpy() + 1)


def _fig6(P, xp, w):
    return P.program(
        P.partition(dim=2, stride=2),
        P.map_op(clustering_depth=4, fn=lambda xg: xp.einsum("...kv,kvn->...kn", xg, w),
                 linear=True, out_dim=8, name="cnn_kernel"),
        P.sumreduce())


def test_translate_matches():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(4, 2, 8)).astype(np.float32)
    w2 = rng.normal(size=(8, 3)).astype(np.float32)
    x = rng.normal(size=(5, 8)).astype(np.float32)
    ours = syntax.translate(_fig6(syntax, torch, torch.as_tensor(w)), input_dim=8)
    ref = jsyntax.translate(_fig6(jsyntax, jnp, jnp.asarray(w)), input_dim=8)
    _same(ours, ref, x, rtol=1e-5)
    assert ours.table_entries() == 16

    def chain(P, xp, t):
        return P.program(
            P.partition(dim=2, stride=2),
            P.map_op(clustering_depth=4, linear=True, out_dim=8,
                     fn=lambda xg: xp.einsum("...kv,kvn->...kn", xg, t(w))),
            P.sumreduce(),
            P.map_op(clustering_depth=8, fn=lambda h: h @ t(w2), linear=True))  # width inferred

    ours = syntax.translate(chain(syntax, torch, torch.as_tensor), input_dim=8)
    ref = jsyntax.translate(chain(jsyntax, jnp, jnp.asarray), input_dim=8)
    assert ours.ops[-1].out_dim == 3
    _same(ours, ref, x)
    _same(fusion.fuse_basic(ours), jfusion.fuse_basic(ref), x)


@pytest.mark.parametrize("bad,msg", [
    ([{"op": "Partition", "dim": 3, "stride": None}], "does not tile"),
    ([{"op": "SumReduce"}], "SumReduce before"),
    ([{"op": "Partition", "dim": 2, "stride": None}] * 2, "nested Partition"),
    ([{"op": "Conv"}], "unknown op"),
    ([{"op": "Partition", "dim": 2, "stride": None},
      {"op": "Map", "clustering_depth": 0, "fn": None, "out_dim": 2, "linear": False,
       "bias": None, "name": ""}], "out of range"),
])
def test_translate_rejects_illformed(bad, msg):
    with pytest.raises(syntax.SyntaxError_, match=msg):
        syntax.translate(bad, input_dim=8)
    with pytest.raises(jsyntax.SyntaxError_, match=msg):
        jsyntax.translate(bad, input_dim=8)


def test_chip_smoke_refinement_rehearsal():
    """chip_smoke.py's phase 7 in process at tiny size on the CPU: the
    refined MLP-B served (kernel equal to gather), the baselines and the
    CNN-M window-bank refine."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cpu = torch.device("cpu")
    res = smoke.main_path(cpu, flows_per_class=FLOWS, steps=STEPS, depth=3, n_serve=200)
    fams = {name: smoke.family_path(name, res["ds"], cpu, steps=STEPS, tiny=True, n_serve=200)
            for name in ("rnn", "cnn_m")}
    out = smoke.refinement_phase(res, fams, cpu, "the CPU", baseline_steps=5, cnn_m_steps=3)
    for fuse in (True, False):
        assert out["runs"][("kernel", fuse)]["max_abs_err"] == 0.0
        assert max(out["runs"][("kernel_q8", fuse)]["bank_rel"]) < 0.12
    assert len(out["mse"]) == 4 and all(after < before for before, after in out["mse"])
    assert set(out["f1"]) == {"MLP-B (refined)", "MLP-B (unrefined)", "RNN-B", "N3IC", "BoS",
                              "Leo"}
    assert np.isfinite(out["cnn_m"][1])
