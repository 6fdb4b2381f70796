"""The port's RNN, CNN-B, CNN-M (NAM), CNN-L and AutoEncoder families
against the JAX reference, on the CPU.

Each family is trained and pegasusified by the JAX package at the sizes of
tests/test_engine.py (48 flows per class, 5 training steps, batch 16, the
depths given there, ``index_bits=3``), carried across with
``repro_torch.interop`` and run through the port's plan. Tolerances are the
reference's own:
  * ``gather``/``onehot``/``kernel`` within rtol = atol = 1e-4 of the
    reference ``gather`` (sum order differs between the frameworks);
  * the port's ``kernel_q8`` within 1e-4 of the reference ``kernel_q8``
    (the int8 codes are bit-exact), every bank's ``kernel_q8`` within a
    relative error of 0.12 of its ``gather`` on the bank's real inputs,
    and argmax agreement ≥ 0.75;
  * teacher forwards within 1e-5 for the same parameters;
  * banks the port pegasusifies from the JAX teacher's parameters: trees
    bit-equal and LUTs within 1e-5 where the calibration is a raw input;
    plan outputs within the tolerances above where it is a computed
    activation (matmul ulps may move a threshold there).
"""

import torch_threads  # noqa: F401  (this worker's share of the cores)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic_traffic import anomaly_testset as jax_anomaly_testset
from repro.data.synthetic_traffic import make_dataset as jax_make_dataset
from repro.engine import build_plan as jax_build_plan
from repro.nets import autoencoder as jae
from repro.nets import cnn as jcnn
from repro.nets import rnn as jrnn
from repro_torch import interop
from repro_torch.data.synthetic_traffic import anomaly_testset, make_dataset
from repro_torch.engine import BACKENDS, STATS, build_plan, plan_for
from repro_torch.launch.request import InferRequest
from repro_torch.launch.serve import PegasusServer
from repro_torch.nets import autoencoder as ae
from repro_torch.nets import cnn, mlp, rnn

TOL = 1e-4
FLOWS, STEPS, BATCH = 48, 5, 16
FAMILIES = ["rnn", "cnn_b", "cnn_m", "cnn_l", "ae"]


@pytest.fixture(scope="module")
def ds():
    return jax_make_dataset("peerrush", flows_per_class=FLOWS)


def _arrays(b) -> dict:
    """A JAX PegasusLinear as the keyword arguments of
    ``interop.pegasus_linear_from_arrays``."""
    return dict(features=np.asarray(b.trees.features),
                thresholds=np.asarray(b.trees.thresholds),
                centroids=np.asarray(b.trees.centroids), lut=np.asarray(b.lut),
                bias=None if b.bias is None else np.asarray(b.bias),
                group_size=b.group_size)


def _np(params: dict) -> dict:
    return {k: np.asarray(v) for k, v in params.items()}


def _carry(family, peg):
    """The reference's pegasusified model in the port, on the CPU."""
    if family == "rnn":
        return interop.rnn_from_arrays([_arrays(b) for b in peg.x_banks],
                                       [_arrays(b) for b in peg.h_banks],
                                       _arrays(peg.out_bank), peg.window, device="cpu")
    if family in ("cnn_b", "cnn_m"):
        return interop.cnn_from_arrays(
            _arrays(peg.window_bank), [_arrays(b) for b in peg.head_banks],
            None if peg.out_bias is None else np.asarray(peg.out_bias), peg.nam,
            peg.pool_windows, device="cpu")
    if family == "cnn_l":
        t = peg.emb_tree
        return interop.cnn_l_from_arrays(
            _arrays(peg.bank1), _arrays(peg.bank2),
            dict(features=np.asarray(t.features), thresholds=np.asarray(t.thresholds),
                 centroids=np.asarray(t.centroids)),
            np.asarray(peg.logit_lut), np.asarray(peg.bias), peg.index_bits, device="cpu")
    return interop.ae_banks_from_arrays([_arrays(b) for b in peg], peg.feat_mu,
                                        peg.feat_sigma, device="cpu")


def _reference(ds, family):
    """(teacher, pegasusified model, inputs as numpy) built by the JAX package."""
    tr = ds.train
    if family == "rnn":
        m = jrnn.train_rnn(tr["seq"], tr["label"], ds.num_classes, steps=STEPS)
        return m, jrnn.pegasusify_rnn(m, tr["seq"], depth=4), (ds.test["seq"][:BATCH],)
    if family in ("cnn_b", "cnn_m"):
        m = jcnn.train_cnn(tr["seq"], tr["label"], ds.num_classes, size=family[-1].upper(),
                           steps=STEPS)
        return m, jcnn.pegasusify_cnn(m, tr["seq"], depth=5), (ds.test["seq"][:BATCH],)
    if family == "cnn_l":
        m = jcnn.train_cnn_l(tr["seq"], tr["bytes"], tr["label"], ds.num_classes, steps=STEPS)
        peg = jcnn.pegasusify_cnn_l(m, tr["seq"], tr["bytes"], enc_depth=4, index_bits=3)
        return m, peg, (ds.test["seq"][:BATCH], ds.test["bytes"][:BATCH])
    x = tr["seq"].reshape(len(tr["label"]), -1)
    m = jae.train_autoencoder(x, steps=STEPS)
    banks = jae.pegasusify_ae(m, x.astype(np.float32), depth=4)
    xt = ds.test["seq"][:BATCH].reshape(BATCH, -1)
    # the AE bank stack consumes the engineered feature view
    return m, banks, (np.array(jae.anomaly_features(jnp.asarray(xt, jnp.float32))),)


_BUILT: dict = {}


def _family(ds, family) -> dict:
    """Per family, built once: the reference's teacher, model, plan outputs
    on gather and kernel_q8, and the carried model with its port plan."""
    if family not in _BUILT:
        teacher, peg, inputs = _reference(ds, family)
        jplan = jax_build_plan(peg, audit="off")
        outs = {be: np.asarray(jplan(*(jnp.asarray(x) for x in inputs), backend=be))
                for be in ("gather", "kernel_q8")}
        model = _carry(family, peg)
        _BUILT[family] = dict(teacher=teacher, peg=peg, inputs=inputs, outs=outs,
                              model=model, plan=build_plan(model, device="cpu"))
    return _BUILT[family]


def _q8_bank_rels(plan, inputs) -> list[float]:
    """Each bank's kernel_q8 relative error from its gather, on the real
    inputs the plan feeds it."""
    rels = []
    for bank, xb in zip(plan.banks, plan.bank_inputs(*inputs)):
        yg, yq = bank.apply(xb, "gather"), bank.apply(xb, "kernel_q8")
        rels.append(float(torch.linalg.norm(yq - yg))
                    / max(float(torch.linalg.norm(yg)), 1e-6))
    return rels


@pytest.mark.parametrize("family", FAMILIES)
def test_family_plan_matches_reference(ds, family):
    f = _family(ds, family)
    plan, inputs, outs = f["plan"], f["inputs"], f["outs"]
    for be in BACKENDS:
        out = plan(*inputs, backend=be)
        assert out.dtype == torch.float32 and out.shape == outs["gather"].shape
        want = outs["kernel_q8" if be == "kernel_q8" else "gather"]
        np.testing.assert_allclose(out.numpy(), want, rtol=TOL, atol=TOL,
                                   err_msg=f"{family}:{be}")
    assert max(_q8_bank_rels(plan, inputs)) < 0.12
    if family != "ae":
        outq = plan(*inputs, backend="kernel_q8").numpy()
        assert (outq.argmax(-1) == outs["gather"].argmax(-1)).mean() >= 0.75


def test_family_plan_structure(ds):
    """Bank counts, families, fusion and the non-bank state each plan
    freezes match the reference's plans."""
    for family in FAMILIES:
        f = _family(ds, family)
        jplan = jax_build_plan(f["peg"], audit="off")
        plan = f["plan"]
        assert plan.family == jplan.family and plan.num_banks == jplan.num_banks, family
        assert (plan.fused_groups, plan.fused_banks) == (jplan.fused_groups,
                                                         jplan.fused_banks), family
        assert plan.fuse_cfg == jplan.fuse_cfg
    assert _family(ds, "cnn_b")["plan"].fused_groups == 1       # the two heads
    assert _family(ds, "ae")["plan"].fused_banks == 4


def test_ae_reference_kernel_q8_drift(ds):
    """The reference's own AutoEncoder drifts end to end on kernel_q8
    (test_engine.py::test_backend_parity[ae] holds it to a relative error
    of 0.25 and fails): a property of the reference, not of the port. The
    port reproduces the reference's kernel_q8 output, drift included."""
    f = _family(ds, "ae")
    ref, refq = f["outs"]["gather"], f["outs"]["kernel_q8"]
    ref_rel = float(np.linalg.norm(refq - ref) / np.linalg.norm(ref))
    assert ref_rel > 0.25
    outq = f["plan"](*f["inputs"], backend="kernel_q8").numpy()
    port_rel = float(np.linalg.norm(outq - ref) / np.linalg.norm(ref))
    assert port_rel == pytest.approx(ref_rel, rel=1e-3, abs=1e-4)


def _teacher_inputs(rng, family):
    seq = rng.integers(0, 256, size=(20, 8, 2)).astype(np.uint8)
    if family == "cnn_l":
        return seq, rng.integers(0, 256, size=(20, 8, 60)).astype(np.uint8)
    if family == "ae":
        return (seq.reshape(20, -1),)
    return (seq,)


@pytest.mark.parametrize("family", FAMILIES)
def test_teacher_forward_matches(family):
    """A JAX-initialised teacher carried over runs the same forward."""
    rng = np.random.default_rng(FAMILIES.index(family))
    inputs = _teacher_inputs(rng, family)
    if family == "rnn":
        params = _np(jrnn.init_rnn(3, seed=1))
        want = jrnn.rnn_apply(params, *inputs)
        got = rnn.rnn_apply(interop.rnn_teacher_from_arrays(params, 3, 8, "cpu").params,
                            torch.as_tensor(inputs[0]))
    elif family in ("cnn_b", "cnn_m"):
        widths = (16, 24) if family == "cnn_b" else (48, 64)
        params = _np(jcnn.init_cnn(3, *widths, seed=1))
        want = jcnn.cnn_apply(params, *inputs)
        teacher = interop.cnn_teacher_from_arrays(params, 3, family[-1].upper(), "cpu")
        assert (teacher.channels, teacher.hidden) == widths
        got = cnn.cnn_apply(teacher, torch.as_tensor(inputs[0]))
    elif family == "cnn_l":
        params = _np(jcnn.init_cnn_l(3, seed=1))
        want = jcnn.cnn_l_apply(params, *inputs)
        got = cnn.cnn_l_apply(interop.cnn_l_teacher_from_arrays(params, 3, "cpu"),
                              *(torch.as_tensor(x) for x in inputs))
    else:
        params = _np(jae.init_ae(24, seed=1))
        mu = rng.random(24).astype(np.float32)
        sigma = (rng.random(24) + 0.1).astype(np.float32)
        want = jae.ae_apply(jae.AutoEncoder(params, 24, mu, sigma), jnp.asarray(inputs[0]))
        teacher = interop.ae_from_arrays(params, mu, sigma, "cpu")
        got = ae.ae_apply(teacher, inputs[0])
        np.testing.assert_allclose(
            ae.reconstruction_error(teacher, inputs[0]).numpy(),
            np.asarray(jae.reconstruction_error(
                jae.AutoEncoder(params, 24, mu, sigma), jnp.asarray(inputs[0]))),
            rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _port_pegasusify(ds, family, teacher):
    """The port's pegasusification of the JAX teacher's parameters."""
    tr, p = ds.train, _np(teacher.params)
    if family == "rnn":
        t = interop.rnn_teacher_from_arrays(p, ds.num_classes, teacher.window, "cpu")
        return rnn.pegasusify_rnn(t, tr["seq"], depth=4)
    if family in ("cnn_b", "cnn_m"):
        t = interop.cnn_teacher_from_arrays(p, ds.num_classes, teacher.size, "cpu")
        return cnn.pegasusify_cnn(t, tr["seq"], depth=5)
    if family == "cnn_l":
        t = interop.cnn_l_teacher_from_arrays(p, ds.num_classes, "cpu")
        return cnn.pegasusify_cnn_l(t, tr["seq"], tr["bytes"], enc_depth=4, index_bits=3)
    t = interop.ae_from_arrays(p, teacher.feat_mu, teacher.feat_sigma, "cpu")
    return ae.pegasusify_ae(t, tr["seq"].reshape(len(tr["label"]), -1).astype(np.float32),
                            depth=4)


def _raw_banks(family, peg) -> list:
    """The banks calibrated on raw inputs."""
    if family == "rnn":
        return list(peg.x_banks)
    if family in ("cnn_b", "cnn_m"):
        return [peg.window_bank]
    if family == "cnn_l":
        return [peg.bank1]
    return []


@pytest.mark.parametrize("family", FAMILIES)
def test_port_pegasusify_matches_reference(ds, family):
    f = _family(ds, family)
    ours = _port_pegasusify(ds, family, f["teacher"])
    raw = list(zip(_raw_banks(family, ours), _raw_banks(family, f["peg"])))
    assert len(raw) == {"rnn": 8, "cnn_b": 1, "cnn_m": 1, "cnn_l": 1, "ae": 0}[family]
    for a, r in raw:
        for got, want in ((a.trees.features, r.trees.features),
                          (a.trees.thresholds, r.trees.thresholds),
                          (a.trees.centroids, r.trees.centroids)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_allclose(a.lut.numpy(), np.asarray(r.lut), rtol=1e-5, atol=1e-5)
    out = build_plan(ours, device="cpu")(*f["inputs"], backend="gather")
    np.testing.assert_allclose(out.numpy(), f["outs"]["gather"], rtol=TOL, atol=TOL)


def test_anomaly_data_matches_reference(ds):
    for kind in ("malware", "dos"):
        ours = anomaly_testset(make_dataset("peerrush", flows_per_class=FLOWS), kind=kind)
        ref = jax_anomaly_testset(ds, kind=kind)
        assert sorted(ours) == sorted(ref)
        for key in ref:
            assert ours[key].dtype == ref[key].dtype
            np.testing.assert_array_equal(ours[key], ref[key])
    x = ours["seq"].reshape(len(ours["label"]), -1)
    np.testing.assert_allclose(
        ae.anomaly_features(x).numpy(),
        np.asarray(jae.anomaly_features(jnp.asarray(x, jnp.float32))), rtol=1e-6, atol=1e-6)
    scores = np.random.default_rng(0).random(len(ours["label"]))
    assert ae.auc_score(scores, ours["label"]) == jae.auc_score(scores, ours["label"])


def test_port_trains_and_serves_each_family():
    """The port alone: train (a few steps), pegasusify and serve every
    family on the CPU through the ``pegasus_*_apply`` entry points, which
    memoize their plans in ``plan_for``."""
    d = make_dataset("peerrush", flows_per_class=FLOWS)
    tr, te = d.train, d.test
    x_ae = tr["seq"].reshape(len(tr["label"]), -1)
    kw = dict(steps=STEPS, device="cpu")
    models = {
        "rnn": (rnn.pegasusify_rnn(rnn.train_rnn(tr["seq"], tr["label"], 3, **kw),
                                   tr["seq"], depth=3),
                rnn.pegasus_rnn_apply, (te["seq"][:BATCH],)),
        "cnn_m": (cnn.pegasusify_cnn(cnn.train_cnn(tr["seq"], tr["label"], 3, size="M", **kw),
                                     tr["seq"], depth=4),
                  cnn.pegasus_cnn_apply, (te["seq"][:BATCH],)),
        "cnn_l": (cnn.pegasusify_cnn_l(
            cnn.train_cnn_l(tr["seq"], tr["bytes"], tr["label"], 3, **kw), tr["seq"],
            tr["bytes"], enc_depth=3, index_bits=3),
            cnn.pegasus_cnn_l_apply, (te["seq"][:BATCH], te["bytes"][:BATCH])),
        "ae": (ae.pegasusify_ae(ae.train_autoencoder(x_ae, **kw), x_ae, depth=3),
               ae.pegasus_ae_error, (te["seq"][:BATCH].reshape(BATCH, -1),)),
    }
    for name, (model, apply, inputs) in models.items():
        hits = STATS.plan_cache_hits
        outs = [apply(model, *inputs, backend=be, device="cpu") for be in BACKENDS]
        assert STATS.plan_cache_hits == hits + len(BACKENDS) - 1, name
        want = (BATCH,) if name == "ae" else (BATCH, 3)
        for be, out in zip(BACKENDS, outs):
            assert out.shape == want and torch.isfinite(out).all(), (name, be)
        torch.testing.assert_close(outs[2], outs[0], rtol=0, atol=0)   # kernel == gather
    mlp_banks = mlp.pegasusify_mlp(mlp.train_mlp(tr["stats"], tr["label"], 3, **kw),
                                   tr["stats"].astype(np.float32), depth=3, refine_steps=0)
    out = mlp.pegasus_mlp_apply(mlp_banks, te["stats"][:BATCH].astype(np.float32),
                                backend="kernel", device="cpu")
    assert plan_for(mlp_banks, device="cpu").family == "sequential" and out.shape == (BATCH, 3)


def test_server_serves_two_input_cnn_l(ds):
    """CNN-L takes (seq, payload); PegasusServer coalesces each input on
    its own, so typed two-input requests serve unchanged."""
    f = _family(ds, "cnn_l")
    seq, payload = f["inputs"]
    server = PegasusServer(f["model"], backend="kernel", device="cpu")
    reqs = [InferRequest("cnn-l", (seq[:5], payload[:5])),
            InferRequest("cnn-l", (seq[5:], payload[5:]))]
    out = np.concatenate([r.output for r in server.serve(reqs)])
    np.testing.assert_allclose(out, f["outs"]["gather"], rtol=TOL, atol=TOL)
    assert server.stats()["serving"]["batches_run"] == 1


@pytest.mark.parametrize("family", ["rnn", "cnn_m"])
def test_refine_waits_for_later_slice(ds, family):
    """``refine_steps > 0`` (it raised before refinement was ported) refines
    the RNN's h-banks and CNN-M's window bank and nothing else."""
    f = _family(ds, family)
    teacher = (interop.rnn_teacher_from_arrays(_np(f["teacher"].params), 3, 8, "cpu")
               if family == "rnn" else
               interop.cnn_teacher_from_arrays(_np(f["teacher"].params), 3, "M", "cpu"))
    peg = rnn.pegasusify_rnn if family == "rnn" else cnn.pegasusify_cnn
    depth = 4 if family == "rnn" else 5
    plain = peg(teacher, ds.train["seq"], depth=depth, refine_steps=0)
    refined = peg(teacher, ds.train["seq"], depth=depth, refine_steps=3)
    if family == "rnn":
        same = plain.x_banks + [plain.out_bank], refined.x_banks + [refined.out_bank]
        moved = plain.h_banks, refined.h_banks
    else:
        same, moved = ([], []), ([plain.window_bank], [refined.window_bank])
    for a, b in zip(*same):
        assert torch.equal(a.lut, b.lut) and torch.equal(a.trees.thresholds, b.trees.thresholds)
    assert len(moved[0]) == (7 if family == "rnn" else 1)
    for a, b in zip(*moved):
        assert torch.equal(a.trees.features, b.trees.features)
        assert not torch.equal(a.lut, b.lut) and torch.isfinite(b.lut).all()
    out = build_plan(refined, device="cpu")(ds.test["seq"][:BATCH], backend="kernel")
    assert out.shape == (BATCH, 3) and torch.isfinite(out).all()


def test_build_plan_rejects_unknown_structures():
    with pytest.raises(TypeError, match="don't know how to compile"):
        build_plan(object(), device="cpu")
    with pytest.raises(TypeError, match="only PegasusLinear"):
        build_plan([object()], device="cpu")


def test_chip_smoke_family_rehearsal():
    """chip_smoke.py's family phase and its family-geometry kernel checks,
    in process at tiny size on the CPU (plain versions), so its paths and
    arguments are right before any chip time is spent."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cpu = torch.device("cpu")
    recs = smoke.check_family_kernels(cpu, rows=16, time_it=False)
    assert len(recs) == 2 * (len(smoke.FAMILY_BANKS) + len(smoke.FAMILY_STACKS))
    assert all(r["max_abs_err"] == 0.0 and r["nbytes"] > 0 for r in recs)
    res = smoke.families_phase(cpu, flows_per_class=FLOWS, steps=STEPS, tiny=True,
                               n_serve=200)
    assert sorted(res) == sorted(smoke.FAMILIES)
    for name, fam in res.items():
        assert fam["runs"]["kernel"]["max_abs_err"] == 0.0, name
        assert max(fam["runs"]["kernel_q8"]["bank_rel"]) < 0.12, name
    assert res["cnn_b"]["banks"] == [(1, 6, 16, 16), (16, 1, 256, 24), (24, 1, 256, 3)]
    assert len(res["rnn"]["banks"]) == 16 and set(res["ae"]["auc"]) == {
        (kind, who) for kind in ("malware", "dos")
        for who in ("teacher", "gather", "kernel", "kernel_q8")}
