"""The port's example scripts (``examples/torch/*.py``) against the JAX
reference's library calls in the reference scripts' order, on the CPU.

Throwaway sizes: 48 flows per class, 5 teacher steps, small tree depths.
The reference's teachers (and, where a stage uses the banks rather than
fits them, its pegasusified banks) are carried across with
``repro_torch.interop``; each script stage then runs in the port and its
result is held to the reference:

- quickstart: the Pegasus predictions equal on the same banks, the integer
  pipeline's agreement, ``table6_row("MLP-B")`` and ``validate()``
  identical, the served outputs within rtol = atol = 1e-4 (the reference's
  own serving limit, tests/test_engine.py:121) with the same flows and
  shapes per request;
- anomaly_detection: banks pegasusified in both packages from one JAX AE;
  per attack kind the AUC within 1e-6 and the caught share identical;
- serve_batched (``kernel``, the plain versions here): with ``--sync`` the
  whole schedule log and the per-model counters identical to the
  reference ``MultiModelServer`` fed the same banks and bursts; the async
  flavour's outputs equal to the sync one's; a 0.001 ms deadline sheds
  without raising; two CPU "streams" serve;
- train_distributed: 10 steps, then a resumed run of 2 into the same
  directory ends at 12 with the losses of an uninterrupted 12-step run;
  the first step's loss within 1e-5 relative of the reference's unsharded
  train step on the loop's own initial weights (tests/test_torch_train.py's
  limit: the reference's own script fails on a (1, 1) mesh); with
  torchrun's environment (one gloo rank) it trains on a (1, 1) mesh.

Every script runs end to end with ``--device cpu`` and raises without a
card when no ``--device`` is given; none imports jax or repro.
"""

import torch_threads  # noqa: F401  (this worker's share of the cores)

import importlib.util
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data.synthetic_traffic import anomaly_testset as j_anomaly_testset
from repro.data.synthetic_traffic import make_dataset as j_make_dataset
from repro.dataplane.compile import compile_model as j_compile_model
from repro.launch import train as jtrain
from repro.launch.request import InferRequest as JaxRequest
from repro.launch.serve import MultiModelServer as JaxMultiModelServer
from repro.nets import autoencoder as jae
from repro.nets import mlp as jmlp
from repro.nets import rnn as jrnn
from repro.nets.common import macro_f1 as j_macro_f1
from repro.train.optimizer import adamw_init as jadamw_init
from repro_torch import interop
from repro_torch.configs import registry as treg
from repro_torch.data.synthetic_traffic import make_dataset
from repro_torch.launch import train as ttrain

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCRIPTS = ("quickstart", "anomaly_detection", "serve_batched", "train_distributed")
CPU = torch.device("cpu")
FLOWS, STEPS, TOL, AUC_TOL, LOSS_RTOL = 48, 5, 1e-4, 1e-6, 1e-5
# the reference scripts' requests cut to the 22-flow test split
QUICK_REQUESTS = (12, 5)
TRAIN_ARGS = ["--device", "cpu", "--batch", "2", "--seq", "16"]


def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", ROOT / "examples" / "torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _arrays(b) -> dict:
    return dict(features=np.asarray(b.trees.features),
                thresholds=np.asarray(b.trees.thresholds),
                centroids=np.asarray(b.trees.centroids), lut=np.asarray(b.lut),
                bias=None if b.bias is None else np.asarray(b.bias),
                group_size=b.group_size)


def _np(params: dict) -> dict:
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def peerrush():
    return make_dataset("peerrush", flows_per_class=FLOWS)


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------


def test_quickstart_matches_reference(peerrush):
    qs = _script("quickstart")
    ds = j_make_dataset("peerrush", flows_per_class=FLOWS)
    stats, y = ds.train["stats"], ds.train["label"]
    teacher = jmlp.train_mlp(stats, y, ds.num_classes, steps=STEPS)
    jbanks = jmlp.pegasusify_mlp(teacher, stats.astype(np.float32), depth=3, refine_steps=0)
    banks = interop.banks_from_arrays([_arrays(b) for b in jbanks], device="cpu")
    x_test = jnp.asarray(ds.test["stats"], jnp.float32)

    # stage 2: the Pegasus predictions on the same banks
    want_pred = np.asarray(jmlp.pegasus_mlp_apply(jbanks, x_test)).argmax(-1)
    pred, f1 = qs.pegasus_predictions(banks, peerrush, CPU, 0.0)
    np.testing.assert_array_equal(pred, want_pred)
    assert f1 == j_macro_f1(want_pred, ds.test["label"], ds.num_classes)

    # stage 3: the integer pipeline and its agreement with the float tables
    jpipe = j_compile_model(jbanks, stateful_bits_per_flow=80)
    jout = np.asarray(jpipe.run_batch(ds.test["stats"][:32].astype(np.float32)))
    want_agree = float((jout.argmax(-1) == want_pred[:32]).mean())
    pipe, agree = qs.switch_pipeline(banks, peerrush, pred, CPU)
    assert agree == want_agree

    # stage 4: the Table 6 row and the constraint check, string for string
    row, violations = qs.resource_report(pipe)
    jrep = jpipe.report()
    assert row == jrep.table6_row("MLP-B")
    assert violations == jrep.validate()

    # stage 5: the two typed requests through MultiModelServer
    served = qs.serve(banks, peerrush, CPU, request_sizes=QUICK_REQUESTS)
    hi, lo = QUICK_REQUESTS
    ref = JaxMultiModelServer({"mlp": jbanks})
    want = ref.serve([JaxRequest("mlp", x_test[:hi], deadline_ms=5000.0, priority="high"),
                      JaxRequest("mlp", x_test[hi:hi + lo], priority="low")])
    assert served["flows"] == [r.flows for r in want] == [hi, lo]
    assert served["streams"] == ref.stats()["devices"]["count"] == 1
    for got, w in zip(served["outputs"], want):
        assert got.shape == tuple(w.output.shape)
        np.testing.assert_allclose(got, np.asarray(w.output), rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# anomaly_detection
# ---------------------------------------------------------------------------


def test_anomaly_detection_matches_reference():
    ad = _script("anomaly_detection")
    ds, x_train = ad.benign_flows(flows_per_class=FLOWS)
    jds = j_make_dataset("iscxvpn", flows_per_class=FLOWS)
    np.testing.assert_array_equal(x_train, jds.train["seq"].reshape(len(jds.train["label"]), -1))
    teacher = jae.train_autoencoder(x_train, steps=STEPS)
    jbanks = jae.pegasusify_ae(teacher, x_train.astype(np.float32), depth=4)
    banks = ad.lower(interop.ae_from_arrays(_np(teacher.params), teacher.feat_mu,
                                            teacher.feat_sigma, "cpu"), x_train, depth=4)
    got = ad.detect(banks, ds, CPU)
    for kind in ("malware", "dos"):
        test = j_anomaly_testset(jds, kind=kind)
        x = jnp.asarray(test["seq"].reshape(len(test["label"]), -1), jnp.float32)
        scores = np.asarray(jae.pegasus_ae_error(jbanks, x))
        thr = np.quantile(scores[test["label"] == 0], 0.95)
        caught = float((scores[test["label"] == 1] > thr).mean())
        assert abs(got[kind]["auc"] - jae.auc_score(scores, test["label"])) <= AUC_TOL, kind
        assert got[kind]["caught"] == caught, kind


# ---------------------------------------------------------------------------
# serve_batched
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served_models(peerrush):
    """The reference's three pegasusified models and the port's carried
    copies, under the script's serving names."""
    ds = j_make_dataset("peerrush", flows_per_class=FLOWS)
    tr = ds.train
    flat = tr["seq"].reshape(len(tr["label"]), -1)
    m = jmlp.train_mlp(tr["stats"], tr["label"], ds.num_classes, steps=STEPS)
    r = jrnn.train_rnn(tr["seq"], tr["label"], ds.num_classes, steps=STEPS)
    a = jae.train_autoencoder(flat, steps=STEPS)
    ref = {"mlp-stats": jmlp.pegasusify_mlp(m, tr["stats"].astype(np.float32), depth=3,
                                            refine_steps=0),
           "rnn-seq": jrnn.pegasusify_rnn(r, tr["seq"], depth=4),
           "ae-anomaly": jae.pegasusify_ae(a, flat.astype(np.float32), depth=4)}
    rnn = ref["rnn-seq"]
    port = {
        "mlp-stats": interop.banks_from_arrays([_arrays(b) for b in ref["mlp-stats"]],
                                               device="cpu"),
        "rnn-seq": interop.rnn_from_arrays([_arrays(b) for b in rnn.x_banks],
                                           [_arrays(b) for b in rnn.h_banks],
                                           _arrays(rnn.out_bank), rnn.window, device="cpu"),
        "ae-anomaly": interop.ae_banks_from_arrays(
            [_arrays(b) for b in ref["ae-anomaly"]], ref["ae-anomaly"].feat_mu,
            ref["ae-anomaly"].feat_sigma, device="cpu"),
    }
    return dict(ref=ref, port=port, ds=ds)


def _reference_sync(sb, models: dict, ds, backend: str, rounds: int) -> dict:
    """The reference script's sync flavour with the reference's server:
    the same registrations, bursts and rounds."""
    server = JaxMultiModelServer(backend=backend)
    for name, model in models.items():
        server.add_model(name, model, priority=sb.MODEL_PRIORITY[name])
    inputs = (("mlp-stats", jnp.asarray(ds.test["stats"], jnp.float32)),
              ("rnn-seq", jnp.asarray(ds.test["seq"])),
              ("ae-anomaly", jnp.asarray(jae.anomaly_features(
                  ds.test["seq"].reshape(len(ds.test["label"]), -1)))))
    for _ in range(1 + rounds):
        for s in sb.BURST_SIZES:
            for name, x in inputs:
                server.submit(JaxRequest(name, x[:s], priority=sb.REQUEST_PRIORITY[name]))
        out = server.drain()
    st = server.stats()["serving"]["models"]
    return dict(schedule_log=list(server.schedule_log), outputs=out,
                models={n: {k: s[k] for k in ("requests_served", "batches_run",
                                              "flows_served")} for n, s in st.items()})


def test_serve_batched_sync_matches_reference_and_async_equals_sync(served_models, peerrush):
    sb = _script("serve_batched")
    assert sb.BURST_SIZES == (48, 17, 80)      # the reference script's burst
    rounds = 2
    sync = sb.serve(served_models["port"], peerrush, CPU, backend="kernel", sync=True,
                    rounds=rounds)
    want = _reference_sync(sb, served_models["ref"], served_models["ds"], "kernel", rounds)
    assert sync["schedule_log"] == want["schedule_log"]
    assert len(sync["schedule_log"]) == 3 * (1 + rounds)     # one batch per model per burst
    assert sync["models"] == want["models"]
    assert sync["shed"] == 0 and sync["drain_errors"] == {}
    assert set(sync["fallback_batches"].values()) == {0}
    for name, outs in want["outputs"].items():
        assert [o.shape for o in sync["outputs"][name]] == [tuple(o.shape) for o in outs]
        for got, w in zip(sync["outputs"][name], outs):
            np.testing.assert_allclose(got, np.asarray(w), rtol=TOL, atol=TOL)

    flavours = {"async": dict(sync=False),
                "two CPU streams": dict(sync=True, devices=["cpu", "cpu"])}
    for what, kw in flavours.items():
        got = sb.serve(served_models["port"], peerrush, CPU, backend="kernel", rounds=1, **kw)
        assert got["drain_errors"] == {} and got["shed"] == 0, what
        for name, c in sync["models"].items():     # warm-up + 1 round of 3 requests each
            assert got["models"][name]["requests_served"] == 6, (what, name)
            assert got["models"][name]["flows_served"] == 2 * c["flows_served"] // (1 + rounds)
        for name, outs in sync["outputs"].items():
            assert len(got["outputs"][name]) == len(outs), (what, name)
            for a, b in zip(got["outputs"][name], outs):
                np.testing.assert_array_equal(a, b, err_msg=f"{what} {name}")
        if what == "two CPU streams":
            assert got["streams"] == 2


def test_serve_batched_main_sheds_at_a_tiny_deadline(capsys):
    sb = _script("serve_batched")
    got = sb.main(["--device", "cpu", "--steps", str(STEPS), "--deadline-ms", "0.001",
                   "--rounds", "1", "--backend", "kernel"], flows_per_class=FLOWS)
    assert got["shed"] > 0 and got["mode"] == "async loop"
    assert got["drain_errors"] == {}
    out = capsys.readouterr().out
    assert "request(s) shed across all rounds" in out and "slo: admitted=" in out


# ---------------------------------------------------------------------------
# train_distributed
# ---------------------------------------------------------------------------


def test_train_distributed_resumes_and_matches_reference(tmp_path, monkeypatch):
    td = _script("train_distributed")
    losses: list[float] = []
    make_step = ttrain.make_train_step

    def recording(*args, **kw):
        step = make_step(*args, **kw)

        def run(params, opt, batch):
            params, opt, metrics = step(params, opt, batch)
            losses.append(float(metrics["loss"]))
            return params, opt, metrics

        return run

    monkeypatch.setattr(ttrain, "make_train_step", recording)
    straight = td.main(TRAIN_ARGS + ["--steps", "12", "--ckpt", str(tmp_path / "a")])
    want, losses[:] = list(losses), []
    assert straight["step"] == 12 and straight["checkpoints"] == [10, 12]
    assert straight["mesh"] == "none (one process)" and straight["resumed_from"] is None

    first = td.main(TRAIN_ARGS + ["--steps", "10", "--ckpt", str(tmp_path / "b")])
    resumed = td.main(TRAIN_ARGS + ["--steps", "2", "--ckpt", str(tmp_path / "b")])
    assert first["step"] == 10 and resumed["resumed_from"] == 10 and resumed["step"] == 12
    assert resumed["checkpoints"] == [10, 12]
    assert losses == want and resumed["loss"] == want[-1]

    # the first step against the reference's unsharded step (2 microbatches)
    # on the loop's own initial weights
    arch = "granite_20b"
    cfg, jcfg = treg.smoke_config(arch), jreg.smoke_config(arch)
    params = interop.lm_arrays_from_params(cfg, ttrain.TrainLoop(cfg, device="cpu").params)
    jp = jax.tree.map(jnp.asarray, params)
    jstep = jax.jit(jtrain.make_train_step(jcfg, microbatches=2))
    _, _, jm = jstep(jp, jadamw_init(jp), next(jtrain.synthetic_batches(jcfg, 2, 16)))
    assert abs(want[0] - float(jm["loss"])) <= LOSS_RTOL * abs(float(jm["loss"]))


def test_train_distributed_builds_a_mesh_under_torchrun(tmp_path, monkeypatch):
    """With torchrun's environment (one rank, gloo on a localhost port) the
    script trains on a (1, 1) mesh, one row per microbatch, and destroys
    its process group."""
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    got = _script("train_distributed").main(TRAIN_ARGS + ["--steps", "2", "--ckpt",
                                                          str(tmp_path)])
    assert got["mesh"] == "{'data': 1, 'model': 1}" and got["step"] == 2
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# every script
# ---------------------------------------------------------------------------


def test_chip_smoke_examples_phase_rehearses():
    """chip_smoke.py's phase 12 on the CPU at throwaway sizes: quickstart,
    anomaly_detection and train_distributed end to end through their
    ``main``, serve_batched's stages on gather, kernel and kernel_q8, sync
    and async, and with a deadline (``kernel`` equal to ``gather``, no
    fallback), the resumed training run ending at twice its steps."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    res = cs.examples_phase(CPU, "the CPU (test)", rehearse=True)
    qs = res["quickstart"]
    assert 0.0 <= qs["f1_pegasus"] <= 1.0 and 0.0 <= qs["agreement"] <= 1.0
    assert qs["table6_row"].startswith("MLP-B") and qs["served"]["flows"] == list(QUICK_REQUESTS)
    assert set(res["anomaly"]) == {"malware", "dos"}
    runs = res["serving"]["runs"]
    assert len(runs) == 7 and ("kernel", False, cs.EXAMPLE_DEADLINE_MS) in runs
    for (backend, sync, _), r in runs.items():
        assert set(r["outputs"]) == {"mlp-stats", "rnn-seq", "ae-anomaly"}, backend
        assert r["mode"] == ("sync drain" if sync else "async loop")
    first, again = res["train"]
    assert (first["step"], again["resumed_from"], again["step"]) == (12, 12, 24)
    assert set(res["wall_s"]) == set(SCRIPTS)
    assert not any(res["launches"].values())      # the plain versions run on the CPU


def test_scripts_need_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    for name in SCRIPTS:
        argv = ["--ckpt", str(tmp_path)] if name == "train_distributed" else []
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _script(name).main(argv)


def test_scripts_import_no_jax():
    code = (
        "import importlib.util, sys\n"
        f"for name in {SCRIPTS!r}:\n"
        "    spec = importlib.util.spec_from_file_location(name, f'examples/torch/{name}.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n.startswith('jaxlib') or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT,
                         env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
