"""The port's multi-model serving stack against the JAX package's, on the
CPU.

The same three models — MLP, RNN and AE at the sizes of
tests/test_engine.py (48 flows per class, 5 training steps, depths 3, 4
and 4), built by the JAX package and carried across with
``repro_torch.interop`` — sit behind ``repro.launch.serve.MultiModelServer``
and behind the port's (``device="cpu"``), with per-model priorities (mlp
high, ae low), a small DRR quantum so the schedule takes many rounds, and
one seeded request mix with per-request priorities. Tolerances are the
reference's own (tests/test_engine.py:121-141): ``gather``/``onehot``/
``kernel`` within rtol = atol = 1e-4 of the reference's output on the same
backend (the JAX ``kernel`` in interpret mode, the port's through the plain
versions); ``kernel_q8`` within a per-bank relative error of 0.12 of
``gather`` and an argmax agreement of 0.75, and within 1e-4 of the
reference's ``kernel_q8`` (the int8 codes are bit-exact). The schedule and
every serving counter must be identical.

Then the port alone: ``AsyncMultiModelServer`` futures, ``stop(drain=)``,
reject/block backpressure and ``infer_async``, a stream pool of two CPU
"streams", the breaker's fallback ladder, placed plan calls and the named
registry. Every wait has its own timeout.
"""

import torch_threads  # noqa: F401  (this worker's share of the cores)

import asyncio
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic_traffic import make_dataset
from repro.launch.request import InferRequest as JaxRequest
from repro.launch.serve import MultiModelServer as JaxMultiModelServer
from repro.nets.autoencoder import anomaly_features, pegasusify_ae, train_autoencoder
from repro.nets.mlp import pegasusify_mlp, train_mlp
from repro.nets.rnn import pegasusify_rnn, train_rnn
from repro_torch import interop
from repro_torch.engine import BACKENDS, PlanRegistry, build_plan, resolve_devices
from repro_torch.launch.chaos import FaultInjector, InjectedFaultError
from repro_torch.launch.request import InferRequest, InferResult
from repro_torch.launch.serve import (
    AsyncMultiModelServer, DeadlineExceededError, MultiModelServer, PartialDrainError,
    PegasusServer, QueueFullError, ServerStoppedError,
)

TOL = 1e-4
FLOWS, STEPS = 48, 5
CPU = torch.device("cpu")
WAIT = 30.0
PRIORITY = {"mlp": "high", "rnn": None, "ae": "low"}
SERVER_KW = dict(quantum=8, max_batch=16)
BUILD_KW = dict(bucket_sizes=(16,))


def _arrays(b) -> dict:
    return dict(features=np.asarray(b.trees.features),
                thresholds=np.asarray(b.trees.thresholds),
                centroids=np.asarray(b.trees.centroids), lut=np.asarray(b.lut),
                bias=None if b.bias is None else np.asarray(b.bias),
                group_size=b.group_size)


@pytest.fixture(scope="module")
def models():
    """The reference's three models, the port's carried copies, their
    served inputs (numpy) and one seeded request mix."""
    ds = make_dataset("peerrush", flows_per_class=FLOWS)
    tr = ds.train
    m = train_mlp(tr["stats"], tr["label"], ds.num_classes, steps=STEPS)
    mlp = pegasusify_mlp(m, tr["stats"].astype(np.float32), depth=3, refine_steps=0)
    r = train_rnn(tr["seq"], tr["label"], ds.num_classes, steps=STEPS)
    rnn = pegasusify_rnn(r, tr["seq"], depth=4)
    x = tr["seq"].reshape(len(tr["label"]), -1)
    a = train_autoencoder(x, steps=STEPS)
    ae = pegasusify_ae(a, x.astype(np.float32), depth=4)
    port = {
        "mlp": interop.banks_from_arrays([_arrays(b) for b in mlp], device="cpu"),
        "rnn": interop.rnn_from_arrays([_arrays(b) for b in rnn.x_banks],
                                       [_arrays(b) for b in rnn.h_banks],
                                       _arrays(rnn.out_bank), rnn.window, device="cpu"),
        "ae": interop.ae_banks_from_arrays([_arrays(b) for b in ae], ae.feat_mu,
                                           ae.feat_sigma, device="cpu"),
    }
    te = ds.test
    xt = te["seq"].reshape(len(te["label"]), -1).astype(np.float32)
    src = {"mlp": te["stats"].astype(np.float32), "rnn": np.array(te["seq"]),
           "ae": np.array(anomaly_features(jnp.asarray(xt)))}
    rng = np.random.default_rng(0)
    mix = []
    for _ in range(30):
        name = ["mlp", "rnn", "ae"][int(rng.integers(3))]
        n = int(rng.integers(1, 13))
        st = int(rng.integers(0, len(src[name]) - n))
        mix.append((name, np.ascontiguousarray(src[name][st : st + n]),
                    ["low", "normal", "high"][int(rng.integers(3))]))
    return dict(ref={"mlp": mlp, "rnn": rnn, "ae": ae}, port=port, src=src, mix=mix)


def _port_server(models, cls=MultiModelServer, **kw):
    kw = {"backend": "kernel", **SERVER_KW, **kw}
    srv = cls(device="cpu", **kw)
    for name, model in models["port"].items():
        srv.add_model(name, model, priority=PRIORITY[name], **BUILD_KW)
    return srv


def _requests(models):
    return [InferRequest(n, x, priority=p) for n, x, p in models["mix"]]


def _per_model(mix, outputs) -> dict:
    out: dict = {}
    for (name, _, _), o in zip(mix, outputs):
        out.setdefault(name, []).append(np.asarray(o))
    return {k: np.concatenate(v) for k, v in out.items()}


@pytest.mark.parametrize("backend", BACKENDS)
def test_multi_model_server_matches_reference(models, backend):
    ref_srv = JaxMultiModelServer(backend=backend, **SERVER_KW)
    for name, model in models["ref"].items():
        ref_srv.add_model(name, model, priority=PRIORITY[name], audit="off", **BUILD_KW)
    ref_out = ref_srv.serve([JaxRequest(n, jnp.asarray(x), priority=p)
                             for n, x, p in models["mix"]])
    srv = _port_server(models, backend=backend)
    out = srv.serve(_requests(models))
    assert [r.model for r in out] == [r.model for r in ref_out]
    assert [r.flows for r in out] == [r.flows for r in ref_out]
    got = _per_model(models["mix"], [r.output for r in out])
    want = _per_model(models["mix"], [r.output for r in ref_out])
    for name in got:
        assert np.isfinite(got[name]).all()
        np.testing.assert_allclose(got[name], want[name], rtol=TOL, atol=TOL,
                                   err_msg=f"{name}:{backend}")
    if backend == "kernel_q8":
        for name in got:
            plan = srv.registry.get(name)
            x = models["src"][name]
            for i, (bank, xb) in enumerate(zip(plan.banks, plan.bank_inputs(x))):
                yg, yq = bank.apply(xb, "gather"), bank.apply(xb, "kernel_q8")
                rel = float(torch.linalg.norm(yq - yg)) / max(float(torch.linalg.norm(yg)), 1e-6)
                assert rel < 0.12, (name, i, rel)
            if name != "ae":
                ref = plan(x, backend="gather").numpy().argmax(-1)
                agree = float((plan(x, backend="kernel_q8").numpy().argmax(-1) == ref).mean())
                assert agree >= 0.75, (name, agree)
    # the same schedule and the same counters, round by round
    assert list(srv.schedule_log) == list(ref_srv.schedule_log)
    assert len(set(srv.schedule_log)) == 3 and len(srv.schedule_log) > 6
    st, ref_st = srv.stats()["serving"], ref_srv.stats()["serving"]
    for key in ("requests_served", "batches_run", "flows_served", "batches_dispatched",
                "models"):
        assert st[key] == ref_st[key], key
    assert srv.last_drain_errors == {} and ref_srv.last_drain_errors == {}


def test_async_server_futures_and_stop_drain(models):
    """Futures from several producer threads resolve to the sync drain's
    outputs; ``stop(drain=True)`` returns with every future settled."""
    want = _per_model(models["mix"], [r.output for r in
                                      _port_server(models).serve(_requests(models))])
    srv = _port_server(models, AsyncMultiModelServer)
    reqs = _requests(models)
    futs: list = [None] * len(reqs)

    def produce(idx):
        for i in idx:
            futs[i] = srv.submit(reqs[i])

    with srv:
        assert srv.running
        threads = [threading.Thread(target=produce, args=(range(k, len(reqs), 3),))
                   for k in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        assert not any(t.is_alive() for t in threads)
    assert not srv.running and all(f.done() for f in futs)
    got = _per_model(models["mix"], [f.result(timeout=WAIT).output for f in futs])
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
    assert srv.stats()["serving"]["requests_served"] == len(reqs)


def test_async_server_stop_without_drain_fails_pending(models):
    srv = _port_server(models, AsyncMultiModelServer)
    fut = srv.submit(InferRequest("mlp", models["src"]["mlp"][:4]))
    srv.stop(drain=False)                      # never started: fails the queue
    with pytest.raises(ServerStoppedError):
        fut.result(timeout=WAIT)
    assert srv.pending() == {}


def test_async_server_reject_backpressure(models):
    srv = _port_server(models, AsyncMultiModelServer, queue_depth=2, policy="reject")
    x = models["src"]["mlp"][:3]
    futs = [srv.submit(InferRequest("mlp", x)) for _ in range(2)]
    with pytest.raises(QueueFullError):
        srv.submit(InferRequest("mlp", x))
    with srv:
        outs = [f.result(timeout=WAIT).output for f in futs]
    np.testing.assert_array_equal(outs[0], outs[1])


def test_async_server_block_backpressure(models):
    srv = _port_server(models, AsyncMultiModelServer, queue_depth=1, policy="block")
    x = models["src"]["ae"][:2]
    first = srv.submit(InferRequest("ae", x))
    with pytest.raises(QueueFullError):
        srv.submit(InferRequest("ae", x), timeout=0.05)   # still full at expiry
    landed = threading.Event()
    held: list = []

    def blocked_submit():
        held.append(srv.submit(InferRequest("ae", x), timeout=WAIT))
        landed.set()

    t = threading.Thread(target=blocked_submit)
    t.start()
    assert not landed.wait(0.1)                # parked: nothing drains yet
    with srv:
        assert landed.wait(WAIT)
        second = held[0].result(timeout=WAIT)
    t.join(timeout=WAIT)
    assert not t.is_alive()
    np.testing.assert_array_equal(first.result(timeout=WAIT).output, second.output)


def test_async_server_infer_async(models):
    srv = _port_server(models, AsyncMultiModelServer)
    req = InferRequest("rnn", models["src"]["rnn"][:5])
    with pytest.raises(RuntimeError, match="not running"):
        asyncio.run(srv.infer_async(req))
    want = srv.registry.get("rnn")(req.inputs[0]).numpy()

    async def main():
        return await asyncio.wait_for(asyncio.gather(*(srv.infer_async(req)
                                                        for _ in range(3))), WAIT)

    with srv:
        results = asyncio.run(main())
    for r in results:
        assert r.model == "rnn" and r.flows == 5
        np.testing.assert_array_equal(r.output, want)


@pytest.mark.parametrize("path", ["AsyncMultiModelServer.submit", "MultiModelServer.serve"])
def test_a_typed_request_is_answered_by_its_one_future(models, path):
    """Each typed request's future is resolved once, with its
    ``InferResult``: the request's model and flows, its plan's own
    ``gather`` output to the bit (and the reference's within its
    tolerance: the two frameworks sum in different orders), and the time
    it waited in the queue. A
    request ``discard_pending`` drops cancels the caller's future; a shed
    request fails it with ``DeadlineExceededError`` (``serve`` reports it
    in ``PartialDrainError.shed``)."""
    ref_srv = JaxMultiModelServer(backend="gather", **SERVER_KW)
    for name, model in models["ref"].items():
        ref_srv.add_model(name, model, priority=PRIORITY[name], audit="off", **BUILD_KW)
    want = ref_srv.serve([JaxRequest(n, jnp.asarray(x), priority=p)
                          for n, x, p in models["mix"]])
    reqs = _requests(models)
    # shed at its first pull: its deadline has passed by then
    doomed = InferRequest("mlp", models["src"]["mlp"][:2], deadline_ms=1e-6)
    if path == "MultiModelServer.serve":
        srv = _port_server(models, backend="gather")
        out = srv.serve(reqs)
        with pytest.raises(PartialDrainError) as err:
            srv.serve([doomed])
        (shed,) = err.value.shed["mlp"]
        assert isinstance(shed, DeadlineExceededError)
    else:
        srv = _port_server(models, AsyncMultiModelServer, backend="gather")
        dropped = srv.submit(InferRequest("ae", models["src"]["ae"][:3]))
        assert srv.discard_pending("ae") == 1
        assert dropped.cancelled()
        futs = [srv.submit(r) for r in reqs]
        shed = srv.submit(doomed)
        with srv:
            out = [f.result(timeout=WAIT) for f in futs]
            with pytest.raises(DeadlineExceededError):
                shed.result(timeout=WAIT)
    assert srv.stats()["serving"]["requests_served"] == len(reqs)
    for req, res, ref in zip(reqs, out, want):
        assert isinstance(res, InferResult)
        assert (res.model, res.flows) == (req.model, req.flows)
        alone = srv.registry.get(req.model)(*req.inputs, backend="gather").numpy()
        np.testing.assert_array_equal(res.output, alone)
        np.testing.assert_allclose(res.output, np.asarray(ref.output), rtol=TOL, atol=TOL)
        assert res.queue_wait_ms is not None and res.queue_wait_ms >= 0


def test_stream_pool_server_matches_inline(models):
    """``devices=[cpu, cpu]``: chunks cross to two pool workers as host
    arrays; the outputs equal the inline server's, and both streams work."""
    reqs = _requests(models)
    want = _per_model(models["mix"], [r.output for r in _port_server(models).serve(reqs)])
    for cls in (MultiModelServer, AsyncMultiModelServer):
        srv = _port_server(models, cls, devices=[CPU, CPU])
        try:
            if cls is AsyncMultiModelServer:
                srv.start()
            out = srv.serve(reqs)
            got = _per_model(models["mix"], [r.output for r in out])
            for name in want:
                np.testing.assert_array_equal(got[name], want[name])
            per = srv.stats()["devices"]["per_device"]
            assert [d["device"] for d in per] == ["cpu", "cpu"]
            assert sum(d["dispatched_chunks"] for d in per) == srv.batches_dispatched
        finally:
            if cls is AsyncMultiModelServer:
                srv.stop()
            srv.close()


def test_breaker_falls_back_to_gather_and_recovers(models):
    """Three injected plan-call failures open the RNN's breaker; it then
    serves degraded on gather (equal to kernel on the CPU) and, after the
    cooldown, a probe on kernel closes it. The other models never fail."""
    srv = _port_server(models, breaker_reset_s=0.0)
    rnn_x = models["src"]["rnn"][:6]
    want = srv.registry.get("rnn")(rnn_x).numpy()
    inj = FaultInjector(seed=1)
    inj.inject("plan_call", model="rnn", count=3)
    srv.install_chaos(inj)
    srv.submit(InferRequest("rnn", rnn_x))
    for k in range(3):
        srv.submit(InferRequest("mlp", models["src"]["mlp"][:2]))
        srv.drain()
        assert isinstance(srv.last_drain_errors["rnn"], InjectedFaultError)
    health = srv.stats()["health"]["models"]["rnn"]
    assert health["state"] == "open" and health["retries"] == 3
    # reset_timeout 0: the next slice is the probe, on kernel, and succeeds
    out = srv.drain()["rnn"]
    np.testing.assert_array_equal(out[0], want)
    health = srv.stats()["health"]["models"]["rnn"]
    assert health["state"] == "closed" and health["reinstated"] == 1
    assert health["probe_batches"] == 1
    srv.uninstall_chaos()
    assert srv.stats()["health"]["chaos"] == {"installed": False}


def test_breaker_degraded_batches_counted(models):
    srv = _port_server(models, breaker_failures=1, breaker_reset_s=3600.0)
    inj = FaultInjector()
    inj.inject("plan_call", model="ae", backend="kernel", count=1)
    srv.install_chaos(inj)
    x = models["src"]["ae"][:4]
    with pytest.raises(PartialDrainError) as err:
        srv.serve([InferRequest("ae", x), InferRequest("mlp", models["src"]["mlp"][:2])])
    assert "ae" in err.value.failed and "mlp" in err.value.partial_results
    degraded = srv.drain()["ae"][0]      # the requeued request, on gather
    np.testing.assert_array_equal(degraded, srv.registry.get("ae")(x, backend="gather").numpy())
    h = srv.stats()["health"]
    assert h["degraded_models"] == ["ae"] and h["models"]["ae"]["fallback_batches"] == 1


def test_breaker_real_fault_fails_without_fallback(models):
    """A failure that was not injected opens the breaker but never sends
    the model to gather: its slices fail fast until the request is
    poisoned, and no batch is served degraded."""
    srv = _port_server(models, breaker_failures=1, breaker_reset_s=3600.0,
                       max_requeues=2)
    plan = srv.registry.get("ae")

    def broken(apply, state, *inputs):
        raise RuntimeError("kernel launch failed")

    plan._forward = broken
    n_plans = len(srv.registry)
    with pytest.raises(PartialDrainError) as err:
        srv.serve([InferRequest("ae", models["src"]["ae"][:4]),
                   InferRequest("mlp", models["src"]["mlp"][:2])])
    assert str(err.value.failed["ae"]) == "kernel launch failed"
    for _ in range(2):           # breaker open: fail fast, no gather plan
        with pytest.raises(RuntimeError, match="breaker is open") as fast:
            srv.drain()
        assert str(fast.value.__cause__) == "kernel launch failed"
    assert srv.pending().get("ae", 0) == 0
    h = srv.stats()["health"]["models"]["ae"]
    assert h["state"] == "open" and h["fallback_batches"] == 0
    assert h["retries"] == 2 and h["poisoned"] == 1
    assert len(srv.registry) == n_plans          # no gather plan was built


def test_named_registry_entries(models):
    reg = PlanRegistry()
    model = list(models["port"]["mlp"])
    plan = reg.register("ids", model, backend="kernel", device="cpu")
    assert "ids" in reg and reg.names() == ["ids"] and reg.model("ids") is model
    assert reg.get("ids") is plan and reg.backend_of("ids") == "kernel"
    fallback = reg.get_with_backend("ids", "gather")
    assert fallback is not plan and fallback.backend == "gather"
    assert reg.get_with_backend("ids", "gather") is fallback      # memo hit
    st = reg.stats()["ids"]
    assert st["backend"] == "kernel" and st["recompiles"] == 0 and st["num_banks"] == 4
    model[0] = interop.banks_from_arrays(
        [_arrays(b) for b in models["ref"]["mlp"]], device="cpu")[0]
    rebuilt = reg.get("ids")                   # a bank swap recompiles
    assert rebuilt is not plan and reg.stats()["ids"]["recompiles"] == 1
    assert reg.evict("ids") and not reg.evict("ids") and "ids" not in reg
    assert reg.cache_info()["named"] == []


def test_plan_eager_and_placed_calls(models):
    """``jit=False`` and a call placed on another device name give the same
    outputs as the bucketed call; the placed call builds one replica."""
    plan = build_plan(models["port"]["rnn"], device="cpu")
    x = models["src"]["rnn"][:11]
    y = plan(x, backend="kernel")
    assert plan.trace_count == 1 and plan.compiled_buckets == {("kernel", 16)}
    torch.testing.assert_close(plan(x, backend="kernel", jit=False), y, rtol=0, atol=0)
    assert plan.trace_count == 1
    other = torch.device("cpu", 0)
    torch.testing.assert_close(plan(x, backend="kernel", device=other), y, rtol=0, atol=0)
    assert list(plan._replicas) == [other]
    assert plan._state_for(other) is plan._state_for(other)
    assert plan._state_for(plan.device) is plan._state
    assert plan.compile_stats()["devices"] == 1


def test_resolve_devices():
    assert resolve_devices(None) is None
    assert resolve_devices(["cpu", CPU]) == (CPU, CPU)
    for bad in (0, 1 + (torch.cuda.device_count() if torch.cuda.is_available() else 0)):
        with pytest.raises(ValueError):
            resolve_devices(bad)


def test_pegasus_server_jit_false_matches(models):
    server = PegasusServer(models["port"]["ae"], backend="kernel", device="cpu")
    reqs = [InferRequest("ae", models["src"]["ae"][i : i + 3]) for i in range(0, 12, 3)]
    a = server.serve(reqs)
    b = server.serve(reqs, jit=False)
    for ra, rb in zip(a, b):
        np.testing.assert_array_equal(ra.output, rb.output)


def test_chip_smoke_multi_model_rehearsal():
    """chip_smoke.py's phase 6 in process at tiny size on the CPU (plain
    versions, no graphs): graph against eager, both multi-model servers,
    the stream-pool server and the injected fault."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    res = smoke.main_path(CPU, flows_per_class=FLOWS, steps=STEPS, depth=3, n_serve=200)
    fams = smoke.families_phase(CPU, flows_per_class=FLOWS, steps=STEPS, tiny=True,
                                n_serve=200)
    out = smoke.multi_model_phase(res, fams, CPU, "the CPU")
    assert len(out["speed"]) == 2 * (2 + len(smoke.FAMILIES))
    for backend in ("kernel", "kernel_q8"):
        assert set(out[backend]["out"]) == set(smoke.MODELS)
    assert out["health"]["state"] == "closed" and out["health"]["fallback_batches"] >= 1


def _key_paths(d, prefix=()) -> set:
    """Every nested key of a stats dict as a path tuple, the plan audit's
    finding counts (``audit``: error, warning, info) included."""
    out = set()
    for k, v in d.items():
        out.add(prefix + (k,))
        if isinstance(v, dict):
            out |= _key_paths(v, prefix + (k,))
    return out


@pytest.mark.parametrize("kind", ["pegasus", "multi", "async"])
def test_stats_schema_matches_reference(models, kind):
    """All three servers report the reference's nested ``stats()`` keys
    (docs/SERVING.md: one schema, empty sections where a server has
    nothing to say) after the same traffic."""
    from repro.launch.serve import AsyncMultiModelServer as JaxAsyncMultiModelServer
    from repro.launch.serve import PegasusServer as JaxPegasusServer

    if kind == "pegasus":
        ref_srv = JaxPegasusServer(models["ref"]["mlp"], backend="kernel")
        ref_srv.serve([JaxRequest("mlp", jnp.asarray(models["src"]["mlp"][:5]))])
        srv = PegasusServer(models["port"]["mlp"], backend="kernel", device="cpu")
        srv.serve([InferRequest("mlp", models["src"]["mlp"][:5])])
        counts = srv.stats()["engine"]["audit"]
        assert set(counts) == set(ref_srv.stats()["engine"]["audit"]) == {"error", "warning", "info"}
        assert counts["error"] == 0
    else:
        cls = (JaxMultiModelServer, MultiModelServer) if kind == "multi" else \
            (JaxAsyncMultiModelServer, AsyncMultiModelServer)
        ref_srv = cls[0](backend="kernel", **SERVER_KW)
        for name, model in models["ref"].items():
            ref_srv.add_model(name, model, priority=PRIORITY[name], **BUILD_KW)
        srv = _port_server(models, cls[1])
        ref_reqs = [JaxRequest(n, jnp.asarray(x), priority=p) for n, x, p in models["mix"]]
        if kind == "multi":
            ref_srv.serve(ref_reqs)
            srv.serve(_requests(models))
        else:
            with ref_srv, srv:
                ref_srv.serve(ref_reqs)
                srv.serve(_requests(models))
        for name in models["port"]:
            counts = srv.stats()["engine"]["models"][name]["audit"]
            want = ref_srv.stats()["engine"]["models"][name]["audit"]
            assert set(counts) == set(want) == {"error", "warning", "info"}, name
            assert counts["error"] == 0, name
    st = srv.stats()
    # beyond the reference's schema the port counts the bytes it copies
    # from pageable host memory and through its pinned stage, the chunks
    # whose data crossed the plan boundary once each way, the kernels its
    # plans' graph replays launched and the rows they launched the per-bank
    # kernels on, the rounds it finished and of them
    # those it overlapped with the next, and each plan's rows per bucket,
    # keyed as pad_waste is
    plans = ({(): st["engine"]} if kind == "pegasus" else
             {("models", n): m for n, m in st["engine"]["models"].items()})
    extra = set() if kind == "pegasus" else {("serving", "h2d_pageable_bytes"),
                                             ("serving", "h2d_staged_bytes"),
                                             ("serving", "chunks_direct"),
                                             ("serving", "graph_kernels"),
                                             ("serving", "bank_rows"),
                                             ("serving", "rounds"),
                                             ("serving", "rounds_overlapped")}
    for at, plan_st in plans.items():
        assert set(plan_st["rows"]) == set(plan_st["pad_waste"])
        extra |= {("engine", *at, "rows", *k) for k in [()] + [(b,) for b in plan_st["rows"]]}
    assert _key_paths(st) == _key_paths(ref_srv.stats()) | extra
