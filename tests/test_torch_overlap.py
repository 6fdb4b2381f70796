"""Rounds two deep in ``AsyncMultiModelServer``'s drain loop: round N + 1
is pulled and begun before round N is finished, unless round N's outputs
have already landed, and each group's outputs come back into a pinned slot
behind an event. On the CPU, through a fake plan whose outputs come back
through a stage of stub events as they would from a card: the order of
begins, finishes and resolutions with and without a backlog and with
rounds that land at once, per-model order across overlapped rounds and
failures, results that outlive the slot they came back in, and ``stop``.
On the card, one case per plan family: answers bit-equal to the sync
``drain()``, and the loop waits on events alone. Imports no JAX."""

import torch_threads  # noqa: F401  (this worker's share of the cores)

import importlib.util
import pathlib
import threading
import types

import numpy as np
import pytest
import torch

from repro_torch.data.synthetic_traffic import make_dataset
from repro_torch.launch import serve
from repro_torch.launch.chaos import InjectedFaultError
from repro_torch.launch.request import InferRequest
from repro_torch.launch.serve import (
    AsyncMultiModelServer, MultiModelServer, PinnedStage, ServerStoppedError,
)
from repro_torch.nets.mlp import pegasusify_mlp, train_mlp

WAIT = 60
ROWS = 16           # flows a request; a round takes two (max_batch 32)


class StubEvent:
    """Stands in for ``torch.cuda.Event``: done until recorded, then not
    done until waited on (a copy still on the device)."""

    def __init__(self):
        self.done = True

    def record(self, stream):
        self.done = False

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True


class LandedEvent(StubEvent):
    """A copy that has landed by the time anyone asks."""

    def record(self, stream):
        pass


@pytest.fixture
def card_like(monkeypatch):
    """Outputs come back through the server's output stage, as on a card,
    though the fake plan's are on the CPU."""
    monkeypatch.setattr(serve, "_copy_back",
                        lambda outs, stage: stage.copy_back(torch.cat(outs), None))


class FakePlan:
    """Doubles its input. Every request's rows hold its index, so a chunk's
    first row names its first request; ``gate`` is called with it."""

    device = torch.device("cpu")
    buckets = (8, 16, 32)

    def __init__(self, gate=None):
        self.gate = gate

    def __call__(self, x, backend=None):
        if self.gate is not None:
            self.gate(int(x[0, 0]))
        return torch.as_tensor(x) * 2


def _ids(reqs):
    return tuple(int(r.inputs[0][0, 0]) for r in reqs)


def _server(names=("m",), gate=None, event=StubEvent, **kw):
    """An async server on the CPU whose models are fake plans and whose
    output stage records ``event``s, and the log of its begins, finishes
    and resolutions."""
    srv = AsyncMultiModelServer(device="cpu", max_batch=32, retry_backoff_s=0.001, **kw)
    srv._back = PinnedStage(pin=False, event=event)
    plans = {n: FakePlan(gate) for n in names}
    srv.registry.get = plans.__getitem__
    srv.registry.names = lambda: list(plans)
    srv.registry.backend_of = lambda name: "kernel"
    for n in names:
        srv._track(n)
    log: list = []
    begin, finish = srv._begin_group, srv._finish_group

    def logged_begin(name, reqs, backend):
        log.append(("begin", name, _ids(reqs)))
        return begin(name, reqs, backend)

    def logged_finish(g, behind=None):
        log.append(("finish", g.name, _ids(g.reqs)))
        return finish(g, behind=behind)

    srv._begin_group, srv._finish_group = logged_begin, logged_finish
    return srv, log


def _submit(srv, log, names):
    """One request of ``ROWS`` flows a name, the i-th holding i."""
    futs = []
    for i, name in enumerate(names):
        f = srv.submit(InferRequest(name, np.full((ROWS, 2), i, np.float32)))
        f.add_done_callback(lambda f, i=i, name=name: log.append(("resolved", name, i)))
        futs.append(f)
    return futs


def _check_outputs(futs):
    for i, f in enumerate(futs):
        np.testing.assert_array_equal(f.result(timeout=WAIT).output,
                                      np.full((ROWS, 2), 2 * i, np.float32))


def test_with_a_backlog_round_n_plus_1_is_begun_before_round_n_resolves(card_like):
    srv, log = _server()
    futs = _submit(srv, log, ["m"] * 12)            # queued before start: 6 rounds
    with srv:
        _check_outputs(futs)
    rounds = [(2 * k, 2 * k + 1) for k in range(6)]
    assert [e[2] for e in log if e[0] == "begin"] == rounds
    for k in range(1, 6):
        begun = log.index(("begin", "m", rounds[k]))
        assert begun < log.index(("finish", "m", rounds[k - 1]))
        assert begun < log.index(("resolved", "m", rounds[k - 1][0]))
    st = srv.stats()["serving"]
    assert (st["rounds"], st["rounds_overlapped"]) == (6, 5)


def test_without_a_backlog_each_round_is_finished_at_once(card_like):
    srv, log = _server()
    with srv:
        for i in range(3):
            (f,) = _submit(srv, log, ["m"])
            f.result(timeout=WAIT)
    assert [e[:2] for e in log] == [("begin", "m"), ("finish", "m"), ("resolved", "m")] * 3
    st = srv.stats()["serving"]
    assert (st["rounds"], st["rounds_overlapped"]) == (3, 0)


@pytest.mark.parametrize("where", ["landed on the card", "the CPU"])
def test_a_round_that_has_landed_is_finished_before_the_next_pull(where, request):
    """With a backlog, a round whose outputs are already on the host (its
    copy's event has completed, or a CPU plan made them) is finished, its
    futures resolved, before the next round is pulled: nothing is left to
    hide, and the requests its callbacks send can join the next round."""
    if where == "landed on the card":
        request.getfixturevalue("card_like")
    srv, log = _server(event=LandedEvent)
    futs = _submit(srv, log, ["m"] * 12)
    with srv:
        _check_outputs(futs)
    rounds = [(2 * k, 2 * k + 1) for k in range(6)]
    assert [e[2] for e in log if e[0] == "begin"] == rounds
    for k in range(1, 6):
        assert (log.index(("resolved", "m", rounds[k - 1][1]))
                < log.index(("begin", "m", rounds[k])))
    st = srv.stats()["serving"]
    assert (st["rounds"], st["rounds_overlapped"]) == (6, 0)


class FailOnce:
    """Raises an injected fault the first time ``hit`` is true of what it
    is given."""

    def __init__(self, hit):
        self.hit, self.fired = hit, 0

    def __call__(self, *args, **kw):
        if not self.fired and self.hit(*args, **kw):
            self.fired += 1
            raise InjectedFaultError("test", {})


ORDER_CASES = ["one model", "two models", "a begin that fails once",
               "a finish that fails once"]


@pytest.mark.parametrize("case", ORDER_CASES)
def test_one_models_futures_resolve_in_submit_order(case, monkeypatch, card_like):
    """Across overlapped rounds, and where a round fails: a failed begin is
    finished before the next pull, as without the overlap; a failed finish
    sends the round begun behind it back behind its survivors, unserved and
    uncharged."""
    names = ["a", "b"] * 6 if case == "two models" else ["m"] * 12
    srv, log = _server(names=tuple(dict.fromkeys(names)))
    if case == "a begin that fails once":
        fault = FailOnce(lambda *args, **kw: len([e for e in log if e[0] == "begin"]) == 2)
        srv._chaos = types.SimpleNamespace(fire=fault, stats=dict)
    elif case == "a finish that fails once":
        split, calls = serve._split, []
        fault = FailOnce(lambda: len(calls) == 2)                      # round (2, 3)
        monkeypatch.setattr(serve, "_split", lambda back, sizes: (calls.append(1), fault(),
                                                                  split(back, sizes))[2])
    futs = _submit(srv, log, names)
    with srv:
        _check_outputs(futs)
    for name in set(names):
        mine = [i for i, n in enumerate(names) if n == name]
        assert [e[2] for e in log if e[0] == "resolved" and e[1] == name] == mine
    if case == "two models":
        assert [e[2] for e in log if e[0] == "begin"][:2] == [(0, 2), (1, 3)]
        assert srv.stats()["serving"]["rounds_overlapped"] >= 1
    if case.startswith("a "):
        assert fault.fired == 1
        assert srv.stats()["health"]["models"]["m"]["retries"] == 2
        failed = log.index(("begin", "m", (2, 3)))
        again = log.index(("begin", "m", (2, 3)), failed + 1)
    if case == "a begin that fails once":
        assert [e[0] for e in log[failed + 1:again]] == ["finish", "resolved", "resolved",
                                                         "finish"]
    if case == "a finish that fails once":
        # round (4, 5) was begun behind the failure, then dropped: served once, later
        assert log.count(("begin", "m", (4, 5))) == 2
        assert log.index(("resolved", "m", 3)) < log.index(("resolved", "m", 4))


def test_a_breaker_probe_is_finished_before_the_next_pull(card_like):
    """An injected fault opens the breaker (one failure trips it, no
    cooldown); the retried slice is the probe and is finished, closing the
    breaker, before the next round is begun: that round runs on the
    preferred path, not degraded behind a probe still in flight."""
    srv, log = _server(breaker_failures=1, breaker_reset_s=0.0)
    srv.registry.get_with_backend = lambda name, backend: srv.registry.get(name)
    fault = FailOnce(lambda *args, **kw: True)
    srv._chaos = types.SimpleNamespace(fire=fault, stats=dict)
    futs = _submit(srv, log, ["m"] * 12)
    with srv:
        _check_outputs(futs)
    probe = log.index(("begin", "m", (0, 1)), log.index(("begin", "m", (0, 1))) + 1)
    assert log[probe + 1] == ("finish", "m", (0, 1))
    health = srv.stats()["health"]["models"]["m"]
    assert (health["probe_batches"], health["fallback_batches"]) == (1, 0)
    assert health["state"] == "closed" and fault.fired == 1


def test_a_degraded_round_is_finished_before_a_probe_is_begun(monkeypatch, card_like):
    """An injected fault opens the breaker; the retried slice serves
    degraded within the cooldown, which runs out while it is on the device,
    and then fails at its finish. It is finished before the next pull, so
    the probe is begun behind nothing that could void it: the probe is
    answered and closes the breaker, and nothing more serves degraded."""
    clock = [0.0]
    srv, log = _server(breaker_failures=1)
    srv._breakers["m"] = serve.CircuitBreaker(
        "m", failure_threshold=1, reset_timeout_s=1.0, clock=lambda: clock[0])

    def degraded(first):
        clock[0] = 10.0                                 # the cooldown runs out

    fallback = FakePlan(degraded)
    srv.registry.get_with_backend = lambda name, backend: fallback
    srv._chaos = types.SimpleNamespace(fire=FailOnce(lambda *args, **kw: True), stats=dict)
    split = serve._split
    fault = FailOnce(lambda: clock[0] == 10.0)          # the degraded slice's finish
    monkeypatch.setattr(serve, "_split", lambda back, sizes: (fault(), split(back, sizes))[1])
    futs = _submit(srv, log, ["m"] * 12)
    with srv:
        _check_outputs(futs)
    assert fault.fired == 1
    # begun three times: failed, degraded, the probe; the last two each
    # finished before anything else was begun
    begins = [i for i, e in enumerate(log) if e == ("begin", "m", (0, 1))]
    assert len(begins) == 3
    assert [log[i + 1] for i in begins[1:]] == [("finish", "m", (0, 1))] * 2
    health = srv.stats()["health"]["models"]["m"]
    assert (health["probe_batches"], health["fallback_batches"]) == (1, 1)
    assert health["state"] == "closed"


def test_a_result_is_unchanged_after_a_later_round_reuses_its_slot(card_like):
    """Two slots serve six rounds in turn, and the first round's results
    still hold its values after its slot was written twice more."""
    srv, log = _server()
    taken = []
    take = srv._back.take
    srv._back.take = lambda device: taken.append(take(device)) or taken[-1]
    futs = _submit(srv, log, ["m"] * 12)
    first = futs[0].result
    with srv:
        _check_outputs(futs)
    assert len(taken) == 6 and len(srv._back._slots) == 2
    assert [id(s) for s in taken] == [id(s) for s in taken[:2]] * 3
    assert not any(s.busy for s in srv._back._slots)
    np.testing.assert_array_equal(first(timeout=WAIT).output, np.zeros((ROWS, 2)))


@pytest.mark.parametrize("drain", [True, False])
def test_stop_leaves_no_dispatched_future_unresolved(drain, card_like):
    """``stop`` is called while round N is in flight and round N + 1's
    begin is held back until the stop flag is set: round N + 1 is the last
    round (drain) or the second (no drain). Every dispatched request is
    answered; with ``drain=False`` the rest fail as stopped."""
    held_at = 10 if drain else 2
    reached = threading.Event()
    srv = None

    def gate(first):
        if first == held_at:
            reached.set()
            assert srv._stop_flag.wait(WAIT)

    srv, log = _server(gate=gate)
    futs = _submit(srv, log, ["m"] * 12)
    srv.start()
    assert reached.wait(WAIT)
    srv.stop(drain=drain, timeout=WAIT)
    assert not srv.running
    assert all(f.done() for f in futs)
    served = 12 if drain else 4
    _check_outputs(futs[:served])
    for f in futs[served:]:
        with pytest.raises(ServerStoppedError):
            f.result(timeout=0)
    assert srv.stats()["serving"]["requests_served"] == served
    assert not srv.loop_errors


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

CUDA = torch.device("cuda")
_MODELS: dict = {}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return CUDA


def _model(family):
    """MLP-B (served as one fused stack), CNN-L or the RNN, trained a few
    steps on the card and pegasusified at tiny depth, with host inputs;
    built once."""
    if family not in _MODELS:
        ds = make_dataset("peerrush", flows_per_class=100)
        if family == "mlp":
            stats = ds.train["stats"].astype(np.float32)
            m = train_mlp(stats, ds.train["label"], 3, steps=30, device=CUDA)
            model, inputs = pegasusify_mlp(m, stats, depth=4, refine_steps=0), (ds.test["stats"],)
        else:
            root = pathlib.Path(__file__).resolve().parents[1]
            spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
            smoke = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(smoke)
            model, _, inputs, _ = smoke._pegasusified(family, ds, CUDA, steps=30, tiny=True)
        _MODELS[family] = (model, tuple(np.ascontiguousarray(a) for a in inputs))
    return _MODELS[family]


def _requests(inputs, sizes):
    n, out, at = len(inputs[0]), [], 0
    for b in sizes:
        idx = (np.arange(b) + at) % n
        out.append(tuple(np.ascontiguousarray(a[idx]) for a in inputs))
        at += b
    return out


SIZES = (1, 37, 4096, 1, 700, 2500, 64, 3000, 5, 1200, 4096, 900) * 2


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["mlp", "cnn_l", "rnn"])
def test_overlapped_rounds_answer_as_the_sync_drain_and_wait_on_events_alone(card, family):
    """A backlog served by the loop answers bit-equal to the sync
    ``drain()``. While it serves, CUDA's sync debug mode raises on any
    synchronisation of a stream or of the device, and the host waits once
    a round, on the event after that round's copy back."""
    model, inputs = _model(family)
    reqs = [InferRequest(family, r) for r in _requests(inputs, SIZES)]
    sync = MultiModelServer(backend="kernel", device=CUDA)
    sync.add_model(family, model)
    want = [o.output for o in sync.serve(reqs)]
    waits = [0]

    class CountingEvent(torch.cuda.Event):
        def synchronize(self):
            waits[0] += 1
            super().synchronize()

    srv = AsyncMultiModelServer(backend="kernel", device=CUDA)
    srv.add_model(family, model)
    srv._back = PinnedStage(event=CountingEvent)
    with srv:
        for r in reqs:                                  # every bucket captured, slots sized
            srv.submit(r).result(timeout=300)
    s0 = srv.stats()["serving"]
    waits[0] = 0
    futs = [srv.submit(r) for r in reqs]                # queued before start: a backlog
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with srv:
            got = [f.result(timeout=300).output for f in futs]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    s1 = srv.stats()["serving"]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    rounds = s1["rounds"] - s0["rounds"]
    assert rounds >= 4 and waits[0] == rounds
    assert not srv.loop_errors
    srv.close()
