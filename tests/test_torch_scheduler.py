"""The port's copies of the serving control plane against the JAX package's,
on the CPU: ``WFQScheduler``, ``CircuitBreaker`` and ``FaultInjector`` run
one seeded scenario each in both packages, and every decision must be the
same — dispatch order, admission refusals, deadline sheds, SLO counters,
latency percentiles, breaker states and the fired-fault schedule. Time is
an injected clock (the scheduler modules' ``time`` is swapped for it, the
breaker takes ``clock=``); nothing sleeps.

Then the port's ``DeviceStreamPool`` on ``devices=[cpu, cpu]``:
least-loaded placement and a crashed worker that is respawned, driven by
events and a deterministic injected fault, each wait with its own timeout.
"""

import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from repro.launch import chaos as jchaos
from repro.launch import health as jhealth
from repro.launch import scheduler as jsched
from repro_torch.launch import chaos as tchaos
from repro_torch.launch import health as thealth
from repro_torch.launch import scheduler as tsched
from repro_torch.launch.devices import DeviceStreamPool

CPU = torch.device("cpu")
WAIT = 10.0     # seconds: the bound of every wait in this file


class FakeClock:
    """``time`` as the scheduler reads it, advanced only by the scenario."""

    def __init__(self):
        self.t = 1000.0

    def perf_counter(self) -> float:
        return self.t

    def monotonic(self) -> float:
        return self.t


def _scheduler_scenario(mod, clock: FakeClock) -> list:
    """Submits with sizes, deadlines and priorities from one seed, pull
    rounds with synthetic service times, and a second wave that admission
    control judges on the observed rate; returns every decision."""
    rng = np.random.default_rng(11)
    s = mod.WFQScheduler()
    s.add_queue("a", priority="high")
    s.add_queue("b")
    s.add_queue("c", priority="low", depth=3, policy="reject")
    s.add_queue("d", admit_ms=40.0)
    trace: list = []

    def submit(wave: int):
        for _ in range(30):
            name = ["a", "b", "c", "d"][int(rng.integers(4))]
            size = int(rng.integers(1, 300))
            deadline = None if rng.random() < 0.5 else float(rng.integers(2, 60))
            prio = ["low", "normal", "high"][int(rng.integers(3))]
            clock.t += float(rng.random()) * 2e-3
            try:
                pos = s.submit(name, (wave,), size, future=Future(),
                               deadline_ms=deadline, priority=prio)
                trace.append(("admitted", name, size, pos))
            except mod.QueueFullError:
                trace.append(("queue_full", name, size))
            except mod.DeadlineExceededError:
                trace.append(("refused", name, size))

    def rounds(n: int):
        for _ in range(n):
            clock.t += 3e-3
            groups = s.pull_round(256.0)
            trace.append(("round", [(name, [r.size for r in reqs]) for name, reqs in groups]))
            for name, reqs in groups:
                flows = sum(r.size for r in reqs)
                clock.t += flows * 2e-5
                s.record_service(name, reqs, flows * 0.02)
            trace.append(("shed", sorted((k, len(v)) for k, v in s.take_shed().items())))
            trace.append(("pending", s.pending()))

    submit(0)
    rounds(6)
    submit(1)
    s.set_weight("c", priority="high")
    rounds(12)
    trace.append(("counters", s.counters()))
    trace.append(("latency", s.latency_stats()))
    trace.append(("describe", s.describe()))
    return trace


def test_scheduler_decisions_match_reference(monkeypatch):
    traces = []
    for mod in (jsched, tsched):
        clock = FakeClock()
        monkeypatch.setattr(mod, "time", clock)
        traces.append(_scheduler_scenario(mod, clock))
    ref, port = traces
    kinds = {e[0] for e in ref}
    # the scenario reaches every decision it is meant to compare
    assert {"admitted", "queue_full", "refused", "round", "shed"} <= kinds
    assert any(e[0] == "shed" and e[1] for e in ref)
    assert port == ref


def _breaker_scenario(mod) -> list:
    clock = FakeClock()
    br = mod.CircuitBreaker("m", failure_threshold=3, reset_timeout_s=1.0,
                            half_open_probes=2, clock=clock.monotonic)
    rng = np.random.default_rng(5)
    trace = []
    for _ in range(200):
        clock.t += float(rng.random()) * 0.3
        op = int(rng.choice(3, p=[0.4, 0.45, 0.15]))
        if op == 0:
            trace.append(("allow", br.allow(), br.state))
        elif op == 1:
            trace.append(("failure", br.record_failure()))
        else:
            trace.append(("success", br.record_success()))
    trace.append(("stats", br.stats()))
    return trace


def test_breaker_states_match_reference():
    ref, port = _breaker_scenario(jhealth), _breaker_scenario(thealth)
    assert {e[-1] for e in ref if e[0] == "allow"} >= {"closed", "open", "half_open"}
    assert port == ref


def _injector_scenario(mod) -> list:
    inj = mod.FaultInjector(seed=3)
    inj.inject("plan_call", model="rnn", after=2, count=None, probability=0.5)
    inj.inject("plan_call", backend="kernel", count=2)
    inj.inject("stream_dispatch", stream=1, after=3, count=1)
    inj.inject("plan_build", model="ae", mode="slow", delay_ms=0.0, count=2)
    rng = np.random.default_rng(9)
    raised = []
    for _ in range(60):
        site = ["plan_call", "plan_build", "stream_dispatch"][int(rng.integers(3))]
        scope = ({"stream": int(rng.integers(2))} if site == "stream_dispatch" else
                 {"model": ["rnn", "ae", "mlp"][int(rng.integers(3))],
                  "backend": ["kernel", "gather"][int(rng.integers(2))]})
        try:
            inj.fire(site, **scope)
            raised.append(None)
        except mod.InjectedFaultError as e:
            raised.append((e.site, e.scope))
    return [raised, inj.schedule(), inj.stats()]


def test_fault_injector_schedule_matches_reference():
    ref, port = _injector_scenario(jchaos), _injector_scenario(tchaos)
    assert sum(r is not None for r in ref[0]) >= 4
    assert port == ref


# ---------------------------------------------------------------------------
# DeviceStreamPool on two CPU "streams"
# ---------------------------------------------------------------------------


def _gated(started: threading.Event, gate: threading.Event, value):
    def fn(device):
        started.set()
        assert gate.wait(WAIT)
        return value
    return fn


def test_pool_places_on_least_loaded_stream():
    pool = DeviceStreamPool([CPU, CPU])
    try:
        gates = [threading.Event() for _ in range(2)]
        started = [threading.Event() for _ in range(2)]
        big = pool.submit(_gated(started[0], gates[0], "big"), 1000)      # tie → stream 0
        assert started[0].wait(WAIT)
        small = pool.submit(_gated(started[1], gates[1], "small"), 10)    # 0 < 1000 → stream 1
        assert started[1].wait(WAIT)
        # stream 1 holds 10 pending flows, stream 0 1000: both go to stream 1
        names = [pool.submit(lambda d: threading.current_thread().name, 5) for _ in range(2)]
        st = pool.stats()["per_device"]
        assert [d["pending_flows"] for d in st] == [1000, 20]
        assert [d["device"] for d in st] == ["cpu", "cpu"]
        gates[1].set()
        assert [f.result(timeout=WAIT) for f in names] == ["device-stream-1"] * 2
        assert small.result(timeout=WAIT) == "small"
        gates[0].set()
        assert big.result(timeout=WAIT) == "big"
        st = pool.stats()["per_device"]
        assert [d["dispatched_chunks"] for d in st] == [1, 3]
        assert [d["dispatched_flows"] for d in st] == [1000, 20]
    finally:
        pool.close()


def _wait_for(cond, what: str):
    deadline = time.monotonic() + WAIT
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


def test_pool_crashed_worker_migrates_and_respawns():
    inj = tchaos.FaultInjector()
    inj.inject("stream_dispatch", stream=1, count=1)
    pool = DeviceStreamPool([CPU, CPU], chaos=inj, respawn_backoff_s=0.01)
    try:
        gate, started = threading.Event(), threading.Event()
        blocked = pool.submit(_gated(started, gate, "blocked"), 1000)    # stream 0
        assert started.wait(WAIT)
        # placed on stream 1, whose worker dies taking it: the chunk
        # migrates to stream 0, behind the blocked one, and still runs
        moved = pool.submit(lambda d: threading.current_thread().name, 1)
        _wait_for(lambda: pool.stats()["per_device"][1]["crashes"] == 1, "no crash seen")
        assert not moved.done()
        gate.set()
        assert blocked.result(timeout=WAIT) == "blocked"
        assert moved.result(timeout=WAIT) == "device-stream-0"
        assert pool.stats()["migrated_chunks"] == 1
        # the backoff timer respawns the worker, which takes new work
        _wait_for(lambda: pool.stats()["per_device"][1]["respawns"] == 1
                  and not pool.stats()["per_device"][1]["dead"], "no respawn")
        gate2, started2 = threading.Event(), threading.Event()
        busy = pool.submit(_gated(started2, gate2, "busy"), 1000)        # stream 0 (tie)
        assert started2.wait(WAIT)
        back = pool.submit(lambda d: threading.current_thread().name, 1)
        assert back.result(timeout=WAIT) == "device-stream-1"
        gate2.set()
        assert busy.result(timeout=WAIT) == "busy"
        st = pool.stats()
        assert st["dead_streams"] == 0 and st["per_device"][1]["crashes"] == 1
        assert inj.stats()["fired"] == 1
    finally:
        pool.close()


def test_pool_respawns_while_the_dead_worker_is_still_alive():
    """The backoff timer fires while the worker that died is still alive:
    it is failing the chunk it held, and that chunk's done-callback keeps
    it there until the stream has come back. The stream must come back
    all the same (a live dying thread is not a healthy stream)."""
    inj = tchaos.FaultInjector()
    inj.inject("stream_dispatch", stream=0, after=2, count=1)
    pool = DeviceStreamPool([CPU], chaos=inj, respawn_backoff_s=0.0)
    try:
        gate, started = threading.Event(), threading.Event()
        first = pool.submit(_gated(started, gate, "first"), 1)
        assert started.wait(WAIT)
        doomed = pool.submit(lambda d: "never", 1)       # queued behind it
        seen: dict = {}
        held = threading.Event()

        def hold(fut):
            # runs on the dying worker, inside its failure handler
            seen["thread"] = threading.current_thread()
            deadline = time.monotonic() + WAIT
            while (pool.stats()["per_device"][0]["respawns"] == 0
                   and time.monotonic() < deadline):
                time.sleep(0.005)
            seen["respawns_while_held"] = pool.stats()["per_device"][0]["respawns"]
            held.set()

        doomed.add_done_callback(hold)
        gate.set()
        assert first.result(timeout=WAIT) == "first"
        assert held.wait(2 * WAIT)
        with pytest.raises(tchaos.InjectedFaultError):
            doomed.result(timeout=WAIT)
        assert seen["thread"].name == "device-stream-0"
        assert seen["respawns_while_held"] == 1, "no respawn while the dead worker lived"
        back = pool.submit(lambda d: threading.current_thread(), 1).result(timeout=WAIT)
        assert back.name == "device-stream-0" and back is not seen["thread"]
        st = pool.stats()
        assert st["dead_streams"] == 0
        assert st["per_device"][0]["crashes"] == 1 and st["per_device"][0]["respawns"] == 1
        assert not st["per_device"][0]["dead"]
    finally:
        pool.close()


def test_pool_carries_dispatch_errors_on_futures():
    pool = DeviceStreamPool([CPU, CPU], breaker_failures=2)
    try:
        def boom(device):
            raise ValueError("bad chunk")
        fut = pool.submit(boom, 3)
        with pytest.raises(ValueError, match="bad chunk"):
            fut.result(timeout=WAIT)
        assert pool.submit(lambda d: d, 1).result(timeout=WAIT) == CPU
        assert sum(d["errors"] for d in pool.stats()["per_device"]) == 1
    finally:
        pool.close()
